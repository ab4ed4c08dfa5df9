"""Streaming (online) swap inference: a frame-at-a-time VQVAE forward with
explicit temporal state.

Counterpart of `faceoff_tpu/serve/streaming.py`. Each centred k-tap
'same' Conv3D layer of the temporal postnets becomes a sliding window
over a per-layer ring buffer of its last k-1 input slices: when input
slice t arrives, the layer emits its output for time t - k//2, so an
n-layer postnet delays the stream by n*(k//2) frames and computes every
slice once. Outputs equal the offline clip forward's:

  * zero-initialised buffers reproduce the 'same' zero padding at the
    stream head, and flushing with zero encoder slices at the tail;
  * 'same' pads every layer's input independently, so slices whose time
    index falls outside [0, T) are zeroed at each layer boundary.

Everything after the postnets is per-frame 2D work. `make_stream_steps`
returns the primitives as pure functions of an explicit state dict
(`bufs_b`, `bufs_t`, `s`), as the JAX package's do. The stream position
`s` and the end `total` are device tensors and the masking is a
`torch.where`, so a push reads nothing back to the host. The port runs
eagerly (no jit): `push_many_step` is a loop over `push_step` with the
same outputs. `StreamingSwapper` wraps the functions and tracks on the
host which outputs are valid.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from faceoff_tpu_torch.device import DeviceLike, check_on_device, resolve_device
from faceoff_tpu_torch.models.vqvae import VQVAE, TemporalPostnet, _nchw, _nhwc
from faceoff_tpu_torch.ops.swap import prepare_swap_batch

_FAR_FUTURE = 2**31 - 1  # int32 'total' while the stream is open

State = Dict[str, Any]


def _postnet_stream(
    postnet: TemporalPostnet,
    bufs: Sequence[torch.Tensor],
    x: torch.Tensor,
    s: torch.Tensor,
    total: torch.Tensor,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """One streaming step through a TemporalPostnet conv stack.

    bufs[i]: (B, C, kernel-1, H, W) — layer i's most recent input slices.
    x: (B, C, H, W) — the new layer-0 input slice, for time index `s`.
    s, total: 0-dim int32 tensors on x's device.
    Returns (new_bufs, emitted slice for time s - n_layers*(kernel//2)).
    """
    d = postnet.kernel // 2
    n_layers = len(postnet.conv3d)
    # layer i emits time s - (i+1)*d; all layers' validity in one vector,
    # a few launches a step whatever the depth
    t_out = s - d * torch.arange(1, n_layers + 1, dtype=s.dtype,
                                 device=s.device)
    valid = (t_out >= 0) & (t_out < total)
    # one zero for the stack: a Python 0.0 would be filled on the device
    # at every layer
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    new_bufs = []
    h = x
    for i, layer in enumerate(postnet.conv3d):
        conv = layer[0]
        window = torch.cat([bufs[i], h[:, :, None]], dim=2)
        new_bufs.append(window[:, :, 1:])
        out = F.conv3d(window, conv.weight, conv.bias, padding=(0, d, d))
        out = out[:, :, 0]  # the window centre: time s - (i+1)*d
        if i < n_layers - 1:
            out = F.relu(out)
        h = torch.where(valid[i], out, zero)
    return tuple(new_bufs), h


def make_stream_steps(model: VQVAE, prepare_fn: Optional[Callable] = None,
                      device: DeviceLike = None):
    """Build the streaming primitives for a VQVAE on `device` (CUDA unless
    named), where `model` must already live.

    Returns (init_state, push_step, flush_step, delay, push_many_step):
      init_state(batch, height, width) -> state: zero ring buffers
          `bufs_b` (n_layers x (B, C, k-1, H/4, W/4)) and `bufs_t` (at
          H/8 x W/8) in the model's dtype, and `s`, a 0-dim int32 0;
      push_step(state, frame) -> (state, out), frame (B, H, W, in_ch);
      flush_step(state, total) -> (state, out), zero encoder slices,
          `total` (the stream's length) a 0-dim int32 tensor;
      push_many_step(state, frames) -> (state, outs (K, B, H, W, out_ch)):
          push_step over the leading K axis of every leaf of `frames`.
    `out` is the decoded (B, H, W, out_ch) float32 slice for input time
    `state["s"] - delay` (garbage while that index is out of range:
    StreamingSwapper tracks validity on the host). The functions are pure:
    they write into no tensor of the state they are given.

    prepare_fn: an optional `raw -> (B, H, W, in_ch) frame` input pipeline
    that push_step runs first (the cross-identity swap geometry).
    """
    if model.temporal_kernel % 2 != 1:
        raise ValueError("streaming requires an odd temporal kernel")
    dev = resolve_device(device)
    check_on_device(model, dev)
    n_layers = model.temporal_postnet_layers
    kernel = model.temporal_kernel
    delay = n_layers * (kernel // 2)

    def init_state(batch: int, height: int, width: int) -> State:
        if height % 8 or width % 8:
            raise ValueError("height/width must be multiples of 8")

        def bufs(h, w):
            return tuple(
                torch.zeros((batch, model.channel, kernel - 1, h, w),
                            dtype=model.dtype, device=dev)
                for _ in range(n_layers))

        return {"bufs_b": bufs(height // 4, width // 4),
                "bufs_t": bufs(height // 8, width // 8),
                "s": torch.zeros((), dtype=torch.int32, device=dev)}

    def _blend_decode(state: State, enc_b, enc_t, total):
        s = state["s"]
        bufs_b, pb = _postnet_stream(model.conv3d_encoded_b, state["bufs_b"],
                                     enc_b, s, total)
        bufs_t, pt = _postnet_stream(model.conv3d_encoded_t, state["bufs_t"],
                                     enc_t, s, total)
        quant_t, quant_b = model._encode_quantized(pb, pt)[:2]
        out = _nhwc(model._decode(quant_t, quant_b)).to(torch.float32)
        return {"bufs_b": bufs_b, "bufs_t": bufs_t, "s": s + 1}, out

    @torch.no_grad()
    def push_step(state: State, frame) -> Tuple[State, torch.Tensor]:
        if prepare_fn is not None:
            frame = prepare_fn(frame)
        enc_b, enc_t = model._encode_frames(_nchw(frame))
        far = torch.full_like(state["s"], _FAR_FUTURE)
        return _blend_decode(state, enc_b, enc_t, far)

    def push_many_step(state: State, frames) -> Tuple[State, torch.Tensor]:
        if isinstance(frames, dict):
            k = len(next(iter(frames.values())))
            items = [{key: v[j] for key, v in frames.items()}
                     for j in range(k)]
        else:
            items = list(frames)
        outs = []
        for item in items:
            state, out = push_step(state, item)
            outs.append(out)
        return state, torch.stack(outs)

    @torch.no_grad()
    def flush_step(state: State, total: torch.Tensor
                   ) -> Tuple[State, torch.Tensor]:
        enc_b = torch.zeros_like(state["bufs_b"][0][:, :, 0])
        enc_t = torch.zeros_like(state["bufs_t"][0][:, :, 0])
        return _blend_decode(state, enc_b, enc_t, total)

    return init_state, push_step, flush_step, delay, push_many_step


class StreamingSwapper:
    """Frame-at-a-time inference with constant memory and
    `delay = n_postnet_layers * (temporal_kernel // 2)` frames of latency.

    >>> sw = StreamingSwapper(model, height=256, width=256)
    >>> for frame in live_frames:           # (B, H, W, 6) in [-1, 1]
    ...     out = sw.push(frame)            # (B, H, W, out_ch) or None
    >>> tail = sw.flush()                   # the last `delay` frames

    A thin wrapper over `make_stream_steps`: it holds the state dict and,
    on the host, how many frames were pushed. Runs on `device` (CUDA
    unless named; raises without CUDA and without a named device), where
    `model` must already live.
    """

    def __init__(
        self,
        model: VQVAE,
        *,
        height: int,
        width: int,
        batch: int = 1,
        prepare_fn: Optional[Callable[[Any], torch.Tensor]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        (self._init_state, self._push, self._flush, self.delay,
         self._push_many) = make_stream_steps(model, prepare_fn, self.device)
        self.prepare_fn = prepare_fn
        self._shape = (batch, height, width)
        self.reset()

    def reset(self) -> None:
        self._state = self._init_state(*self._shape)
        self._n_pushed = 0
        self._flushed = False

    def _check_open(self) -> None:
        if self._flushed:
            raise RuntimeError(
                "stream already flushed — call reset() before starting a "
                "new stream (the ring buffers hold the previous stream's "
                "zero-padded tail and would corrupt the next clip's "
                "first frames)"
            )

    def _as_input(self, frames):
        if self.prepare_fn is not None:
            return frames
        return torch.as_tensor(frames, device=self.device)

    def push(self, frame) -> Optional[torch.Tensor]:
        """Feed one input frame (B, H, W, in_ch), or what `prepare_fn`
        takes; returns the decoded float32 frame for input time
        `n_pushed - delay` once the pipeline is warm, else None."""
        self._check_open()
        self._state, out = self._push(self._state, self._as_input(frame))
        self._n_pushed += 1
        return out if self._n_pushed - 1 - self.delay >= 0 else None

    def push_many(self, frames) -> List[torch.Tensor]:
        """Feed K frames: `frames` is what push() takes with a leading K
        axis ((K, B, H, W, in_ch), or a dict of K-stacked leaves with a
        prepare_fn). Returns the frames that became valid, in order —
        the same as K push() calls."""
        self._check_open()
        frames = self._as_input(frames)
        prev = self._n_pushed
        self._state, outs = self._push_many(self._state, frames)
        self._n_pushed += len(outs)
        # output slice j carries input time prev + j - delay
        return list(outs[max(0, self.delay - prev):])

    def flush(self) -> List[torch.Tensor]:
        """End the stream: emit the final frames held in the pipeline.
        The stream is finished afterwards — reset() starts the next one."""
        if self._flushed:
            raise RuntimeError("stream already flushed — call reset()")
        self._flushed = True
        n = self._n_pushed
        total = torch.full((), n, dtype=torch.int32, device=self.device)
        outs = []
        for j in range(self.delay):
            self._state, out = self._flush(self._state, total)
            if 0 <= n + j - self.delay < n:
                outs.append(out)
        return outs


def _stack(items, dtype=None) -> torch.Tensor:
    """Stack frames or landmarks given as numpy arrays or tensors."""
    return torch.stack([torch.as_tensor(x, dtype=dtype) for x in items])


class SwapSession:
    """Online face-swap serving: feed raw (frame, landmarks) pairs for the
    source and the target, get swapped frames out.

    Per pushed frame, the cross-identity geometry (hull masks, Umeyama
    similarity on the five stable landmarks, one warp through the CUDA
    kernel on the card, the composite: `ops/swap.prepare_swap_batch`)
    feeds the streaming VQVAE forward, with `delay` frames of latency and
    constant memory.

    >>> sess = SwapSession(model, height=256, width=256)
    >>> out = sess.push(src_frame, src_lms, tgt_frame, tgt_lms)  # or None
    >>> tail = sess.flush()

    Frames are (H, W, 3) uint8/float RGB in [0, 255]; landmarks (68, 2)
    pixel coords. Outputs are (H, W, 3) float32 tensors in [-1, 1] on the
    session's device.
    """

    def __init__(self, model: VQVAE, *, height: int, width: int,
                 device: DeviceLike = None):
        if model.in_channels != 6:
            raise ValueError("SwapSession needs the 6-channel model")

        def prepare(raw):
            # frames (2, H, W, 3) src || tgt, lms (2, 68, 2): one host to
            # device copy each carries both streams
            f, lms = raw["frames"], raw["lms"]
            return prepare_swap_batch(f[0:1], lms[0:1], f[1:2], lms[1:2])["input"]

        self._swapper = StreamingSwapper(
            model, height=height, width=width, batch=1, prepare_fn=prepare,
            device=device,
        )

    @property
    def delay(self) -> int:
        return self._swapper.delay

    @property
    def device(self) -> torch.device:
        return self._swapper.device

    def reset(self) -> None:
        self._swapper.reset()

    def _raw(self, src_frames, src_landmarks, tgt_frames, tgt_landmarks):
        """(K, 2, ...) stacks of the src || tgt pairs, on the device."""
        frames = [_stack([s, t]) for s, t in zip(src_frames, tgt_frames)]
        lms = [_stack([s, t], torch.float32)
               for s, t in zip(src_landmarks, tgt_landmarks)]
        return {"frames": _stack(frames).to(self.device),
                "lms": _stack(lms).to(self.device)}

    def push(
        self, src_frame, src_landmarks, tgt_frame, tgt_landmarks
    ) -> Optional[torch.Tensor]:
        raw = self._raw([src_frame], [src_landmarks], [tgt_frame],
                        [tgt_landmarks])
        out = self._swapper.push({k: v[0] for k, v in raw.items()})
        return None if out is None else out[0, ..., :3]

    def push_many(
        self, src_frames, src_landmarks, tgt_frames, tgt_landmarks
    ) -> List[torch.Tensor]:
        """Feed K (src, tgt) frame pairs, length-K sequences of what
        push() takes, in one host to device copy. Returns the swapped
        frames that became valid during the call, in order."""
        raw = self._raw(src_frames, src_landmarks, tgt_frames, tgt_landmarks)
        return [o[0, ..., :3] for o in self._swapper.push_many(raw)]

    def flush(self) -> List[torch.Tensor]:
        return [o[0, ..., :3] for o in self._swapper.flush()]


def stream_video(model: VQVAE, video: torch.Tensor,
                 device: DeviceLike = None) -> torch.Tensor:
    """Run a whole (B, T, H, W, C) clip through the streaming path and
    return the (B, T, H, W, out_ch) reconstruction — the streaming
    equivalent of `model(video)[0]`."""
    b, t, h, w = video.shape[:4]
    sw = StreamingSwapper(model, height=h, width=w, batch=b, device=device)
    outs = []
    for i in range(t):
        out = sw.push(video[:, i])
        if out is not None:
            outs.append(out)
    outs.extend(sw.flush())
    return torch.stack(outs, dim=1)
