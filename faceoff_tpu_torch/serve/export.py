"""Ahead-of-time model export for deployment (`torch.export`).

Counterpart of `faceoff_tpu/serve/export.py`. A trained model ships as a
bundle directory of exported programs with the weights held inside them,
plus a `meta.json` sidecar; a serving process runs it with
`torch.export.load(path).module()` and needs neither the model class nor
the checkpoint plumbing. Two surfaces are exported:

  offline   — the eval forward of the chunked swap
              (`video (B, T, H, W, in_ch) f32 -> frames (B, T, H, W, 3) f32`)
  streaming — `make_stream_steps`' `push(state, frame)` and
              `flush(state, total)`, and `init()`, a program without
              inputs that builds the zero state, so the loader rebuilds
              the state dict without knowing its layout

The programs take the plain path, as the JAX package's exports do (it
exports with `use_pallas=False`): the eval forward quantizes through
`vq_lookup` and the streaming steps are exported without a `prepare_fn`,
so no hand-written kernel is on either. The port's CUDA kernels are
launched through ctypes, which `torch.export` cannot trace.

A program is traced for one device, and its weights and the tensors it
builds live there: `platforms` names at most one device, the model's.
A `.pt2` file is bound to the torch version that wrote it, which
`meta.json` records.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from faceoff_tpu_torch.models.vqvae import VQVAE
from faceoff_tpu_torch.serve.streaming import make_stream_steps

FORMAT = "faceoff_tpu_torch.serving_bundle.v1"
_OFFLINE = "offline.pt2"
_PUSH = "streaming_push.pt2"
_FLUSH = "streaming_flush.pt2"
_INIT = "streaming_init.pt2"
_META = "meta.json"
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def check_platforms(platforms: Optional[Sequence[str]],
                    device: torch.device) -> str:
    """The device type a bundle is exported for: `device`'s, which
    `platforms` (None, or one of cuda/gpu/cpu) must name if given."""
    want = "cuda" if device.type == "cuda" else device.type
    if platforms is None:
        return want
    names = [str(p).lower() for p in platforms]
    if len(names) != 1:
        raise ValueError(
            f"platforms {names}: a torch.export program is traced for one "
            f"device; name one of cuda, gpu or cpu")
    if names[0] not in _PLATFORMS:
        raise ValueError(
            f"platform {names[0]!r}: the port exports for cuda (gpu) or "
            f"cpu only")
    if _PLATFORMS[names[0]] != want:
        raise ValueError(
            f"platform {names[0]!r} does not match the model's device "
            f"{device}; a program runs where its weights live")
    return want


class _Offline(nn.Module):
    def __init__(self, model: VQVAE):
        super().__init__()
        self.model = model

    def forward(self, video):
        dec, _ = self.model(video, train=False)
        return dec[..., :3].to(torch.float32)


class _Step(nn.Module):
    """One streaming function as a module; with a model it owns the
    model, so that the exported program holds its weights."""

    def __init__(self, fn, model: Optional[VQVAE] = None):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_offline(
    model: VQVAE,
    *,
    frames: int,
    size: int,
    batch: int = 1,
    platforms: Optional[Sequence[str]] = None,
) -> torch.export.ExportedProgram:
    """Export the eval forward: video (B, T, H, W, in_ch) f32 in [-1, 1]
    -> swapped frames (B, T, H, W, 3) f32, the weights held in the
    program."""
    dev = _device_of(model)
    check_platforms(platforms, dev)
    video = torch.zeros((batch, frames, size, size, model.in_channels),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        return torch.export.export(_Offline(model).eval(), (video,))


def _export_streaming(model: VQVAE, height: int, width: int, batch: int,
                      seconds: dict):
    """({file name: program} of push, flush and init, delay); each
    program's export seconds go into `seconds` under its file name."""
    dev = _device_of(model)
    init_state, push_step, flush_step, delay, _ = make_stream_steps(
        model, device=dev)
    state0 = init_state(batch, height, width)
    frame = torch.zeros((batch, height, width, model.in_channels),
                        dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.int32, device=dev)

    def init_fn():
        return init_state(batch, height, width)

    programs = {}
    for name, module, args in (
            (_PUSH, _Step(push_step, model), (state0, frame)),
            (_FLUSH, _Step(flush_step, model), (state0, total)),
            (_INIT, _Step(init_fn), ())):
        t = time.perf_counter()
        with torch.no_grad():
            programs[name] = torch.export.export(module.eval(), args)
        seconds[name] = time.perf_counter() - t
    return programs, delay


def export_streaming(
    model: VQVAE,
    *,
    height: int,
    width: int,
    batch: int = 1,
    platforms: Optional[Sequence[str]] = None,
) -> Tuple[torch.export.ExportedProgram, torch.export.ExportedProgram,
           torch.export.ExportedProgram, int]:
    """Export the online-inference primitives. Returns (push, flush,
    init, delay): push(state, frame) -> (state, out), flush(state, total)
    -> (state, out) with `total` a 0-dim int32 tensor, and init() -> the
    zero initial state, a program without inputs (JAX's `init_fn`)."""
    check_platforms(platforms, _device_of(model))
    programs, delay = _export_streaming(model, height, width, batch, {})
    return programs[_PUSH], programs[_FLUSH], programs[_INIT], delay


def save_bundle(
    out_dir: str,
    model: VQVAE,
    *,
    frames: int,
    size: int,
    batch: int = 1,
    streaming: bool = True,
    platforms: Optional[Sequence[str]] = None,
    seconds: Optional[dict] = None,
) -> dict:
    """Export offline (and, with `streaming`, the streaming programs) and
    write a self-contained bundle directory. Returns the meta dict.
    `seconds`, when given, receives each file's export-and-save seconds
    under its name."""
    dev = _device_of(model)
    platform = check_platforms(platforms, dev)
    os.makedirs(out_dir, exist_ok=True)
    seconds = {} if seconds is None else seconds
    meta = {
        "format": FORMAT,
        "in_channels": model.in_channels,
        "offline": {
            "file": _OFFLINE,
            "input_shape": [batch, frames, size, size, model.in_channels],
            "output_shape": [batch, frames, size, size, 3],
        },
        "platforms": [platform],
        "torch_version": torch.__version__,
    }

    def save(name, program):
        # the example inputs (zeros of the input shapes, 12.6 MB for the
        # offline clip at 256 px) are not needed to run a program
        t = time.perf_counter()
        program.example_inputs = None
        torch.export.save(program, osp.join(out_dir, name))
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t

    t = time.perf_counter()
    offline = export_offline(model, frames=frames, size=size, batch=batch)
    seconds[_OFFLINE] = time.perf_counter() - t
    save(_OFFLINE, offline)

    if streaming:
        programs, delay = _export_streaming(model, size, size, batch, seconds)
        for name, program in programs.items():
            save(name, program)
        meta["streaming"] = {
            "push_file": _PUSH,
            "flush_file": _FLUSH,
            "init_file": _INIT,
            "frame_shape": [batch, size, size, model.in_channels],
            "delay": delay,
        }

    with open(osp.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_bundle(bundle_dir: str) -> SimpleNamespace:
    """Load a serving bundle without the model class: a namespace with
    `meta`, `offline(video)` and, when the bundle holds streaming,
    `init_state()`, `push(state, frame)`, `flush(state, total)` and
    `delay`. Inputs go on the device the bundle was exported for
    (`meta["platforms"]`); `total` may be an int."""
    with open(osp.join(bundle_dir, _META)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} bundle: {bundle_dir} "
                         f"(format {meta.get('format')!r})")

    def _load(name):
        program = torch.export.load(osp.join(bundle_dir, name)).module()
        return torch.no_grad()(program)

    ns = SimpleNamespace(meta=meta)
    ns.offline = _load(meta["offline"]["file"])
    if "streaming" in meta:
        sm = meta["streaming"]
        dev = torch.device(meta["platforms"][0])
        flush = _load(sm["flush_file"])
        ns.init_state = _load(sm["init_file"])
        ns.push = _load(sm["push_file"])
        ns.flush = lambda state, total: flush(
            state, torch.as_tensor(total, dtype=torch.int32, device=dev))
        ns.delay = sm["delay"]
    return ns
