"""Hierarchical VQVAE-2 generator with Conv3D temporal postnets.

Counterpart of `faceoff_tpu/models/vqvae.py`: a two-level
VQ-VAE (bottom latent at stride 4, top at stride 8) whose encoder outputs
pass through Conv3D postnets that blend latents across frames before
quantization.

Module and parameter names follow the original PyTorch FaceOff generator
(`enc_b.blocks.N`, `conv3d_encoded_b.conv3d.J.0`, `quantize_t.embed`, ...),
which is also the naming `tools/convert_vqvae.py` exports, so a state_dict
from either loads with `strict=True` (`io/convert.from_jax_variables`
builds one from the JAX package's variables).

The public methods keep the JAX package's channels-last layouts (frames
NHWC, clips NTHWC); the convolutions inside run NCHW / NCDHW. Conv
parameters are stored in the model dtype (bf16 for serving on the card,
float32 for training, which computes in bf16 under `torch.autocast`, and
in tests); codebooks stay float32 and the nearest-code scores are float32.

Training (`forward(video, train=True)`) runs both quantizers through
`ops/vq.vq_quantize_train` and writes the EMA-updated codebooks into their
buffers: through the VQ kernels on CUDA, or through their plain version
on every device with `ModelConfig.use_pallas_vq` off (the CLIs'
--no_pallas; the JAX model's `use_pallas`). Evaluation looks up either
way. With `ModelConfig.remat` the encoders, postnets and decoders
(as `remat_scope` selects) recompute their activations in the backward
(`torch.utils.checkpoint`); the quantizers stay outside the recomputed
regions, as in the JAX model, so the EMA update runs once per step.

Over a clip sharded in time (`set_time_group`, a time group of
`parallel.collectives.mesh_groups`) each process holds a block of every
clip's frames. The postnets then exchange one halo frame with each time
neighbour before each layer (`collectives.halo_exchange`) and convolve
without time padding (`TemporalPostnet.layer_shard`); every other layer
works frame by frame. The exchanges stay outside any recomputed region,
so a rematerialised backward runs them once, in the autograd order that
every process shares.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.ops import video as video_ops
from faceoff_tpu_torch.ops import vq as vq_ops
from faceoff_tpu_torch.parallel import collectives


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    """Pre-activation residual block: ReLU > 3x3 conv > ReLU > 1x1 conv + skip."""

    def __init__(self, in_channel: int, channel: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.ReLU(),
            nn.Conv2d(in_channel, channel, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(channel, in_channel, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


class Encoder(nn.Module):
    """Strided conv encoder: stride 4 is two k4s2 convs, stride 2 one."""

    def __init__(self, in_channel: int, channel: int, n_res_block: int,
                 n_res_channel: int, stride: int):
        super().__init__()
        if stride == 4:
            blocks = [
                nn.Conv2d(in_channel, channel // 2, 4, stride=2, padding=1),
                nn.ReLU(),
                nn.Conv2d(channel // 2, channel, 4, stride=2, padding=1),
                nn.ReLU(),
                nn.Conv2d(channel, channel, 3, padding=1),
            ]
        elif stride == 2:
            blocks = [
                nn.Conv2d(in_channel, channel // 2, 4, stride=2, padding=1),
                nn.ReLU(),
                nn.Conv2d(channel // 2, channel, 3, padding=1),
            ]
        else:
            raise ValueError(f"unsupported stride {stride}")
        blocks += [ResBlock(channel, n_res_channel) for _ in range(n_res_block)]
        blocks.append(nn.ReLU())
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


class Decoder(nn.Module):
    """Conv + res blocks + k4s2 transposed-conv upsampler."""

    def __init__(self, in_channel: int, out_channel: int, channel: int,
                 n_res_block: int, n_res_channel: int, stride: int):
        super().__init__()
        blocks = [nn.Conv2d(in_channel, channel, 3, padding=1)]
        blocks += [ResBlock(channel, n_res_channel) for _ in range(n_res_block)]
        blocks.append(nn.ReLU())
        if stride == 4:
            blocks += [
                nn.ConvTranspose2d(channel, channel // 2, 4, stride=2,
                                   padding=1),
                nn.ReLU(),
                nn.ConvTranspose2d(channel // 2, out_channel, 4, stride=2,
                                   padding=1),
            ]
        elif stride == 2:
            blocks.append(
                nn.ConvTranspose2d(channel, out_channel, 4, stride=2,
                                   padding=1)
            )
        else:
            raise ValueError(f"unsupported stride {stride}")
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


class TemporalPostnet(nn.Module):
    """Conv3D stack blending latents across frames: n-1 conv+ReLU layers
    and a final linear conv, all kernel k 'same' over (T, H, W), NCDHW.

    With a `time_group` (`VQVAE.set_time_group`) the input is this
    process's block of frames: each layer takes k//2 halo frames from
    each time neighbour (`collectives.halo_exchange`) and runs
    `layer_shard`."""

    def __init__(self, channels: int, n_layers: int = 3, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.time_group = None
        self.conv3d = nn.ModuleList(
            nn.Sequential(
                nn.Conv3d(channels, channels, kernel, padding="same"),
                *([nn.ReLU()] if i < n_layers - 1 else []),
            )
            for i in range(n_layers)
        )

    def layer_shard(self, i: int, x: torch.Tensor, halo_prev: torch.Tensor,
                    halo_next: torch.Tensor) -> torch.Tensor:
        """Layer i on a block of frames: x (B, C, t, H, W) between the
        neighbours' halos (B, C, k//2, H, W), zeros past the clip's ends ->
        (B, C, t, H, W). No time padding; 'same' in H and W."""
        conv = self.conv3d[i][0]
        p = self.kernel // 2
        # the halos in x's memory format, so that the window keeps it (a
        # channels-last block stays channels-last, as on the whole clip)
        fmt = (torch.channels_last_3d
               if x.is_contiguous(memory_format=torch.channels_last_3d)
               else torch.contiguous_format)
        window = torch.cat([halo_prev.contiguous(memory_format=fmt), x,
                            halo_next.contiguous(memory_format=fmt)], dim=2)
        y = F.conv3d(window, conv.weight, conv.bias, padding=(0, p, p))
        return F.relu(y) if i < len(self.conv3d) - 1 else y

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """x (B, C, T, H, W), or this process's frame block of it with a
        time group; `remat` recomputes each layer's convolution (not its
        exchange) in the backward."""
        if self.time_group is None:
            for layer in self.conv3d:
                x = layer(x)
            return x
        if torch.is_autocast_enabled(x.device.type):
            # exchange in the compute dtype the convolution casts to
            x = x.to(torch.get_autocast_dtype(x.device.type))
        for i in range(len(self.conv3d)):
            halo_prev, halo_next = collectives.halo_exchange(
                x, 2, self.time_group, self.kernel // 2)
            if remat:
                x = checkpoint(self.layer_shard, i, x, halo_prev, halo_next,
                               use_reentrant=False)
            else:
                x = self.layer_shard(i, x, halo_prev, halo_next)
        return x


def postnet_over_shards(postnet: TemporalPostnet, shards):
    """The postnet over a clip cut into consecutive frame blocks (a list
    of (B, C, t, H, W)) in one process: before each layer every block
    gets the halos `collectives.halo_exchange` would deliver (its
    neighbours' edge frames, zeros past the clip's ends) and runs
    `layer_shard`. Returns the blocks of the output; autograd through
    the slices is the exchange's backward."""
    d = postnet.kernel // 2
    shards = list(shards)
    for i in range(len(postnet.conv3d)):
        zero = torch.zeros_like(shards[0][:, :, :d])
        prevs = [zero] + [s[:, :, -d:] for s in shards[:-1]]
        nexts = [s[:, :, :d] for s in shards[1:]] + [zero]
        shards = [postnet.layer_shard(i, s, a, b)
                  for s, a, b in zip(shards, prevs, nexts)]
    return shards


class EmaQuantizer(nn.Module):
    """One codebook held as float32 buffers. Evaluation looks up; training
    also advances the EMA state in the buffers."""

    def __init__(self, embed_dim: int, n_embed: int, decay: float = 0.99,
                 eps: float = 1e-5, process_group=None,
                 use_kernels: bool = True):
        super().__init__()
        self.embed_dim = embed_dim
        self.decay = decay
        self.eps = eps
        # training assigns through the VQ kernels on CUDA; False: through
        # their plain version on every device
        self.use_kernels = use_kernels
        # a torch.distributed group: the EMA statistics and the revive's
        # rows are this process's and are reduced over it (None: one process)
        self.process_group = process_group
        # the time axis of that group's data x time mesh: the revive puts
        # the gathered rows back in the one-process (B, T, h, w) order
        self.time_parallel = 1
        self.register_buffer("embed", torch.zeros(embed_dim, n_embed))
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", torch.zeros(embed_dim, n_embed))

    @property
    def codebook(self) -> vq_ops.VQCodebook:
        return vq_ops.VQCodebook(self.embed, self.cluster_size, self.embed_avg)

    @torch.no_grad()
    def _store(self, codebook: vq_ops.VQCodebook) -> None:
        self.embed.copy_(codebook.embed)
        self.cluster_size.copy_(codebook.cluster_size)
        self.embed_avg.copy_(codebook.embed_avg)

    def forward(
        self, x: torch.Tensor, train: bool = False, update: bool = True
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (..., embed_dim) channels-last -> (quant, indices, diff).
        Training mode assigns through the VQ kernels (or their plain
        version, `use_kernels` off) and, with `update`, stores the EMA
        step."""
        if not train:
            return vq_ops.vq_lookup(self.codebook, x)
        quant, indices, diff, new = vq_ops.vq_quantize_train(
            self.codebook, x, decay=self.decay, eps=self.eps, update=update,
            process_group=self.process_group, use_kernels=self.use_kernels)
        if update:
            self._store(new)
        return quant, indices, diff

    def lookup_codes(self, codes: torch.Tensor) -> torch.Tensor:
        return vq_ops.codebook_lookup(codes, self.embed)

    def revive(self, x: torch.Tensor, generator: torch.Generator,
               usage_threshold: float = 1e-3) -> None:
        """Re-seed EMA-dead codes from the activations x (B, T, ...,
        embed_dim): this process's block of clips and frames."""
        self._store(vq_ops.revive_dead_codes(
            self.codebook, x.detach().to(torch.float32), generator,
            usage_threshold=usage_threshold,
            process_group=self.process_group,
            time_parallel=self.time_parallel))


def _init_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's defaults from a torch.Generator: kernels LeCun-normal
    (std 1/sqrt(fan_in)), biases zero, codebooks standard normal with
    embed_avg a copy of embed and cluster_size zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            w = m.weight
            in_ch = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
            fan_in = in_ch * w[0, 0].numel()
            w.normal_(0.0, fan_in ** -0.5, generator=generator)
            m.bias.zero_()
        elif isinstance(m, EmaQuantizer):
            m.embed.normal_(0.0, 1.0, generator=generator)
            m.embed_avg.copy_(m.embed)
            m.cluster_size.zero_()


class VQVAE(nn.Module):
    """Two-level VQVAE-2 with temporal postnets.

    forward(video, train=False, update_codebooks=True) -> (reconstruction
    float32, latent diff float32); video (B, T, H, W, in_channels) in
    [-1, 1]. With train=True the quantizers assign through the VQ kernels
    and the codebooks take one EMA step, unless update_codebooks=False
    (the discriminator steps of the GAN stage, whose JAX counterparts
    drop the EMA update).

    Built on `device` (CUDA unless named; without CUDA and without a named
    device it raises) with random weights drawn on the CPU from
    `generator` (a fresh generator seeded 0 if None), so a seed gives the
    same weights on every device. `process_group` (a torch.distributed
    group, None for one process) is the JAX model's `axis_name`: both
    quantizers sum their EMA statistics over it. `time_group` (see
    `set_time_group`) shards the frames. Load trained weights with
    `load_state_dict(io.convert.from_jax_variables(...), strict=True)`.
    """

    def __init__(
        self,
        config: ModelConfig = ModelConfig(),
        *,
        dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
        process_group=None,
        time_group=None,
    ):
        super().__init__()
        device = resolve_device(device)
        c = config
        self.in_channels = c.in_channels
        self.out_channels = c.out_channels or c.in_channels
        self.channel = c.channel
        self.temporal_postnet_layers = c.temporal_postnet_layers
        self.temporal_kernel = c.temporal_kernel
        self.commitment_beta = c.commitment_beta
        self.dtype = dtype
        self.remat_encoder = c.remat and c.remat_scope in ("all", "encoder")
        self.remat_decoder = c.remat and c.remat_scope in ("all", "decoder")
        if c.remat and c.remat_scope not in ("all", "encoder", "decoder"):
            raise ValueError(f"unknown remat_scope {c.remat_scope!r}")
        ch, rb, rc, ed = c.channel, c.n_res_block, c.n_res_channel, c.embed_dim
        with torch.device("meta"):
            self.enc_b = Encoder(c.in_channels, ch, rb, rc, 4)
            self.enc_t = Encoder(ch, ch, rb, rc, 2)
            self.quantize_conv_t = nn.Conv2d(ch, ed, 1)
            self.quantize_t = EmaQuantizer(ed, c.n_embed, c.vq_decay, c.vq_eps,
                                           use_kernels=c.use_pallas_vq)
            self.dec_t = Decoder(ed, ed, ch, rb, rc, 2)
            self.quantize_conv_b = nn.Conv2d(ed + ch, ed, 1)
            self.quantize_b = EmaQuantizer(ed, c.n_embed, c.vq_decay, c.vq_eps,
                                           use_kernels=c.use_pallas_vq)
            self.upsample_t = nn.ConvTranspose2d(ed, ed, 4, stride=2, padding=1)
            self.dec = Decoder(ed + ed, self.out_channels, ch, rb, rc, 4)
            self.conv3d_encoded_b = TemporalPostnet(
                ch, c.temporal_postnet_layers, c.temporal_kernel
            )
            self.conv3d_encoded_t = TemporalPostnet(
                ch, c.temporal_postnet_layers, c.temporal_kernel
            )
        self.to_empty(device="cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            _init_(self, generator)
        for m in self.children():
            if not isinstance(m, EmaQuantizer):
                m.to(dtype)
        self.set_process_group(process_group)
        self.set_time_group(time_group)
        self.to(device)
        self.eval()

    def set_process_group(self, group) -> None:
        """Reduce the quantizers' statistics over `group` from now on."""
        for m in self.modules():
            if isinstance(m, EmaQuantizer):
                m.process_group = group

    def set_time_group(self, group) -> None:
        """Take this process's block of every clip's frames from now on:
        `group` is its time group (`collectives.mesh_groups`), None for
        whole clips. The postnets exchange halos over it, the evaluation
        `diff` is averaged over it, and a revive puts the rows gathered
        over the process group back in the one-process order."""
        self.time_group = group
        k = torch.distributed.get_world_size(group) if group is not None else 1
        for m in self.modules():
            if isinstance(m, TemporalPostnet):
                m.time_group = group
            elif isinstance(m, EmaQuantizer):
                m.time_parallel = k

    # -- internal, channels-first -----------------------------------------

    @staticmethod
    def _run(module: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
        """module(x), recomputed in the backward when `remat` is set and
        autograd records."""
        if remat and torch.is_grad_enabled():
            return checkpoint(module, x, use_reentrant=False)
        return module(x)

    def _encode_frames(
        self, frames: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames (N, C, H, W) -> (enc_b (N, ch, H/4, W/4),
        enc_t (N, ch, H/8, W/8))."""
        enc_b = self._run(self.enc_b, frames.to(self.dtype), self.remat_encoder)
        return enc_b, self._run(self.enc_t, enc_b, self.remat_encoder)

    def _quantize_conv_b(self, quant_t: torch.Tensor, enc_b: torch.Tensor):
        dec_t = self._run(self.dec_t, quant_t, self.remat_decoder)
        return self.quantize_conv_b(torch.cat([dec_t, enc_b], dim=1))

    def _encode_quantized(self, enc_b: torch.Tensor, enc_t: torch.Tensor,
                          train: bool = False, update: bool = True):
        """enc_b/enc_t (N, ch, h, w) -> (quant_t, quant_b (N, D, h, w),
        diff, id_t, id_b)."""
        qt_in = self.quantize_conv_t(enc_t)
        quant_t, id_t, diff_t = self.quantize_t(_nhwc(qt_in), train, update)
        quant_t = _nchw(quant_t)
        qb_in = self._quantize_conv_b(quant_t, enc_b)
        quant_b, id_b, diff_b = self.quantize_b(_nhwc(qb_in), train, update)
        diff = (diff_t + diff_b) * self.commitment_beta
        return quant_t, _nchw(quant_b), diff, id_t, id_b

    def _decode(self, quant_t: torch.Tensor, quant_b: torch.Tensor):
        """(N, D, h8, w8), (N, D, h4, w4) -> (N, out, H, W) in self.dtype."""
        up_t = self.upsample_t(quant_t)
        return self._run(self.dec, torch.cat([up_t, quant_b], dim=1),
                         self.remat_decoder)

    def _blended_frames(
        self, video: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """video (B,T,H,W,C) -> encoded and temporally blended latents,
        frame-folded channels-first (N, ch, h, w)."""
        enc_b, enc_t = self.temporal_blend(*self.only_encode(video))
        return (_nchw(video_ops.fold_time(enc_b)),
                _nchw(video_ops.fold_time(enc_t)))

    # -- public, channels-last (the JAX package's layouts) ----------------

    def only_encode(
        self, video: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """video (B,T,H,W,C) -> (enc_b (B,T,H/4,W/4,ch),
        enc_t (B,T,H/8,W/8,ch))."""
        b = video.shape[0]
        enc_b, enc_t = self._encode_frames(_nchw(video_ops.fold_time(video)))
        return (video_ops.unfold_time(_nhwc(enc_b), b),
                video_ops.unfold_time(_nhwc(enc_t), b))

    def temporal_blend(
        self, enc_b: torch.Tensor, enc_t: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Conv3D postnets on both levels; (B,T,h,w,ch) in and out."""

        def run(postnet, x):
            x = x.permute(0, 4, 1, 2, 3)
            if postnet.time_group is None:
                y = self._run(postnet, x, self.remat_encoder)
            else:
                y = postnet(x, remat=self.remat_encoder
                            and torch.is_grad_enabled())
            return y.permute(0, 2, 3, 4, 1)

        return run(self.conv3d_encoded_b, enc_b), run(self.conv3d_encoded_t, enc_t)

    def encode_quantized(self, enc_b: torch.Tensor, enc_t: torch.Tensor,
                         train: bool = False):
        """Project to embed_dim and quantize both levels.

        enc_b/enc_t: (N, h, w, channel) frame-folded. Returns
        (quant_t, quant_b, diff, id_t, id_b), channels-last.
        """
        quant_t, quant_b, diff, id_t, id_b = self._encode_quantized(
            _nchw(enc_b), _nchw(enc_t), train
        )
        return _nhwc(quant_t), _nhwc(quant_b), diff, id_t, id_b

    def decode(self, quant_t: torch.Tensor, quant_b: torch.Tensor):
        """(N, h8, w8, D), (N, h4, w4, D) -> (N, H, W, out) in self.dtype."""
        return _nhwc(self._decode(_nchw(quant_t), _nchw(quant_b)))

    def decode_code(self, code_t: torch.Tensor, code_b: torch.Tensor):
        """Decode integer code maps (N, h8, w8) and (N, h4, w4)."""
        quant_t = self.quantize_t.lookup_codes(code_t).to(self.dtype)
        quant_b = self.quantize_b.lookup_codes(code_b).to(self.dtype)
        return self.decode(quant_t, quant_b)

    def encode_codes(
        self, video: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Video -> discrete (code_t, code_b) maps, frame-folded."""
        _, _, _, id_t, id_b = self._encode_quantized(
            *self._blended_frames(video))
        return id_t, id_b

    @torch.no_grad()
    def revive_codes(self, video: torch.Tensor, generator: torch.Generator,
                     usage_threshold: float = 1e-3) -> None:
        """Re-seed dead codebook entries of both levels from this batch's
        pre-quantization latents; the top level first, then the bottom
        level from latents built with the revived top codebook."""
        b = video.shape[0]
        enc_b, enc_t = self._blended_frames(video)
        qt_in = self.quantize_conv_t(enc_t)
        self.quantize_t.revive(video_ops.unfold_time(_nhwc(qt_in), b),
                               generator, usage_threshold)
        quant_t, _, _ = self.quantize_t(_nhwc(qt_in))
        qb_in = self._quantize_conv_b(_nchw(quant_t), enc_b)
        self.quantize_b.revive(video_ops.unfold_time(_nhwc(qb_in), b),
                               generator, usage_threshold)

    def forward(
        self, video: torch.Tensor, train: bool = False,
        update_codebooks: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = video.shape[0]
        quant_t, quant_b, diff, _, _ = self._encode_quantized(
            *self._blended_frames(video), train, update_codebooks)
        if self.time_group is not None and not train:
            # the diff of the whole clips; a training step averages its
            # metrics and gradients over every process instead
            diff = collectives.all_reduce_mean(diff, self.time_group)
        dec = _nhwc(self._decode(quant_t, quant_b))
        return (video_ops.unfold_time(dec, b).to(torch.float32),
                diff.to(torch.float32))
