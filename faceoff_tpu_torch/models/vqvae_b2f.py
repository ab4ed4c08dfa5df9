"""VQVAE_B2F (blob2full): a three-stream VQVAE with a shared decoder,
counterpart of `faceoff_tpu/models/vqvae_b2f.py`.

The original FaceOff code's legacy sign-language variant: separate
encode-and-quantize towers for the face, the right hand and the left hand,
whose quantized latents are summed and decoded by one shared decoder. No
trainer of either package wires it in; both keep it for parity.

It reuses `models.vqvae`'s `Encoder`, `Decoder` and `EmaQuantizer`. In
training mode each of the six quantizers assigns through
`ops/vq.vq_quantize_train`, which on the card is the VQ kernels of
`csrc/vq.cu`, and takes its EMA step (summed over `process_group` when
one is given). `upsample_t` is built as the VQVAE's (Flax's ConvTranspose
with SAME padding is torch's `padding=1` at 4x4 stride 2, with the kernel
flipped by the bridge, `io.convert`). Parameters are stored in `dtype` and
codebooks in float32, as in `VQVAE`; inputs and outputs are channels-last
(N, H, W, C), frames folded into N.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.models.vqvae import (Decoder, EmaQuantizer, Encoder,
                                            _init_, _nchw, _nhwc)

STREAMS = ("face", "rhand", "lhand")


class EncodeTower(nn.Module):
    """One stream: enc_b/enc_t > quantize_t > dec_t > quantize_b."""

    def __init__(self, in_channels: int = 3, channel: int = 128,
                 n_res_block: int = 2, n_res_channel: int = 32,
                 embed_dim: int = 64, n_embed: int = 512,
                 decay: float = 0.99):
        super().__init__()
        ch, rb, rc, ed = channel, n_res_block, n_res_channel, embed_dim
        self.enc_b = Encoder(in_channels, ch, rb, rc, 4)
        self.enc_t = Encoder(ch, ch, rb, rc, 2)
        self.quantize_conv_t = nn.Conv2d(ch, ed, 1)
        self.quantize_conv_b = nn.Conv2d(ed + ch, ed, 1)
        self.quantize_t = EmaQuantizer(ed, n_embed, decay)
        self.quantize_b = EmaQuantizer(ed, n_embed, decay)
        self.dec_t = Decoder(ed, ed, ch, rb, rc, 2)

    def forward(self, x: torch.Tensor, train: bool = False,
                update: bool = True):
        """x (N, C, H, W) in the tower's dtype -> (quant_t, quant_b,
        channels-first, diff)."""
        enc_b = self.enc_b(x)
        enc_t = self.enc_t(enc_b)
        quant_t, _, diff_t = self.quantize_t(
            _nhwc(self.quantize_conv_t(enc_t)), train, update)
        quant_t = _nchw(quant_t)
        dec_t = self.dec_t(quant_t)
        qb_in = self.quantize_conv_b(torch.cat([dec_t, enc_b], dim=1))
        quant_b, _, diff_b = self.quantize_b(_nhwc(qb_in), train, update)
        return quant_t, _nchw(quant_b), diff_t + diff_b


class VQVAE_B2F(nn.Module):
    """forward((face, rhand, lhand), train=False) -> (reconstruction
    (N, H, W, in_channels) float32, latent diff float32); each input
    (N, H, W, in_channels) in [-1, 1].

    Built on `device` (CUDA unless named) with random weights drawn on the
    CPU from `generator` (seed 0 if None): kernels LeCun-normal, biases
    zero, codebooks standard normal. Load JAX weights with
    `load_state_dict(io.convert.b2f_from_jax_variables(...))`."""

    def __init__(self, in_channels: int = 3, channel: int = 128,
                 n_res_block: int = 2, n_res_channel: int = 32,
                 embed_dim: int = 64, n_embed: int = 512,
                 decay: float = 0.99, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 process_group=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        tower = dict(in_channels=in_channels, channel=channel,
                     n_res_block=n_res_block, n_res_channel=n_res_channel,
                     embed_dim=embed_dim, n_embed=n_embed, decay=decay)
        self.encode_face = EncodeTower(**tower)
        self.encode_rhand = EncodeTower(**tower)
        self.encode_lhand = EncodeTower(**tower)
        self.upsample_t = nn.ConvTranspose2d(embed_dim, embed_dim, 4,
                                             stride=2, padding=1)
        self.dec = Decoder(embed_dim + embed_dim, in_channels, channel,
                           n_res_block, n_res_channel, 4)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            _init_(self, generator)
        # parameters in dtype, codebooks stay float32
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype)
        for m in self.modules():
            if isinstance(m, EmaQuantizer):
                m.process_group = process_group
        self.to(device)
        self.eval()

    def towers(self):
        return (self.encode_face, self.encode_rhand, self.encode_lhand)

    def forward(self, inputs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                train: bool = False, update_codebooks: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        quant_t = quant_b = diff = None
        for tower, x in zip(self.towers(), inputs):
            qt, qb, d = tower(_nchw(x.to(self.dtype)), train,
                              update_codebooks)
            if quant_t is None:
                quant_t, quant_b, diff = qt, qb, d
            else:
                quant_t, quant_b, diff = quant_t + qt, quant_b + qb, diff + d
        up_t = self.upsample_t(quant_t)
        dec = self.dec(torch.cat([up_t, quant_b], dim=1))
        return _nhwc(dec).to(torch.float32), diff.to(torch.float32)
