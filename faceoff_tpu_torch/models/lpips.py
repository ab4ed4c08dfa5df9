"""LPIPS perceptual distance on a VGG16 trunk, counterpart of
`faceoff_tpu/models/lpips.py`.

Five VGG16 feature taps (relu1_2 .. relu5_3), per-channel unit
normalisation, a 1x1 'lin' head per tap, spatial mean, summed over taps
and averaged over the batch. Inputs are (N, H, W, 3) in [-1, 1],
channels-last as in the JAX package; the convolutions run NCHW.

Two towers, as in the reference: the target's runs under
`torch.no_grad()`, so autograd saves and differentiates only the tower of
the prediction; the weights are frozen (`requires_grad_(False)`).
`dtype` is the JAX module's knob: the input standardisation, the
convolutions and the per-tap normalisation and head run in it (bf16 is
what the JAX trainer builds on its accelerator), and each tap's spatial
mean is taken in float32, as in the JAX package. Learned weights load
from the `.npz` layout the JAX package reads (`vgg/convB_C/kernel|bias`
HWIO, `linK/kernel`) with `load_lpips_weights`, or from JAX variables
through `io.convert.lpips_from_jax_variables`; without them `init_lpips`
builds a random VGG from a seed, as the JAX trainer does when it finds no
weights.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
import torch.utils.checkpoint

from faceoff_tpu_torch.device import DeviceLike, resolve_device

# per-channel input standardisation
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# VGG16 conv plan: (convs per block, channels); 2x2 max-pool between blocks
_VGG_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
_CHNS = tuple(c for _, c in _VGG_BLOCKS)


class VGG16Slices(nn.Module):
    """The VGG16 `features` trunk returning the five LPIPS taps, NCHW."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleDict()
        in_ch = 3
        for b, (n, ch) in enumerate(_VGG_BLOCKS):
            for c in range(n):
                self.convs[f"conv{b + 1}_{c + 1}"] = nn.Conv2d(
                    in_ch, ch, 3, padding=1)
                in_ch = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for b, (n, _) in enumerate(_VGG_BLOCKS):
            if b > 0:
                x = F.max_pool2d(x, 2, 2)
            for c in range(n):
                x = F.relu(self.convs[f"conv{b + 1}_{c + 1}"](x))
            taps.append(x)
        return taps


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise over the channel axis (dim 1, NCHW), in x's dtype
    when autocast is off."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """forward(target, pred) -> scalar: the batch mean of the summed
    per-tap scores. Both (N, H, W, 3) in [-1, 1]; weights and buffers are
    held in `dtype`."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vgg = VGG16Slices()
        self.lins = nn.ModuleList(
            nn.Conv2d(ch, 1, 1, bias=False) for ch in _CHNS)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the module computes in: that of its buffers and
        weights, so `.to(dtype)` moves it."""
        return self.shift.dtype

    def _tower(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        return self.vgg((x - self.shift) / self.scale)

    def forward(self, target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            feats0 = self._tower(target)
        feats1 = self._tower(pred)
        total = 0.0
        # autocast would send sum and pow to float32: the head computes
        # in the model's dtype, as the JAX module does
        with torch.autocast(pred.device.type, enabled=False):
            for k, (f0, f1) in enumerate(zip(feats0, feats1)):
                d = (_normalize_tensor(f0.to(self.dtype))
                     - _normalize_tensor(f1.to(self.dtype))) ** 2
                score = self.lins[k](d)
                total = total + torch.mean(score.to(torch.float32),
                                           dim=(1, 2, 3))
        return torch.mean(total)


def _lecun_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisation from a torch.Generator: kernels with
    std 1/sqrt(fan_in), biases zero."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            w.copy_(torch.randn(w.shape, generator=generator)
                    * (w[0].numel() ** -0.5))
            if m.bias is not None:
                m.bias.zero_()


def resolve_lpips_weights(arg: Optional[str]) -> Optional[str]:
    """A `--lpips_weights` value as it is; 'auto', the JAX package's probe
    of local paths, is not ported (ROADMAP.md, Queue 1 item 7) and
    raises."""
    if arg == "auto":
        raise ValueError("--lpips_weights auto needs discover_lpips_weights "
                         "(ROADMAP.md, Queue 1 item 7); pass an .npz path")
    return arg


def lpips_weights_trunk_only(npz_path: Optional[str]) -> bool:
    """Whether converted weights carry the VGG trunk without the learned
    lin heads (a bare VGG16 checkpoint): the heads then stay random and
    metrics computed with them are tagged `_untrained_lin`."""
    if npz_path is None:
        return False
    with np.load(npz_path) as data:
        return not any(k.startswith("lin") for k in data.files)


def init_lpips(
    generator: Optional[torch.Generator] = None,
    weights_npz: Optional[str] = None,
    *,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> LPIPS:
    """A frozen LPIPS on `device` (CUDA unless named): random weights from
    `generator` (seed 0 if None), overlaid with `weights_npz` when
    given. `dtype` None is bfloat16 on CUDA and float32 on the CPU, as
    the JAX trainer builds its LPIPS in bf16 on its accelerator; the
    weights are drawn in float32 and then cast."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = LPIPS()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        _lecun_normal_(model, generator)
    if weights_npz is not None:
        load_lpips_weights(model, weights_npz)
    model.requires_grad_(False)
    return model.to(dev, dtype).eval()


def state_dict_from_arrays(arrays) -> dict:
    """Flat `vgg/convB_C/kernel|bias` (HWIO) and `linK/kernel` arrays ->
    entries of LPIPS's state_dict (OIHW)."""
    sd = {}
    for key in arrays:
        arr = np.asarray(arrays[key], np.float32)
        parts = key.split("/")
        if parts[0] == "vgg":
            name, leaf = parts[1], parts[2]
            if leaf == "kernel":
                sd[f"vgg.convs.{name}.weight"] = np.transpose(arr, (3, 2, 0, 1))
            else:
                sd[f"vgg.convs.{name}.bias"] = arr
        elif parts[0].startswith("lin") and parts[1] == "kernel":
            sd[f"lins.{int(parts[0][3:])}.weight"] = np.transpose(
                arr, (3, 2, 0, 1))
        else:
            raise KeyError(f"unknown LPIPS weight {key}")
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def load_lpips_weights(model: LPIPS, npz_path: str) -> LPIPS:
    """Overlay converted weights from `npz_path`; every array must match
    the shape of the entry it replaces."""
    with np.load(npz_path) as data:
        sd = state_dict_from_arrays({k: data[k] for k in data.files})
    own = model.state_dict()
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"weight {k}: shape {tuple(v.shape)} != "
                             f"expected {tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=False)
    return model


class RematLPIPS(nn.Module):
    """An LPIPS whose activations are recomputed in the backward
    (`torch.utils.checkpoint`): less memory for more compute, the
    --remat_lpips flag."""

    def __init__(self, lpips: LPIPS):
        super().__init__()
        self.lpips = lpips

    def forward(self, target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        return torch.utils.checkpoint.checkpoint(self.lpips, target, pred,
                                                 use_reentrant=False)
