"""Contrastive face-similarity loss and the Siamese embedding network,
counterpart of `faceoff_tpu/losses/contrastive.py`.

The original FaceOff code defines these auxiliary identity-similarity
components but wires them into no trainer; both packages keep them for
parity, usable as an optional identity-preservation term.

The tower is three reflect-padded VALID 3x3 convolutions, each followed
by a ReLU and a BatchNorm with Flax's semantics
(`models.discriminators.BatchNorm`: momentum 0.99, biased batch variance,
eps 1e-5), then a 3-layer MLP. The JAX tower flattens its NHWC
activations before the first Dense layer; this one flattens in the same
(H, W, C) order, so the Dense weights carry over without a permutation.
Flax infers that layer's input width from the first call; here it is
fixed by `image_size` (100 px in the original).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.models.discriminators import BatchNorm


def pairwise_distance(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Euclidean distance per row, sqrt(sum((a - b)^2) + eps)."""
    return torch.sqrt(torch.sum((a - b) ** 2, dim=-1) + eps)


def contrastive_loss(out1: torch.Tensor, out2: torch.Tensor,
                     label: torch.Tensor, margin: float = 2.0) -> torch.Tensor:
    """Hadsell-Chopra-LeCun contrastive loss: label 0 is a similar pair,
    1 a dissimilar one."""
    d = pairwise_distance(out1, out2)
    sim = (1.0 - label) * d ** 2
    dis = label * torch.clamp(margin - d, min=0.0) ** 2
    return torch.mean(sim + dis)


class _FaceTower(nn.Module):
    """One embedding tower: (N, H, W[, C]) channels-last -> (N, embed_dim)."""

    def __init__(self, features: Sequence[int], embed_dim: int, hidden: int,
                 image_size: int, in_channels: int):
        super().__init__()
        convs, cin = [], in_channels
        for f in features:
            convs.append(nn.Conv2d(cin, f, 3))
            cin = f
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchNorm(f) for f in features)
        self.dense = nn.ModuleList([
            nn.Linear(cin * image_size * image_size, hidden),
            nn.Linear(hidden, hidden),
            nn.Linear(hidden, embed_dim),
        ])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]  # (N, H, W) -> one channel
        x = x.permute(0, 3, 1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = F.pad(x, (1, 1, 1, 1), mode="reflect")
            x = norm(F.relu(conv(x)), train)
        # flatten in the JAX tower's NHWC order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x))
        return self.dense[2](x)


class SiameseFaceEmbedder(nn.Module):
    """One weight-shared tower applied to both inputs; forward returns the
    mean pairwise embedding distance. In training mode each call of the
    tower advances its BatchNorm averages, x1's first, as the Flax module
    does.

    Built on `device` (CUDA unless named) with Flax's default
    initialisation drawn on the CPU from `generator` (seed 0 if None):
    kernels LeCun-normal, biases zero, BatchNorm scale 1 and bias 0."""

    def __init__(self, features: Sequence[int] = (4, 8, 8),
                 embed_dim: int = 5, hidden: int = 500,
                 image_size: int = 100, in_channels: int = 1, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tower = _FaceTower(tuple(features), embed_dim, hidden,
                                image_size, in_channels)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    w = m.weight
                    w.normal_(0.0, w[0].numel() ** -0.5, generator=generator)
                    m.bias.zero_()
        self.to(resolve_device(device))

    def embed(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.tower(x, train)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        e1 = self.tower(x1, train)
        e2 = self.tower(x2, train)
        return torch.mean(pairwise_distance(e1, e2))
