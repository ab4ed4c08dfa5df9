"""Alignment-regression network, counterpart of
`faceoff_tpu/models/alignment.py`: from the (perturbed face || background)
composite it predicts the inverse of the perturbation that the dataset's
alignment items applied, (rotation deg, tx px, ty px)
(`data.dataset.TemporalAlignmentDataset(alignment=True)`).

Strided 4x4 convolutions (stride 2, padding 1, as Flax's `padding=1`),
each with a ReLU, a global mean over H and W, then Dense(128) + ReLU and
Dense(3). Parameters are float32; the computation runs in `dtype`
(weights, biases and activations cast to it, as a Flax module with a
`dtype` computes), bf16 on CUDA and float32 on the CPU by default, as the
JAX alignment CLI picks it. The output is float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from faceoff_tpu_torch.device import DeviceLike, resolve_device


class AlignmentNet(nn.Module):
    """(N, H, W, 6) composite -> (N, 3) predicted inverse transform.

    Built on `device` (CUDA unless named) with LeCun-normal kernels drawn
    on the CPU from `generator` (seed 0 if None) and zero biases."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 128),
                 dtype: Optional[torch.dtype] = None, in_channels: int = 6,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if dtype is None:
            dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        self.dtype = dtype
        convs, cin = [], in_channels
        for w in widths:
            convs.append(nn.Conv2d(cin, w, 4, stride=2, padding=1))
            cin = w
        self.convs = nn.ModuleList(convs)
        self.dense = nn.ModuleList([nn.Linear(cin, 128), nn.Linear(128, 3)])
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                     generator=generator)
                    m.bias.zero_()
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        h = x.to(d).permute(0, 3, 1, 2)
        for conv in self.convs:
            h = F.relu(F.conv2d(h, conv.weight.to(d), conv.bias.to(d),
                                stride=2, padding=1))
        h = torch.mean(h, dim=(2, 3))  # global average pool
        lin0, lin1 = self.dense
        h = F.relu(F.linear(h, lin0.weight.to(d), lin0.bias.to(d)))
        return F.linear(h, lin1.weight.to(d), lin1.bias.to(d)).to(torch.float32)
