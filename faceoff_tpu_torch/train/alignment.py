"""Train step of the alignment-regression network, counterpart of
`faceoff_tpu/train/alignment.py`.

It consumes the dataset's alignment items: input the (perturbed face ||
background) frames, target the negated applied transform (rotation, tx,
ty) of each frame. Frames fold into the batch axis; the loss is the MSE
over the three regressed quantities, and the step also reports each
quantity's mean absolute error. Adam as optax's defaults (b1 0.9, b2
0.999, eps 1e-8 outside the square root, which `torch.optim.Adam`
computes the same way).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from faceoff_tpu_torch.ops import video as video_ops


@dataclasses.dataclass
class AlignmentState:
    """The network, its Adam and the step count; updated in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_alignment_state(model: nn.Module, lr: float = 3e-4
                           ) -> AlignmentState:
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return AlignmentState(model=model, optimizer=opt, step=0)


def make_alignment_step(model: nn.Module) -> Callable:
    """`step(state, batch) -> (state, metrics)`; batch {"input": (B, T, H,
    W, 6), "transforms": (B, T, 3)} tensors on the model's device. metrics
    are 0-d float32 tensors on the device: loss, mae_rotation, mae_tx,
    mae_ty."""

    def train_step(state: AlignmentState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[AlignmentState, Dict[str, torch.Tensor]]:
        frames = video_ops.fold_time(batch["input"])
        targets = batch["transforms"].reshape(-1, 3).to(torch.float32)
        pred = model(frames)
        loss = torch.mean((pred - targets) ** 2)
        mae = torch.mean(torch.abs(pred - targets), dim=0).detach()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "mae_rotation": mae[0],
                       "mae_tx": mae[1], "mae_ty": mae[2]}

    return train_step
