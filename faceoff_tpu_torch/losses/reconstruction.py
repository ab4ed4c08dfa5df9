"""Reconstruction losses, counterpart of `faceoff_tpu/losses/reconstruction.py`."""

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error, computed in float32."""
    return torch.mean((pred.to(torch.float32) - target.to(torch.float32)) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error, computed in float32."""
    return torch.mean(torch.abs(pred.to(torch.float32)
                                - target.to(torch.float32)))
