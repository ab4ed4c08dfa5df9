"""Reconstruction quality metrics, counterpart of
`faceoff_tpu/evaluation/metrics.py`: PSNR, SSIM and the report that
validation prints. Images are channels-last in [-1, 1]; every metric is a
0-d float32 tensor on the images' device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole array."""
    mse = torch.mean((pred.to(torch.float32) - target.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity (Wang et al.) with a Gaussian window,
    over the valid windows of (N, H, W, C) images."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n_ch = pred.shape[-1]
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)
    weight = kern[None, None].expand(n_ch, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), weight, groups=n_ch)

    p = pred.to(torch.float32)
    t = target.to(torch.float32)
    mu_p, mu_t = filt(p), filt(t)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = filt(p * p) - mu_pp
    sigma_t = filt(t * t) - mu_tt
    sigma_pt = filt(p * t) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2)
    return torch.mean(num / den)


@torch.no_grad()
def evaluate_reconstruction(
    pred: torch.Tensor,
    target: torch.Tensor,
    lpips_apply: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """mse, l1, psnr and ssim of (N, H, W, C) or (B, T, H, W, C) batches,
    and lpips when `lpips_apply(target, pred)` (an LPIPS module) is
    given."""
    if pred.dim() == 5:
        pred = pred.reshape((-1,) + tuple(pred.shape[2:]))
        target = target.reshape((-1,) + tuple(target.shape[2:]))
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    out = {
        "mse": torch.mean((pred - target) ** 2),
        "l1": torch.mean(torch.abs(pred - target)),
        "psnr": psnr(pred, target),
        "ssim": ssim(pred, target),
    }
    if lpips_apply is not None:
        out["lpips"] = lpips_apply(target, pred)
    return out
