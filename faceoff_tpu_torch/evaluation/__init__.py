"""Reconstruction quality metrics."""

from faceoff_tpu_torch.evaluation.metrics import (evaluate_reconstruction,
                                                  psnr, ssim)

__all__ = ["evaluate_reconstruction", "psnr", "ssim"]
