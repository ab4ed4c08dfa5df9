"""Reconstruction quality metrics and Fréchet feature distances."""

from faceoff_tpu_torch.evaluation.frechet import (feature_stats, fid,
                                                  frechet_distance,
                                                  make_fd_vgg, make_fd_video,
                                                  make_fd_video_features,
                                                  motion_features,
                                                  vgg_features)
from faceoff_tpu_torch.evaluation.metrics import (evaluate_reconstruction,
                                                  psnr, ssim)

__all__ = [
    "psnr",
    "ssim",
    "evaluate_reconstruction",
    "feature_stats",
    "fid",
    "frechet_distance",
    "make_fd_vgg",
    "make_fd_video",
    "make_fd_video_features",
    "motion_features",
    "vgg_features",
]
