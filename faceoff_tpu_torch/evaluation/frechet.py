"""Fréchet feature-distribution distances (the FID/FVD family),
counterpart of `faceoff_tpu/evaluation/frechet.py`.

  frechet_distance(mu1, cov1, mu2, cov2)   the closed form
  feature_stats(feats)                     mean and covariance
  fid(real_feats, fake_feats)              the distance between two
                                           feature clouds
  vgg_features(lpips, images)              pooled VGG16 tap activations of
                                           the LPIPS trunk
  motion_features(lpips, videos)           the same of frame differences

FID proper uses InceptionV3 and FVD an I3D network; neither weight set is
in the repository, so the extractor is the LPIPS VGG16: converted weights
where given, else the random VGG from a seed. Random features give a
relative distance for tracking one run, not numbers comparable with
published FID; the CLIs tag them `_random_vgg`.

The features are computed by a float32 VGG16 trunk with the LPIPS
module's weights, whatever dtype the LPIPS module computes in (the JAX
package runs `VGG16Slices()` in float32 here). The matrix square root is
an eigendecomposition (`torch.linalg.eigh`) of the symmetrised matrix.
Inputs are torch tensors, channels-last, in [-1, 1].
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import torch

from faceoff_tpu_torch.models.lpips import _SCALE, _SHIFT, LPIPS, VGG16Slices


def feature_stats(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) features -> (mean (D,), covariance (D, D))."""
    feats = feats.to(torch.float32)
    mu = torch.mean(feats, dim=0)
    centered = feats - mu
    n = feats.shape[0]
    return mu, centered.T @ centered / max(n - 1, 1)


def _sqrtm_psd(mat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """The square root of a (nearly) positive semi-definite symmetric
    matrix through its eigendecomposition, negative eigenvalues clipped
    to 0."""
    vals, vecs = torch.linalg.eigh((mat + mat.T) / 2.0)
    vals = torch.clamp(vals, min=0.0)
    return (vecs * torch.sqrt(vals + eps)[None, :]) @ vecs.T


def frechet_distance(mu1: torch.Tensor, cov1: torch.Tensor,
                     mu2: torch.Tensor, cov2: torch.Tensor) -> torch.Tensor:
    """d^2 = |mu1 - mu2|^2 + Tr(cov1 + cov2 - 2 (cov1 cov2)^(1/2)), the
    cross term as sqrt(sqrt(cov1) cov2 sqrt(cov1)), which is PSD."""
    diff = torch.sum((mu1.to(torch.float32) - mu2.to(torch.float32)) ** 2)
    s1 = _sqrtm_psd(cov1)
    covmean = _sqrtm_psd(s1 @ cov2 @ s1)
    return (diff + torch.trace(cov1) + torch.trace(cov2)
            - 2.0 * torch.trace(covmean))


def fid(real_feats: torch.Tensor, fake_feats: torch.Tensor) -> torch.Tensor:
    """The Fréchet distance between two (N, D) feature clouds."""
    mu_r, cov_r = feature_stats(real_feats)
    mu_f, cov_f = feature_stats(fake_feats)
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)


def float32_trunk(lpips: LPIPS) -> VGG16Slices:
    """The LPIPS module's VGG16 trunk in float32: the module's own where
    it computes in float32, else a float32 copy of its weights."""
    if lpips.dtype == torch.float32:
        return lpips.vgg
    return copy.deepcopy(lpips.vgg).to(torch.float32)


@torch.no_grad()
def vgg_features(lpips, images: torch.Tensor, max_dim: int = 64,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """Pooled VGG16 tap activations as Fréchet features.

    lpips: an LPIPS module (its trunk runs in float32, `float32_trunk`) or
    a float32 VGG16Slices. images: (N, H, W, 3) in [-1, 1]. Returns
    (N, D) float32 with D = sum(min(channels, max_dim)) over the five
    taps, each tap averaged over space and cut to its first max_dim
    channels. Frames go through the trunk `chunk` at a time (by default
    about 32 at 256 px, scaled by pixel count), which bounds the memory
    of the first 64-channel tap."""
    trunk = lpips if isinstance(lpips, VGG16Slices) else float32_trunk(lpips)
    n, h, w = images.shape[:3]
    if chunk is None:
        chunk = max(1, (32 * 256 * 256) // (h * w))
    if n > chunk:
        return torch.cat([vgg_features(trunk, images[i: i + chunk], max_dim,
                                       chunk) for i in range(0, n, chunk)])
    dev = images.device
    shift = torch.tensor(_SHIFT, device=dev)
    scale = torch.tensor(_SCALE, device=dev)
    prep = (images.to(torch.float32) - shift) / scale
    taps = trunk(prep.permute(0, 3, 1, 2))
    pooled = [torch.mean(t.to(torch.float32), dim=(2, 3))[:, :max_dim]
              for t in taps]
    return torch.cat(pooled, dim=-1)


def make_fd_vgg(lpips) -> Callable:
    """fd(real, fake) on (N, H, W, 3) image batches in [-1, 1] with the
    LPIPS VGG16 trunk's features."""
    trunk = float32_trunk(lpips)

    def fd(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
        return fid(vgg_features(trunk, real), vgg_features(trunk, fake))

    return fd


def motion_features(lpips, videos: torch.Tensor,
                    max_dim: int = 64) -> torch.Tensor:
    """Temporal features: `vgg_features` of consecutive-frame differences
    (halved, to stay in [-1, 1]), the role of FVD's motion statistics.
    Flicker, judder and shuffled frames move them where per-frame
    features do not. videos: (B, T, H, W, 3). Returns (B (T - 1), D)."""
    diffs = (videos[:, 1:] - videos[:, :-1]) * 0.5
    return vgg_features(lpips, diffs.reshape((-1,) + tuple(diffs.shape[2:])),
                        max_dim)


def _frames(clips: torch.Tensor) -> torch.Tensor:
    return clips.reshape((-1,) + tuple(clips.shape[2:]))


def make_fd_video_features(lpips) -> Tuple[Callable, Callable]:
    """Fréchet distances over many batches: (feats, finalize), where
    feats(real, fake) gives one batch's per-frame and motion features of
    (B, T, H, W, 3) clips, and finalize(list of those) the distances
    `fd_vgg` and `fd_vgg_motion` over all of them at once (the statistics
    of one batch alone vary more)."""
    trunk = float32_trunk(lpips)

    def feats(real: torch.Tensor, fake: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {
            "frame_real": vgg_features(trunk, _frames(real)),
            "frame_fake": vgg_features(trunk, _frames(fake)),
            "motion_real": motion_features(trunk, real),
            "motion_fake": motion_features(trunk, fake),
        }

    def finalize(chunks) -> Dict[str, torch.Tensor]:
        cat = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        return {
            "fd_vgg": fid(cat["frame_real"], cat["frame_fake"]),
            "fd_vgg_motion": fid(cat["motion_real"], cat["motion_fake"]),
        }

    return feats, finalize


def make_fd_video(lpips) -> Callable:
    """fd(real, fake) on (B, T, H, W, 3) clips in [-1, 1] -> {"fd_vgg":
    the per-frame appearance distance, "fd_vgg_motion": the
    frame-difference distance}: `make_fd_video_features` over one
    batch."""
    feats, finalize = make_fd_video_features(lpips)

    def fd(real: torch.Tensor, fake: torch.Tensor) -> Dict[str, torch.Tensor]:
        return finalize([feats(real, fake)])

    return fd
