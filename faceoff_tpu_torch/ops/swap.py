"""Cross-identity swap preparation on the device (plain torch around the
warp kernel).

Counterpart of `faceoff_tpu/ops/swap.py`: hull mask, Umeyama similarity on
the five stable landmarks, one batched warp (K4 on the card), and the naive
composite, a paste or the iterative Laplacian (Poisson) blend, for a whole
batch at once.

`poisson_blend` repeats the JAX package's explicit iteration as it is,
float32 without a clip inside the loop. Its step is unstable where the
mask exceeds about 0.73 (the stencil's most negative eigenvalue is about
-11, so |1 - 0.25 * 11 * mask| > 1 there): the values grow without bound,
and at the default 1024 iterations they overflow to inf and NaN in both
packages (ROADMAP.md, Queue 3). The port keeps that behaviour so that it
stays comparable with the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from faceoff_tpu_torch.ops import warp as W

STABLE_POINTS = (33, 36, 39, 42, 45)
# the same points as a strided slice: indexing with a list would copy an
# index tensor from the host on every call
_STABLE = slice(33, 46, 3)
assert tuple(range(68)[_STABLE]) == STABLE_POINTS


def _laplace3(x: torch.Tensor) -> torch.Tensor:
    """The discrete Laplacian over the last three axes (H, W, C), the edge
    repeated (scipy's "reflect", numpy's "symmetric" at width 1): the six
    neighbours added in the JAX package's order, then 6 x subtracted."""
    shape = x.shape
    p = F.pad(x.reshape((-1,) + tuple(shape[-3:])), (1, 1, 1, 1, 1, 1),
              mode="replicate").reshape(tuple(shape[:-3]) + tuple(
                  d + 2 for d in shape[-3:]))
    return (
        p[..., :-2, 1:-1, 1:-1] + p[..., 2:, 1:-1, 1:-1]
        + p[..., 1:-1, :-2, 1:-1] + p[..., 1:-1, 2:, 1:-1]
        + p[..., 1:-1, 1:-1, :-2] + p[..., 1:-1, 1:-1, 2:]
        - 6.0 * x
    )


def poisson_blend(target: torch.Tensor, src: torch.Tensor, mask: torch.Tensor,
                  iters: int = 1024) -> torch.Tensor:
    """`iters` explicit steps out += 0.25 mask laplace3(out - src) from
    the target, then one clip to [0, 1]. Float images in [0, 1] of shape
    (..., H, W, C); the swap passes the warped face image as `mask`."""
    out = target.to(torch.float32)
    step = 0.25 * mask
    for _ in range(iters):
        out = out + step * _laplace3(out - src)
    return out.clamp(0.0, 1.0)


def prepare_swap_batch(
    src_frames: torch.Tensor,
    src_landmarks: torch.Tensor,
    tgt_frames: torch.Tensor,
    tgt_landmarks: torch.Tensor,
    *,
    hull_start: int = 17,
    hull_end: int = 67,
    enlargement: int = 10,
    poisson: bool = False,
    poisson_iters: int = 1024,
) -> Dict[str, torch.Tensor]:
    """Batched source -> target face transfer (the inference path).

    src/tgt_frames: (N, H, W, 3) uint8 or float in [0, 255];
    src/tgt_landmarks: (N, 68, 2) pixel coords in those frames.

    Returns (all float32 in [-1, 1]):
      input:      (N, H, W, 6) — warped source face || target background
      source:     (N, H, W, 3) warped source face
      background: (N, H, W, 3) target without its face features
      combined:   (N, H, W, 3) naive composite: the paste, or with
                  `poisson` the Laplacian blend of the (unwarped) source
                  into the target modulated by the warped face
    """
    h, w = src_frames.shape[1:3]
    src01 = src_frames.to(torch.float32) / 255.0
    tgt01 = tgt_frames.to(torch.float32) / 255.0
    s_lms = src_landmarks.to(torch.float32)
    t_lms = tgt_landmarks.to(torch.float32)
    enlarge = float(enlargement)

    # enlarged no-jaw hull segments the source face
    s_mask = W.convex_mask(s_lms[:, hull_start:hull_end], h, w, enlarge=enlarge)
    faces = src01 * s_mask[..., None]
    ms = W.umeyama_similarity(s_lms[:, _STABLE], t_lms[:, _STABLE])
    source = W.affine_warp(faces.contiguous(), ms)

    # target with its face features removed (same enlarged no-jaw hull)
    t_mask = W.convex_mask(t_lms[:, hull_start:hull_end], h, w, enlarge=enlarge)
    background = tgt01 * (1.0 - t_mask)[..., None]
    if poisson:
        combined = poisson_blend(tgt01, src01, source, iters=poisson_iters)
    else:
        # naive paste: zero the target where the warped face has content
        t_mask_full = W.convex_mask(t_lms, h, w)
        has_face = (source.sum(dim=-1, keepdim=True) > 0).to(torch.float32)
        combined = (
            tgt01 * (1.0 - t_mask_full)[..., None] * (1.0 - has_face) + source
        )

    def to_pm1(x):
        return x.clamp(0.0, 1.0) * 2.0 - 1.0

    source = to_pm1(source)
    background = to_pm1(background)
    return {
        "input": torch.cat([source, background], dim=-1),
        "source": source,
        "background": background,
        "combined": to_pm1(combined),
    }
