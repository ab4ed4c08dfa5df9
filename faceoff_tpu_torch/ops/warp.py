"""Batched image warping, perturbation and landmark geometry.

Counterpart of `faceoff_tpu/ops/warp.py`: the bilinear resample, affine
helpers and grids, the radial and arc distortion grids, the composite
training perturbation (`perturb_clip`), convex-hull masks and the Umeyama
similarity. Coordinates are (x, y) pixel positions; images are
channels-last (N, H, W, C). Where the JAX package builds one 2x3 affine
per call and vmaps, the helpers here take leading batch dimensions.

`batched_bilinear_warp` routes a CUDA tensor to the hand-written kernels
(`ops/warp_cuda.py`, `csrc/warp.cu`; the backward is a kernel too) and a
CPU tensor to the plain `_bilinear_sample` beside it, which is also the
kernels' reference, through autograd for the backward.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from faceoff_tpu_torch.ops import warp_cuda


def _bilinear_sample(
    imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
) -> torch.Tensor:
    """Sample imgs (N, H, W, C) at float coords xs/ys (N, OH, OW).

    Each of the four taps is zero outside the image, tested on the tap's
    own position (so x = -0.5 still blends half of column 0). Returns
    (N, OH, OW, C) in the image dtype.
    """
    n, h, w = imgs.shape[:3]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    dx = (xs - x0)[..., None]
    dy = (ys - y0)[..., None]
    batch = torch.arange(n, device=imgs.device).view(n, 1, 1)

    def gather(xi, yi):
        # a NaN coordinate (a singular affine) reads column 0, then 0
        xi_c = torch.nan_to_num(xi).clamp(0, w - 1).long()
        yi_c = torch.nan_to_num(yi).clamp(0, h - 1).long()
        val = imgs[batch, yi_c, xi_c]
        inside = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))
        return val * inside[..., None]

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


def batched_bilinear_warp(
    imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
) -> torch.Tensor:
    """Bilinear sample of imgs (N, H, W, C) at xs/ys (N, OH, OW); zeros
    outside; differentiable in all three. A CPU tensor takes the plain
    version; any other device goes to the CUDA kernels, which raise on
    what they cannot take."""
    if imgs.device.type == "cpu":
        return _bilinear_sample(imgs, xs, ys)
    return warp_cuda.BilinearWarp.apply(imgs, xs, ys)


def identity_grid(
    h: int, w: int, device: Optional[torch.device] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) sampling grids of shape (h, w), float32."""
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return x.expand(h, w), y.expand(h, w)


def affine_grid(
    m_inv: torch.Tensor, h: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source-coordinate grids for affines m_inv (..., 2, 3) mapping
    dest -> src: returns (xs, ys), each (..., h, w)."""
    x, y = identity_grid(h, w, m_inv.device)
    m = m_inv[..., None, None]  # (..., 2, 3, 1, 1) against (h, w)
    xs = m[..., 0, 0, :, :] * x + m[..., 0, 1, :, :] * y + m[..., 0, 2, :, :]
    ys = m[..., 1, 0, :, :] * x + m[..., 1, 1, :, :] * y + m[..., 1, 2, :, :]
    return xs, ys


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert 2x3 affines (..., 2, 3) in closed form."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack(
        [torch.stack([ia, ib, itx], -1), torch.stack([ic, id_, ity], -1)],
        -2,
    )


def affine_warp(images: torch.Tensor, matrices: torch.Tensor) -> torch.Tensor:
    """Batched cv2.warpAffine equivalent.

    images: (N, H, W, C); matrices: (N, 2, 3) forward dest<-src affines
    (dest(x) = sample at M^{-1} x).
    """
    h, w = images.shape[1:3]
    xs, ys = affine_grid(invert_affine(matrices), h, w)
    return batched_bilinear_warp(images, xs.contiguous(), ys.contiguous())


def _radians(deg: torch.Tensor) -> torch.Tensor:
    return deg * (math.pi / 180.0)


def _affine(rows) -> torch.Tensor:
    """Stack [[a, b, c], [d, e, f]] of broadcastable tensors into
    (..., 2, 3)."""
    top, bot = (torch.broadcast_tensors(*r) for r in rows)
    return torch.stack([torch.stack(top, -1), torch.stack(bot, -1)], -2)


def rotation_about(
    angle_deg: torch.Tensor, center: torch.Tensor,
    scale: Union[float, torch.Tensor] = 1.0,
) -> torch.Tensor:
    """cv2.getRotationMatrix2D: angle_deg (...,) counter-clockwise about
    center (..., 2) (x, y) -> (..., 2, 3)."""
    a = _radians(angle_deg)
    alpha = torch.cos(a) * scale
    beta = torch.sin(a) * scale
    cx, cy = center[..., 0], center[..., 1]
    return _affine([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ])


def translation(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Shift by (dx, dy), each (...,) -> (..., 2, 3)."""
    one, zero = torch.ones_like(dx), torch.zeros_like(dx)
    return _affine([[one, zero, dx], [zero, one, dy]])


def scale_about_center(s: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zoom by s (...,) about the centre of an (h, w) canvas."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    zero = torch.zeros_like(s)
    return _affine([[s, zero, cx * (1 - s)], [zero, s, cy * (1 - s)]])


def compose_affine(m2: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """Affine composition (..., 2, 3): apply m1, then m2."""
    a = m2[..., :2] @ m1[..., :2]
    t = (m2[..., :2] @ m1[..., 2:3])[..., 0] + m2[..., 2]
    return torch.cat([a, t[..., None]], dim=-1)


def barrel_grid(
    h: int, w: int, a, b, c, d, inverse: bool = False,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radial distortion sampling grids (ImageMagick barrel convention):
    coefficients are floats or (...,) tensors; returns (xs, ys), each
    (..., h, w)."""
    x, y = identity_grid(h, w, device)
    a, b, c, d = (torch.as_tensor(v, dtype=torch.float32, device=device)
                  [..., None, None] for v in (a, b, c, d))
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    norm = min(cx, cy)
    dx = (x - cx) / norm
    dy = (y - cy) / norm
    r = torch.sqrt(dx * dx + dy * dy)
    poly = a * r ** 3 + b * r ** 2 + c * r + d
    scale = 1.0 / torch.clamp_min(poly, 1e-6) if inverse else poly
    scale = torch.where(r > 1e-8, scale, torch.ones_like(scale))
    return cx + dx * scale * norm, cy + dy * scale * norm


def arc_grid(
    h: int, w: int, angle_deg: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sampling grids bending the image onto an annulus spanning
    angle_deg (...,) (ImageMagick 'arc'). Returns (xs, ys, valid), each
    (..., h, w); pixels outside the annulus are invalid."""
    angle = _radians(torch.clamp_min(angle_deg.to(torch.float32), 1e-3))
    angle = angle[..., None, None]
    r_outer = w / angle
    r_inner = torch.clamp_min(r_outer - h, 0.0)
    cx = (w - 1) / 2.0
    x, y = identity_grid(h, w, angle.device)
    dx = x - cx
    dy = r_outer - y  # the circle's centre sits r_outer above the top edge
    r = torch.sqrt(dx * dx + dy * dy)
    theta = torch.atan2(dx, dy)
    xs = (theta / angle + 0.5) * (w - 1)
    ys = (r_outer - r) / torch.clamp_min(r_outer - r_inner, 1e-6) * (h - 1)
    valid = (torch.abs(theta) <= angle / 2) & (r >= r_inner) & (r <= r_outer)
    return xs, ys, valid


def warp_with_grid(
    img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
) -> torch.Tensor:
    """Bilinear sample of imgs (N, H, W, C) at xs/ys (N, OH, OW):
    `batched_bilinear_warp`, the warp kernel on the card."""
    return batched_bilinear_warp(img, xs, ys)


def draw_perturbation(
    generator: torch.Generator,
    t: int,
    *,
    translation_range: int = 3,
    rotation_range: float = 3.0,
    scale_range: Tuple[int, int] = (90, 110),
) -> Dict[str, torch.Tensor]:
    """Draw the parameters of `perturb_clip` for t frames, independent per
    frame, on the generator's device, from the reference's distribution:

      subset   uniform over the 31 non-empty subsets of {translate-x,
               translate-y, rotate about the eyes, scale, distort}
               (bit k of the integer in [1, 32) enables member k);
      tx, ty   integer pixels in [-3, 3]; rot integer degrees in [-3, 3];
      scale    integer percent in [90, 110], as a factor;
      kind     the distortion: 0 arc, 1 barrel, 2 inverse barrel;
      arc_angle integer degrees in [0, 30]; barrel a, b, c in tenths of
               [0, 10], [2, 7], [0, 5]; inverse barrel (b, c) in tenths of
               [0, 2] x [-5, 0].

    The draw cannot replay JAX's PRNG; `perturbation_grids` turns the
    same parameters into the same grids as the JAX package.
    """
    dev = generator.device

    def ints(lo, hi, shape=(t,)):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    tr, rr = translation_range, int(rotation_range)
    return {
        "subset": ints(1, 32),
        "tx": ints(-tr, tr + 1).float(),
        "ty": ints(-tr, tr + 1).float(),
        "rot": ints(-rr, rr + 1).float(),
        "scale": ints(scale_range[0], scale_range[1] + 1).float() / 100.0,
        "kind": ints(0, 3),
        "arc_angle": ints(0, 31).float(),
        "barrel_a": ints(0, 11).float() / 10,
        "barrel_b": ints(2, 8).float() / 10,
        "barrel_c": ints(0, 6).float() / 10,
        "inverse_bc": torch.stack([ints(0, 3), ints(-5, 1)], -1).float() / 10,
    }


def perturbation_grids(
    params: Dict[str, torch.Tensor], h: int, w: int, eyes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The composite perturbation's sampling grids for t frames, the
    arithmetic of the JAX package's `perturb_clip` grid build: the affine
    stack translate > rotate about the eye centre > zoom, inverted in
    closed form and evaluated at the distortion stage's coordinates
    (dest -> distortion -> affine^-1 -> source), with coordinates that
    leave the image at the distortion stage masked black.

    params: `draw_perturbation`'s dict; eyes (t, 2). Returns
    (xs, ys, valid), each (t, h, w).
    """
    dev = eyes.device
    p = {k: v.to(dev) for k, v in params.items()}
    en = [((p["subset"] >> k) & 1).bool() for k in range(5)]
    zero = torch.zeros_like(p["tx"])
    dx = torch.where(en[0], p["tx"], zero)
    dy = torch.where(en[1], p["ty"], zero)
    ang = torch.where(en[2], p["rot"], zero)
    s = torch.where(en[3], p["scale"], torch.ones_like(zero))

    m = translation(dx, dy)
    m = compose_affine(rotation_about(ang, eyes.to(torch.float32)), m)
    m = compose_affine(scale_about_center(s, h, w), m)
    minv = invert_affine(m)[..., None, None]  # (t, 2, 3, 1, 1)

    bxs, bys = barrel_grid(h, w, p["barrel_a"], p["barrel_b"], p["barrel_c"],
                           1.0, device=dev)
    ixs, iys = barrel_grid(h, w, 0.0, p["inverse_bc"][:, 0],
                           p["inverse_bc"][:, 1], 1.0, inverse=True,
                           device=dev)
    axs, ays, a_valid = arc_grid(h, w, p["arc_angle"])
    xi, yi = identity_grid(h, w, dev)
    kind = p["kind"][:, None, None]
    xs_d = torch.where(kind == 0, axs, torch.where(kind == 1, bxs, ixs))
    ys_d = torch.where(kind == 0, ays, torch.where(kind == 1, bys, iys))
    valid = torch.where(kind == 0, a_valid, True)
    valid = valid & (xs_d >= 0) & (xs_d <= w - 1) & (ys_d >= 0) & (ys_d <= h - 1)
    en_d = en[4][:, None, None]
    xs_d = torch.where(en_d, xs_d, xi)
    ys_d = torch.where(en_d, ys_d, yi)
    valid = torch.where(en_d, valid, True)

    xs = minv[:, 0, 0] * xs_d + minv[:, 0, 1] * ys_d + minv[:, 0, 2]
    ys = minv[:, 1, 0] * xs_d + minv[:, 1, 1] * ys_d + minv[:, 1, 2]
    return xs, ys, valid


def perturb_clip(
    generator: Optional[torch.Generator],
    faces: torch.Tensor,
    eye_centers: torch.Tensor,
    *,
    translation_range: int = 3,
    rotation_range: float = 3.0,
    scale_range: Tuple[int, int] = (90, 110),
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Composite random perturbation of t frames, faces (t, H, W, C) float
    with eye_centers (t, 2): parameters from `draw_perturbation` (or
    `params`), grids from `perturbation_grids`, then ONE batched warp of
    all frames (`batched_bilinear_warp`, the warp kernel on the card)."""
    t, h, w = faces.shape[:3]
    if params is None:
        params = draw_perturbation(
            generator, t, translation_range=translation_range,
            rotation_range=rotation_range, scale_range=scale_range)
    xs, ys, valid = perturbation_grids(params, h, w, eye_centers)
    out = batched_bilinear_warp(faces, xs.contiguous(), ys.contiguous())
    return out * valid[..., None]


# the most bytes of booleans one chunk of convex_mask's directions makes
MASK_CHUNK_BYTES = 1 << 28


def convex_mask(
    points: torch.Tensor,
    h: int,
    w: int,
    n_directions: int = 128,
    enlarge: float = 0.0,
) -> torch.Tensor:
    """Rasterize the convex hull of `points` (..., P, 2) as (..., h, w)
    float32 masks.

    Support-function test: q is inside iff d.q <= max_i d.p_i + 0.5 for
    `n_directions` directions d; `enlarge` grows the hull by that many
    pixels (Minkowski sum with an L2 ball). The directions are tested in
    chunks, so that the comparisons' booleans, (..., h*w, chunk), stay
    within MASK_CHUNK_BYTES whatever the number and size of the frames
    (all 128 at once took 1 GiB at 32 frames of 512x512).
    """
    pts = points.to(torch.float32)
    k = n_directions
    ang = torch.arange(k, dtype=torch.float32, device=pts.device) * (
        2 * math.pi / k
    )
    cos, sin = torch.cos(ang), torch.sin(ang)  # (K,)
    # d.p and d.q as elementwise products, not matmuls: each value is then
    # rounded the same way whatever the batch, so a frame's mask does not
    # depend on which frames it was batched with
    proj = pts[..., 0:1] * cos + pts[..., 1:2] * sin  # (..., P, K)
    support = proj.amax(dim=-2) + enlarge  # (..., K)
    x, y = identity_grid(h, w, pts.device)
    dq = x.reshape(-1, 1) * cos + y.reshape(-1, 1) * sin  # (H*W, K)
    bound = support[..., None, :] + 0.5  # (..., 1, K)
    chunk = max(1, MASK_CHUNK_BYTES // max(1, bound[..., 0].numel() * h * w))
    inside = None
    for k0 in range(0, k, chunk):
        part = torch.all(dq[:, k0:k0 + chunk] <= bound[..., k0:k0 + chunk],
                         dim=-1)
        inside = part if inside is None else inside & part
    return inside.reshape(tuple(pts.shape[:-2]) + (h, w)).to(torch.float32)


def umeyama_similarity(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity (rotation + scale + translation) mapping
    src points (..., P, 2) onto dst, as (..., 2, 3) affines.

    Same function as the SVD form of the JAX package, in closed form for
    2-D: with cov = dst_c^T src_c / P, alpha = (cov00 + cov11) / 2 and
    beta = (cov10 - cov01) / 2, the optimal proper rotation has angle
    atan2(beta, alpha) and the scale is 2 sqrt(alpha^2 + beta^2) / var_src,
    so scale * R = 2 / var_src * [[alpha, -beta], [beta, alpha]]. It needs
    no SVD, so it stays a few elementwise ops on the device.
    """
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    n = src.shape[-2]
    mu_s = src.mean(dim=-2, keepdim=True)
    mu_d = dst.mean(dim=-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.transpose(-1, -2) @ sc / n  # (..., 2, 2)
    alpha = 0.5 * (cov[..., 0, 0] + cov[..., 1, 1])
    beta = 0.5 * (cov[..., 1, 0] - cov[..., 0, 1])
    var_s = (sc * sc).sum(dim=(-1, -2)) / n
    k = 2.0 / var_s.clamp_min(1e-8)
    a, b = k * alpha, k * beta
    sr = torch.stack(
        [torch.stack([a, -b], -1), torch.stack([b, a], -1)], -2
    )  # (..., 2, 2)
    t = mu_d.squeeze(-2) - (sr @ mu_s.transpose(-1, -2)).squeeze(-1)
    return torch.cat([sr, t[..., None]], dim=-1)
