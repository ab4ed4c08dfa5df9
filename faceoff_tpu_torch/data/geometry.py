"""Host-side landmark geometry for the training items, counterpart of the
part of `faceoff_tpu/data/geometry.py` that they use, without OpenCV.

The JAX package resamples with cv2. Here the same functions run as torch
CPU ops on uint8 images, following what the installed OpenCV computes:

  * `warp_affine` and `remap` (bilinear, constant-0 border): the source
    position in float32, the two linear blends and the final blend in
    float32, rounded half to even to uint8.
  * `resize` with "linear": cv2's fixed-point path, 11-bit weights, the
    horizontal sums kept as integers, the vertical blend on the sums
    shifted right by 4 with 16-bit weight products, then (v + 2) >> 2.
  * `resize` with "cubic": Keys' kernel with A = -0.75 (cv2's and torch's
    bicubic constant), weights in float32, the sums in float64, edges
    replicated, rounded half to even.

Integer translations and same-size resizes are exact copies. Elsewhere
the results can differ from cv2's by one level where a float32 rounding
lands on the other side of a half.

`convex_hull_mask` reproduces cv2's `convexHull` + `fillConvexPoly` for
integer vertices: the scanline fill with 16.16 fixed-point edges and the
8-connected Bresenham lines drawn along every edge.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from faceoff_tpu_torch.ops.warp import umeyama_similarity  # noqa: F401

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


# -- resampling ------------------------------------------------------------


def _as_hwc(image: np.ndarray) -> Tuple[torch.Tensor, bool]:
    """uint8 (H, W) or (H, W, C) -> a float32 (H + 2, W + 2, C) tensor with
    a border of zeros, and whether the input had no channel axis."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {img.dtype}")
    flat = img.ndim == 2
    t = torch.from_numpy(np.ascontiguousarray(img))
    if flat:
        t = t[..., None]
    return torch.nn.functional.pad(t.to(torch.float32), (0, 0, 1, 1, 1, 1)), flat


def _to_uint8(v: torch.Tensor, flat: bool) -> np.ndarray:
    out = torch.round(v).clamp_(0, 255).to(torch.uint8)
    return (out[..., 0] if flat else out).numpy()


def _bilinear(padded: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
              flat: bool) -> np.ndarray:
    """Blend the four taps around float32 positions (sx, sy) of a
    zero-bordered image; taps outside the image read 0."""
    hp, wp = padded.shape[:2]
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    a = (sx - x0f)[..., None]
    b = (sy - y0f)[..., None]
    # +1 for the border; every tap beyond it lands on the zero border
    x0 = (x0f.clamp(-2, wp) + 1).long()
    y0 = (y0f.clamp(-2, hp) + 1).long()

    def tap(yy, xx):
        return padded[yy.clamp(0, hp - 1), xx.clamp(0, wp - 1)]

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    v0 = p00 + a * (p01 - p00)
    v1 = p10 + a * (p11 - p10)
    return _to_uint8(v0 + b * (v1 - v0), flat)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's `invertAffineTransform` in float64."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(image: np.ndarray, M: np.ndarray,
                out_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Apply the 2x3 affine `M` (source -> output) to a uint8 image with
    bilinear sampling and zeros outside, as `cv2.warpAffine`. out_size is
    (height, width), the input's by default."""
    h, w = np.asarray(image).shape[:2]
    oh, ow = out_size if out_size is not None else (h, w)
    inv = torch.from_numpy(_invert_affine(M).astype(np.float32))
    x = torch.arange(ow, dtype=torch.float32)[None, :]
    y = torch.arange(oh, dtype=torch.float32)[:, None]
    sx = x * inv[0] + (y * inv[1] + inv[2])
    sy = x * inv[3] + (y * inv[4] + inv[5])
    padded, flat = _as_hwc(image)
    return _bilinear(padded, sx, sy, flat)


def remap(image: np.ndarray, map_x: np.ndarray,
          map_y: np.ndarray) -> np.ndarray:
    """Sample a uint8 image at float32 positions (map_x, map_y) with
    bilinear weights and zeros outside, as `cv2.remap` with INTER_LINEAR
    and a constant-0 border."""
    padded, flat = _as_hwc(image)
    sx = torch.from_numpy(np.asarray(map_x, np.float32))
    sy = torch.from_numpy(np.asarray(map_y, np.float32))
    return _bilinear(padded, sx, sy, flat)


def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """Keys' cubic weights (A = -0.75) of the four taps, in float32."""
    a = np.float32(-0.75)
    x = f.astype(np.float32)
    one = np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1).astype(np.float32)


def _axis_taps(n_src: int, n_dst: int, scale: float,
               interpolation: str) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (n_dst, k) and weights (n_dst, k) of one axis:
    half-pixel centres, edges replicated."""
    pos = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    start = np.floor(pos).astype(np.int64)
    frac = (pos - start).astype(np.float32)
    if interpolation == "linear":
        low = start < 0
        frac[low], start[low] = 0, 0
        high = start >= n_src - 1
        frac[high], start[high] = 0, n_src - 1
        weights = np.stack([np.float32(1) - frac, frac], -1)
        offsets = np.arange(2)
    else:
        weights = _cubic_weights(frac)
        offsets = np.arange(-1, 3)
    idx = np.clip(start[:, None] + offsets[None, :], 0, n_src - 1)
    return idx, weights


def resize(image: np.ndarray, size: Optional[Tuple[int, int]] = None, *,
           fx: Optional[float] = None, fy: Optional[float] = None,
           interpolation: str = "linear") -> np.ndarray:
    """Resize a uint8 image as `cv2.resize`: to `size` = (width, height),
    or by factors fx/fy (the output size rounded from them, the sampling
    scale their inverse). interpolation is "linear" or "cubic"."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    if size is not None:
        ow, oh = size
        sx, sy = w / ow, h / oh
    else:
        ow, oh = int(np.rint(w * fx)), int(np.rint(h * fy))
        sx, sy = 1.0 / fx, 1.0 / fy
    if (oh, ow) == (h, w) and sx == 1.0 and sy == 1.0:
        return img.copy()
    if interpolation not in ("linear", "cubic"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    flat = img.ndim == 2
    src = torch.from_numpy(np.ascontiguousarray(img))
    if flat:
        src = src[..., None]
    ix, wx = _axis_taps(w, ow, sx, interpolation)
    iy, wy = _axis_taps(h, oh, sy, interpolation)
    ix, iy = torch.from_numpy(ix), torch.from_numpy(iy)
    if interpolation == "linear":
        # cv2's fixed point: 11-bit weights, integer row sums, then the
        # vertical blend of the sums >> 4 with 16-bit products
        cx = torch.from_numpy(np.rint(wx * 2048).astype(np.int64))
        cy = torch.from_numpy(np.rint(wy * 2048).astype(np.int64))
        rows = (src[:, ix].to(torch.int64) * cx[None, :, :, None]).sum(2)
        r0 = rows[iy[:, 0]] >> 4
        r1 = rows[iy[:, 1]] >> 4
        v = ((r0 * cy[:, 0, None, None]) >> 16) + (
            (r1 * cy[:, 1, None, None]) >> 16)
        out = ((v + 2) >> 2).clamp_(0, 255).to(torch.uint8)
    else:
        cx = torch.from_numpy(wx.astype(np.float64))
        cy = torch.from_numpy(wy.astype(np.float64))
        rows = (src[:, ix].to(torch.float64) * cx[None, :, :, None]).sum(2)
        v = (rows[iy] * cy[:, :, None, None]).sum(1)
        out = torch.round(v).clamp_(0, 255).to(torch.uint8)
    out = out.numpy()
    return out[..., 0] if flat else out


def resize_frame(frame: np.ndarray, resize_dim: int = 256) -> np.ndarray:
    """Pad to a square with zeros, then resize bilinearly to
    resize_dim x resize_dim (the identity at that size already)."""
    h, w = frame.shape[:2]
    if h > w:
        padw, padh = (h - w) // 2, 0
    else:
        padw, padh = 0, (w - h) // 2
    pad = [(padh, padh), (padw, padw)] + [(0, 0)] * (frame.ndim - 2)
    padded = np.pad(frame, pad)
    return resize(padded, (resize_dim, resize_dim), interpolation="linear")


# -- masks ------------------------------------------------------------------


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Vertices (M, 2) int64 of the convex hull of integer points (N, 2),
    without collinear or repeated points (Andrew's monotone chain)."""
    pts = sorted({(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)})
    if len(pts) < 3:
        return np.asarray(pts, np.int64).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def _clip_line(w: int, h: int, p0, p1):
    """cv2's `clipLine`: the segment p0-p1 cut to the w x h image, or None
    where it misses the image."""
    (x1, y1), (x2, y2) = p0, p1
    right, bottom = w - 1, h - 1

    def code(x, y, with_y=True):
        c = (x < 0) + (x > right) * 2
        return c + ((y < 0) * 4 + (y > bottom) * 8 if with_y else 0)

    def trunc(v: float) -> int:  # C's cast of a double: toward zero
        return int(v)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += trunc(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += trunc(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += trunc(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += trunc(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _draw_line(mask: np.ndarray, p0, p1, value) -> None:
    """cv2's 8-connected line from p0 to p1 (clipped to the mask, then
    drawn left to right)."""
    h, w = mask.shape[:2]
    clipped = _clip_line(w, h, p0, p1)
    if clipped is None:
        return
    (x0, y0), (x1, y1) = clipped
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    for _ in range(major + 1):
        mask[y, x] = value
        step = err < 0
        err += -2 * minor + (2 * major if step else 0)
        if steep:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0


def fill_convex_poly(mask: np.ndarray, vertices: np.ndarray, value) -> None:
    """cv2's `fillConvexPoly` (8-connected, shift 0) in place: the edges
    drawn as lines, then the rows between the left and right edges
    filled, with edges stepped in 16.16 fixed point."""
    v = [(int(x), int(y)) for x, y in np.asarray(vertices).reshape(-1, 2)]
    npts = len(v)
    if npts == 0:
        return
    h, w = mask.shape[:2]
    for i in range(npts):
        _draw_line(mask, v[i - 1], v[i], value)
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    ymin, ymax = min(ys), max(ys)
    imin = ys.index(ymin)
    if npts < 3 or max(xs) < 0 or ymax < 0 or min(xs) >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    half = _XY_ONE >> 1
    # per edge: [idx, di, x, dx, ye]
    edges = [[imin, 1, -_XY_ONE, 0, ymin], [imin, npts - 1, -_XY_ONE, 0, ymin]]
    remaining = npts
    y = ymin
    while True:
        for e in edges:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % npts
                while remaining > 0:
                    remaining -= 1
                    ty = v[idx][1]
                    if ty > y:
                        xs0 = v[idx0][0] << _XY_SHIFT
                        xe = v[idx][0] << _XY_SHIFT
                        e[4] = ty
                        num = (xe - xs0) * 2 + (ty - y)
                        den = 2 * (ty - y)
                        # integer division toward zero, as C's
                        e[3] = abs(num) // den * (1 if num >= 0 else -1)
                        e[2] = xs0
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
                else:
                    remaining -= 1
        if remaining < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edges[0][2] > edges[1][2] else (0, 1)
            xx1 = (edges[left][2] + half) >> _XY_SHIFT
            xx2 = (edges[right][2] + half) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                mask[y, max(xx1, 0): min(xx2, w - 1) + 1] = value
        edges[0][2] += edges[0][3]
        edges[1][2] += edges[1][3]
        y += 1
        if y > ymax:
            break


def convex_hull_mask(shape: Tuple[int, ...], points: np.ndarray) -> np.ndarray:
    """The filled convex hull of landmark points as a uint8 {0, 255} mask
    of `shape` (H, W) or (H, W, C); points are truncated to integers
    first, as the JAX package does."""
    pts = np.asarray(points).astype(np.int32).reshape(-1, 2)
    mask = np.zeros(shape[:2], np.uint8)
    fill_convex_poly(mask, convex_hull(pts), 255)
    if len(shape) == 3:
        mask = np.repeat(mask[..., None], shape[2], axis=2)
    return mask


def bounding_box_mask(shape: Tuple[int, ...], points: np.ndarray) -> np.ndarray:
    """The axis-aligned bounding box of the points as a uint8 {0, 255}
    mask of `shape` (the `use_bb_mask` variant)."""
    pts = np.asarray(points)
    x1, y1 = np.floor(pts.min(axis=0)).astype(int)
    x2, y2 = np.ceil(pts.max(axis=0)).astype(int)
    mask = np.zeros(shape, np.uint8)
    h, w = shape[:2]
    mask[max(y1, 0): min(y2, h), max(x1, 0): min(x2, w)] = 255
    return mask


def apply_mask(mask: np.ndarray, image: np.ndarray) -> np.ndarray:
    """(mask / 255) * image as uint8."""
    return ((mask / 255.0) * image).astype(np.uint8)


def rotation_matrix(center: Sequence[float], angle_deg: float,
                    scale: float) -> np.ndarray:
    """cv2's `getRotationMatrix2D`: the 2x3 rotation by angle_deg
    (counter-clockwise on screen) about `center`, whose coordinates cv2
    takes as float32."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = np.deg2rad(angle_deg)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])
