"""Host-side landmark geometry of the training items and of the swap,
counterpart of `faceoff_tpu/data/geometry.py`, without OpenCV.

The JAX package resamples and draws with cv2. Here the same functions run
as numpy and torch CPU ops on uint8 images, following what the installed
OpenCV computes:

  * `warp_affine` and `remap` (bilinear, constant-0 border): the source
    position in float32, the two linear blends and the final blend in
    float32, rounded half to even to uint8.
  * `warp_affine` with "cubic" (INTER_CUBIC, constant-0 border): the same
    float32 positions, Keys' weights (A = -0.75) of the fractions in
    float32, each row of four taps summed in float32, then the rows.
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
8-connected Bresenham lines drawn along every edge. `enlarge_mask`
reproduces cv2's thick contour (`drawContours` with a thickness): per
hull segment a quadrilateral with 16.16 fixed-point corners, filled by
the same rule, and a round cap by cv2's integer circle.

The swap's host path (`generate_warped_image`, `generate_aligned_image`,
`poisson_blend`) is the JAX package's, float64 where it computes in
float64 (the Umeyama fit, the Poisson iteration).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from faceoff_tpu_torch.ops.swap import STABLE_POINTS

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


def _bicubic(image: np.ndarray, sx: torch.Tensor,
             sy: torch.Tensor) -> np.ndarray:
    """Keys' cubic (A = -0.75) over the 4x4 taps around float32 positions
    (sx, sy) of a uint8 image, taps outside the image reading 0: float32
    weights of the fractions, each row's horizontal sum in float32, then
    the rows' weighted sum, rounded half to even."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {img.dtype}")
    flat = img.ndim == 2
    t = torch.from_numpy(np.ascontiguousarray(img))
    if flat:
        t = t[..., None]
    padded = torch.nn.functional.pad(t.to(torch.float32), (0, 0, 2, 2, 2, 2))
    hp, wp = padded.shape[:2]
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    wx = torch.from_numpy(_cubic_weights((sx - x0f).numpy()))
    wy = torch.from_numpy(_cubic_weights((sy - y0f).numpy()))
    # tap j of x0 - 1 .. x0 + 2 sits at x0 + 1 + j in the padded image;
    # every tap beyond the border of 2 lands on it
    x0 = x0f.clamp(-8, wp + 8).long() + 1
    y0 = y0f.clamp(-8, hp + 8).long() + 1
    out = torch.zeros(tuple(sx.shape) + (padded.shape[2],))
    for i in range(4):
        yy = (y0 + i).clamp(0, hp - 1)
        row = torch.zeros_like(out)
        for j in range(4):
            row = row + padded[yy, (x0 + j).clamp(0, wp - 1)] * wx[..., j, None]
        out = out + row * wy[..., i, None]
    return _to_uint8(out, flat)


def warp_affine(image: np.ndarray, M: np.ndarray,
                out_size: Optional[Tuple[int, int]] = None,
                interpolation: str = "linear") -> np.ndarray:
    """Apply the 2x3 affine `M` (source -> output) to a uint8 image with
    zeros outside, as `cv2.warpAffine`: "linear" (bilinear) or "cubic"
    (INTER_CUBIC). out_size is (height, width), the input's by
    default."""
    h, w = np.asarray(image).shape[:2]
    oh, ow = out_size if out_size is not None else (h, w)
    inv = torch.from_numpy(_invert_affine(M).astype(np.float32))
    x = torch.arange(ow, dtype=torch.float32)[None, :]
    y = torch.arange(oh, dtype=torch.float32)[:, None]
    sx = x * inv[0] + (y * inv[1] + inv[2])
    sy = x * inv[3] + (y * inv[4] + inv[5])
    if interpolation == "cubic":
        return _bicubic(image, sx, sy)
    if interpolation != "linear":
        raise ValueError(f"unknown interpolation {interpolation!r}")
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
    flat = img.ndim == 2
    src = torch.from_numpy(np.ascontiguousarray(img))
    if flat:
        src = src[..., None]
    out = _resize_tensor(src, ow, oh, sx, sy, interpolation).numpy()
    return out[..., 0] if flat else out


def _resize_tensor(src: torch.Tensor, ow: int, oh: int, sx: float,
                   sy: float, interpolation: str) -> torch.Tensor:
    """`resize`'s arithmetic on uint8 (..., H, W, C) tensors on any
    device (the same integers on every device)."""
    if interpolation not in ("linear", "cubic"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    h, w = src.shape[-3:-1]
    dev = src.device
    ix, wx = _axis_taps(w, ow, sx, interpolation)
    iy, wy = _axis_taps(h, oh, sy, interpolation)
    ix, iy = torch.from_numpy(ix).to(dev), torch.from_numpy(iy).to(dev)
    if interpolation == "linear":
        # cv2's fixed point: 11-bit weights, integer row sums, then the
        # vertical blend of the sums >> 4 with 16-bit products
        cx = torch.from_numpy(np.rint(wx * 2048).astype(np.int64)).to(dev)
        cy = torch.from_numpy(np.rint(wy * 2048).astype(np.int64)).to(dev)
        rows = (src[..., ix, :].to(torch.int64)
                * cx[:, :, None]).sum(-2)
        r0 = rows[..., iy[:, 0], :, :] >> 4
        r1 = rows[..., iy[:, 1], :, :] >> 4
        v = ((r0 * cy[:, 0, None, None]) >> 16) + (
            (r1 * cy[:, 1, None, None]) >> 16)
        return ((v + 2) >> 2).clamp_(0, 255).to(torch.uint8)
    cx = torch.from_numpy(wx.astype(np.float64)).to(dev)
    cy = torch.from_numpy(wy.astype(np.float64)).to(dev)
    rows = (src[..., ix, :].to(torch.float64) * cx[:, :, None]).sum(-2)
    v = (rows[..., iy, :, :] * cy[:, :, None, None]).sum(-3)
    return torch.round(v).clamp_(0, 255).to(torch.uint8)


def resize_tensor(frames: torch.Tensor, size: Tuple[int, int]
                  ) -> torch.Tensor:
    """Bilinear `resize` of uint8 (..., H, W, C) frames on their own
    device to `size` = (width, height): the same integers as `resize`
    (cv2's) on every device."""
    h, w = frames.shape[-3:-1]
    ow, oh = size
    if (oh, ow) == (h, w):
        return frames.clone()
    return _resize_tensor(frames, ow, oh, w / ow, h / oh, "linear")


def _square_pad(h: int, w: int):
    """(padh, padw): `resize_frame`'s zeros on each side."""
    return (0, (h - w) // 2) if h > w else ((w - h) // 2, 0)


def resize_frame(frame: np.ndarray, resize_dim: int = 256) -> np.ndarray:
    """Pad to a square with zeros, then resize bilinearly to
    resize_dim x resize_dim (the identity at that size already)."""
    h, w = frame.shape[:2]
    padh, padw = _square_pad(h, w)
    pad = [(padh, padh), (padw, padw)] + [(0, 0)] * (frame.ndim - 2)
    padded = np.pad(frame, pad)
    return resize(padded, (resize_dim, resize_dim), interpolation="linear")


def resize_frame_tensor(frames: torch.Tensor, resize_dim: int = 256
                        ) -> torch.Tensor:
    """`resize_frame` of uint8 (..., H, W, 3) frames on their own device,
    bit for bit."""
    h, w = frames.shape[-3:-1]
    padh, padw = _square_pad(h, w)
    padded = torch.nn.functional.pad(frames, (0, 0, padw, padw, padh, padh))
    return resize_tensor(padded, (resize_dim, resize_dim))


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


def _line2(mask: np.ndarray, p0, p1, value) -> None:
    """cv2's `Line2`: the 8-connected line between two 16.16 fixed-point
    points, clipped to the mask, its pixels at the rounded positions."""
    h, w = mask.shape[:2]
    clipped = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p0, p1)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    half = _XY_ONE >> 1
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _c_div(dy << _XY_SHIFT, ax | 1)
        k = np.arange(((x2 - x1) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs = ((x1 + half) >> _XY_SHIFT) + k
        ys = (y1 + half + k * step) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _c_div(dx << _XY_SHIFT, ay | 1)
        k = np.arange(((y2 - y1) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs = (x1 + half + k * step) >> _XY_SHIFT
        ys = ((y1 + half) >> _XY_SHIFT) + k
    xs = np.append(xs, (x2 + half) >> _XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> _XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask[ys[keep], xs[keep]] = value


def _c_div(a: int, b: int) -> int:
    """C's integer division, toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_convex_poly(mask: np.ndarray, vertices: np.ndarray, value,
                     shift: int = 0) -> None:
    """cv2's `fillConvexPoly` (8-connected) in place, vertices with
    `shift` fractional bits: the edges drawn as lines, then the rows
    between the left and right edges filled, with edges stepped in 16.16
    fixed point."""
    v = [(int(x), int(y)) for x, y in np.asarray(vertices).reshape(-1, 2)]
    npts = len(v)
    if npts == 0:
        return
    h, w = mask.shape[:2]
    up = _XY_SHIFT - shift
    for i in range(npts):
        if shift == 0:
            _draw_line(mask, v[i - 1], v[i], value)
        else:
            _line2(mask, (v[i - 1][0] << up, v[i - 1][1] << up),
                   (v[i][0] << up, v[i][1] << up), value)
    delta = (1 << shift) >> 1
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
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
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs0 = v[idx0][0] << up
                        xe = v[idx][0] << up
                        e[4] = ty
                        e[3] = _c_div((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
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


def _fill_circle(mask: np.ndarray, cx: int, cy: int, radius: int,
                 value) -> None:
    """cv2's integer `Circle` with fill: rows of the midpoint circle's
    octants, clipped to the mask."""
    h, w = mask.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius

    def row(y, x1, x2):
        if 0 <= y < h:
            mask[y, max(x1, 0): min(x2, w - 1) + 1] = value

    while dx >= dy:
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside or (x11 < w and x12 >= 0 and cy - dx < h and cy + dx >= 0):
            row(cy - dy, x11, x12)
            row(cy + dy, x11, x12)
            if x21 < w and x22 >= 0:
                row(cy - dx, x21, x22)
                row(cy + dx, x21, x22)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def thick_line(mask: np.ndarray, p0, p1, thickness: int, value) -> None:
    """cv2's `ThickLine` between integer points with thickness > 1, as
    `drawContours` and `polylines` draw each segment of a closed contour:
    the segment's quadrilateral, its corners offset by the rounded half
    thickness in 16.16 fixed point, filled by `fill_convex_poly`; and a
    round cap of radius (thickness + 1) // 2 at p1."""
    x0, y0 = int(p0[0]) << _XY_SHIFT, int(p0[1]) << _XY_SHIFT
    x1, y1 = int(p1[0]) << _XY_SHIFT, int(p1[1]) << _XY_SHIFT
    dx = (x0 - x1) / _XY_ONE
    dy = (y1 - y0) / _XY_ONE
    r = dx * dx + dy * dy
    half_width = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half_width + (thickness & 1) * _XY_ONE * 0.5) / math.sqrt(r)
        px, py = round(dy * r), round(dx * r)  # half to even, as cvRound
        quad = [(x0 + px, y0 + py), (x0 - px, y0 - py),
                (x1 - px, y1 - py), (x1 + px, y1 + py)]
        fill_convex_poly(mask, np.asarray(quad, np.int64), value,
                         shift=_XY_SHIFT)
    _fill_circle(mask, int(p1[0]), int(p1[1]),
                 (half_width + (_XY_ONE >> 1)) >> _XY_SHIFT, value)


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


def _gray(image: np.ndarray) -> np.ndarray:
    """cv2's BGR2GRAY for uint8 (14-bit fixed-point weights); a 2-D
    image as it is."""
    if image.ndim == 2:
        return image
    c = image.astype(np.int32)
    return ((c[..., 0] * 1868 + c[..., 1] * 9617 + c[..., 2] * 4899
             + (1 << 13)) >> 14).astype(np.uint8)


def enlarge_mask(mask: np.ndarray, enlargement: int = 10) -> np.ndarray:
    """Grow a mask by stroking the convex hull of its region with a pen
    `enlargement` pixels thick, as cv2's threshold (> 50), findContours,
    convexHull and drawContours do for a mask of one region, such as
    `convex_hull_mask`'s: the hull of the region's pixels is the hull of
    its outer contour. cv2 also strokes the hulls of holes; the only
    holes such masks have are the single pixels near the frame's edge
    that the fill of a clipped hull leaves, and their strokes lie inside
    the outer one (equal to cv2's bit for bit on such hulls in
    tests/test_torch_swap.py)."""
    out = mask.copy()
    fg = _gray(mask) > 50
    rows = np.nonzero(fg.any(axis=1))[0]
    if len(rows) == 0:
        return out
    # the hull of each row's outermost pixels is the hull of them all
    first = fg[rows].argmax(axis=1)
    last = fg.shape[1] - 1 - fg[rows, ::-1].argmax(axis=1)
    hull = convex_hull(np.concatenate([np.stack([first, rows], 1),
                                       np.stack([last, rows], 1)]))
    stroke = np.zeros(mask.shape[:2], np.uint8)
    n = len(hull)
    for i in range(n):
        p0, p1 = hull[i], hull[(i + 1) % n]
        if enlargement > 1:
            thick_line(stroke, p0, p1, enlargement, 1)
        else:
            _draw_line(stroke, tuple(p0), tuple(p1), 1)
    out[stroke > 0] = 255
    return out


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


# -- the host swap geometry --------------------------------------------------


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The least-squares similarity (rotation, scale, translation) mapping
    src points (N, 2) onto dst, as a float64 2x3 affine: Umeyama's closed
    form through the SVD of the cross-covariance, with the reflection
    fix. (`ops/warp.umeyama_similarity` is the device's float32 twin.)"""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / n
    u, sv, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    dm = np.diag([1.0, d])
    rot = u @ dm @ vt
    var_s = (sc ** 2).sum() / n
    scale = np.trace(np.diag(sv) @ dm) / var_s if var_s > 0 else 1.0
    t = mu_d - scale * (rot @ mu_s)
    m = np.zeros((2, 3))
    m[:2, :2] = scale * rot
    m[:, 2] = t
    return m


def warp_to_landmarks(
    src_points: np.ndarray, dst_points: np.ndarray, image: np.ndarray,
    out_size: Tuple[int, int] = (256, 256),
) -> Tuple[np.ndarray, np.ndarray]:
    """Similarity-warp `image` so that src_points land on dst_points:
    (the warped image, the 2x3 matrix)."""
    m = umeyama_similarity(src_points, dst_points)
    return warp_affine(image, m, out_size), m


def eye_geometry(
    landmarks: np.ndarray,
) -> Tuple[float, Tuple[float, float], float]:
    """(roll angle in degrees, the eyes' centre, the distance between the
    eyes) from the means of points 36:41 and 42:47, truncated to
    integers."""
    left = landmarks[36:41].mean(axis=0).astype(int)
    right = landmarks[42:47].mean(axis=0).astype(int)
    dy = float(right[1] - left[1])
    dx = float(right[0] - left[0])
    angle = float(np.degrees(np.arctan2(dy, dx)))
    center = ((left[0] + right[0]) / 2.0, (left[1] + right[1]) / 2.0)
    return angle, center, float(np.hypot(dx, dy))


def combine_images(background: np.ndarray, foreground: np.ndarray,
                   generate_mask: bool = True) -> np.ndarray:
    """The naive paste: the background zeroed where the foreground's first
    channel is not 0, plus the foreground (uint8 arithmetic)."""
    bg = background.copy()
    if generate_mask:
        bg[foreground[..., 0] != 0] = 0
    return bg + foreground


def _laplace_reflect(x: np.ndarray) -> np.ndarray:
    """The discrete Laplacian over every axis with the edge repeated, in
    the order of operations of `scipy.ndimage.laplace(x, mode="reflect")`:
    per axis x * -2 + (x[i-1] + x[i+1]), the axes added in turn."""
    out = None
    for ax in range(x.ndim):
        first = np.take(x, [0], axis=ax)
        last = np.take(x, [x.shape[ax] - 1], axis=ax)
        p = np.concatenate([first, x, last], axis=ax)
        n = x.shape[ax]
        d2 = x * -2.0 + (np.take(p, range(0, n), axis=ax)
                         + np.take(p, range(2, n + 2), axis=ax))
        out = d2 if out is None else out + d2
    return out


def poisson_blend(target: np.ndarray, src: np.ndarray, mask: np.ndarray,
                  iters: int = 1024) -> np.ndarray:
    """The iterative Laplacian blend on the host, float64 images in
    [0, 1]: `iters` steps of out += 0.25 mask laplace(out - src), then one
    clip to [0, 1]. The step is unstable where mask exceeds about 0.73
    (ROADMAP.md, Queue 3), as in the JAX package, whose iteration this
    is."""
    out = target.astype(np.float64)
    src = src.astype(np.float64)
    m = mask.astype(np.float64)
    for _ in range(iters):
        out = out + 0.25 * m * _laplace_reflect(out - src)
    return np.clip(out, 0.0, 1.0)


def generate_aligned_image(
    source_landmarks: np.ndarray, target_landmarks: np.ndarray,
    source_image: np.ndarray, target_image: np.ndarray, *,
    enlargement: int = 5, require_full_mask: bool = False,
) -> Dict[str, np.ndarray]:
    """The eye-geometry variant of the face transfer: the source face
    rotated by the difference of the eye rolls, scaled by the ratio of
    the eye distances and moved to the target's eye centre (one rotation
    matrix with the translation added), resampled bicubically."""
    src_rot, src_center, src_dist = eye_geometry(source_landmarks)
    tgt_rot, tgt_center, tgt_dist = eye_geometry(target_landmarks)
    m = rotation_matrix(src_center, src_rot - tgt_rot,
                        tgt_dist / max(src_dist, 1e-6))
    m[0, 2] += tgt_center[0] - src_center[0]
    m[1, 2] += tgt_center[1] - src_center[1]

    if require_full_mask:
        src_mask = convex_hull_mask(source_image.shape, source_landmarks)
    else:
        src_mask = enlarge_mask(
            convex_hull_mask(source_image.shape, source_landmarks[17:]),
            enlargement)
    hw = source_image.shape[:2]
    warped_face = warp_affine(apply_mask(src_mask, source_image), m, hw,
                              "cubic")
    tgt_mask_full = convex_hull_mask(target_image.shape, target_landmarks)
    return {
        "source_face_transformed": warped_face,
        "source_mask_transformed": warp_affine(src_mask, m, hw, "cubic"),
        "source_image_transformed": warp_affine(source_image, m, hw, "cubic"),
        "target_image": target_image,
        "target_mask_inv": 255 - tgt_mask_full,
        "combined": combine_images(
            apply_mask(255 - tgt_mask_full, target_image), warped_face),
        "transform": m,
    }


def generate_warped_image(
    source_landmarks: np.ndarray, target_landmarks: np.ndarray,
    source_image: np.ndarray, target_image: np.ndarray, *,
    enlargement: int = 10, require_full_mask: bool = False,
    poisson: bool = False,
) -> Dict[str, np.ndarray]:
    """The source -> target face transfer of one frame pair on the host:
    the source's no-jaw hull mask, enlarged; the face it segments,
    similarity-warped so that the five stable landmarks land on the
    target's; the target without its face (full hull) and without its
    face features (enlarged no-jaw hull); and the naive composite, a
    paste or (`poisson`) the Laplacian blend of the source into the
    target modulated by the warped face. Images at the same size,
    landmarks in their pixels."""
    if require_full_mask:
        src_mask = convex_hull_mask(source_image.shape, source_landmarks)
        src_mask_tight = src_mask.copy()
    else:
        src_mask_tight = convex_hull_mask(source_image.shape,
                                          source_landmarks[17:])
        src_mask = enlarge_mask(src_mask_tight, enlargement)

    src_face = apply_mask(src_mask, source_image)
    sp = np.asarray(STABLE_POINTS)
    hw = source_image.shape[:2]
    warped_face, m = warp_to_landmarks(source_landmarks[sp],
                                       target_landmarks[sp], src_face, hw)
    tgt_mask_full = convex_hull_mask(target_image.shape, target_landmarks)
    tgt_mask_nojaw = enlarge_mask(
        convex_hull_mask(target_image.shape, target_landmarks[17:]),
        enlargement)
    if poisson:
        combined = (poisson_blend(target_image / 255.0, source_image / 255.0,
                                  warped_face / 255.0) * 255).astype(np.uint8)
    else:
        combined = combine_images(
            apply_mask(255 - tgt_mask_full, target_image), warped_face)
    return {
        "source_face_transformed": warped_face,
        "source_mask_transformed": warp_affine(src_mask, m, hw),
        "source_mask_tight": warp_affine(src_mask_tight, m, hw),
        "source_image_transformed": warp_affine(source_image, m, hw),
        "target_image": target_image,
        "target_mask_inv": 255 - tgt_mask_full,
        "combined": combined,
        "target_without_face_features": apply_mask(255 - tgt_mask_nojaw,
                                                   target_image),
        "source_image": source_image,
        "transform": m,
    }
