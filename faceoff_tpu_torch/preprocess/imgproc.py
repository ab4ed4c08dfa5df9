"""The image operations of offline preprocessing, as OpenCV computes them,
in plain torch on any device and batched over leading dimensions.

The JAX package calls cv2 for each of these (`faceoff_tpu/preprocess/
detectors.py`, `face_crop.py`); the port may not use cv2. Integer results
are bit-exact with cv2 (`tests/test_torch_preprocess.py` holds each one to
it): the colour conversions in cv2's fixed point, the morphology on exact
integers held in float32, `pyr_down` and `scharr_deriv` in integers.
`gaussian_blur` is float32 arithmetic in another order than cv2's, within
the tolerance the tests state.

Layouts: colour images (..., H, W, 3) uint8 RGB; single-channel images
and masks (..., H, W).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

# cv2's RGB -> YCrCb coefficients for 8-bit images (14-bit fixed point)
_Y14 = (4899, 9617, 1868)
_CR14, _CB14 = 11682, 9241
# cv2's RGB -> grey coefficients for 8-bit images (15-bit fixed point)
_GRAY15 = (9798, 19235, 3735)


def _channels(rgb: torch.Tensor):
    if rgb.dtype != torch.uint8 or rgb.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) uint8 RGB, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    c = rgb.to(torch.int32)
    return c[..., 0], c[..., 1], c[..., 2]


def rgb_to_ycrcb(rgb: torch.Tensor) -> torch.Tensor:
    """`cv2.cvtColor(rgb, cv2.COLOR_RGB2YCrCb)`, bit-exact."""
    r, g, b = _channels(rgb)
    y = (r * _Y14[0] + g * _Y14[1] + b * _Y14[2] + (1 << 13)) >> 14
    cr = ((r - y) * _CR14 + (128 << 14) + (1 << 13)) >> 14
    cb = ((b - y) * _CB14 + (128 << 14) + (1 << 13)) >> 14
    return torch.stack([y, cr.clamp(0, 255), cb.clamp(0, 255)],
                       -1).to(torch.uint8)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """`cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)`, bit-exact: (..., H, W)."""
    r, g, b = _channels(rgb)
    return ((r * _GRAY15[0] + g * _GRAY15[1] + b * _GRAY15[2] + (1 << 14))
            >> 15).to(torch.uint8)


def in_range(img: torch.Tensor, lo: Sequence[int],
             hi: Sequence[int]) -> torch.Tensor:
    """`cv2.inRange`: 255 where every channel lies in [lo, hi], else 0;
    (..., H, W) uint8."""
    lo_t = torch.as_tensor(lo, dtype=img.dtype, device=img.device)
    hi_t = torch.as_tensor(hi, dtype=img.dtype, device=img.device)
    inside = ((img >= lo_t) & (img <= hi_t)).all(-1)
    return inside.to(torch.uint8) * 255


def _as_nchw(x: torch.Tensor):
    lead = x.shape[:-2]
    return x.reshape(-1, 1, *x.shape[-2:]), lead


def dilate(mask: torch.Tensor, k: int) -> torch.Tensor:
    """`cv2.dilate` with a k x k square of ones (k odd), cv2's default
    border: pixels outside the image take no part. Same dtype."""
    x, lead = _as_nchw(mask)
    v = x.to(torch.float32)  # exact for uint8 values
    # max_pool2d pads with -inf: the outside never wins
    v = F.max_pool2d(v, (1, k), 1, (0, k // 2))
    v = F.max_pool2d(v, (k, 1), 1, (k // 2, 0))
    return v.to(mask.dtype).reshape(*lead, *mask.shape[-2:])


def erode(mask: torch.Tensor, k: int) -> torch.Tensor:
    """`cv2.erode` with a k x k square of ones (k odd); the outside takes
    no part."""
    x, lead = _as_nchw(mask)
    v = -x.to(torch.float32)
    v = F.max_pool2d(v, (1, k), 1, (0, k // 2))
    v = F.max_pool2d(v, (k, 1), 1, (k // 2, 0))
    return (-v).to(mask.dtype).reshape(*lead, *mask.shape[-2:])


def morph_close(mask: torch.Tensor, k: int) -> torch.Tensor:
    """`cv2.morphologyEx(mask, cv2.MORPH_CLOSE, np.ones((k, k)))`."""
    return erode(dilate(mask, k), k)


def reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """cv2's BORDER_REFLECT_101 index map (`borderInterpolate`): ... 2 1
    | 0 1 2 ... n-1 | n-2 ... for any integer index."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    p = torch.remainder(idx, period)
    return torch.where(p >= n, period - p, p)


def pad_reflect101(img: torch.Tensor, pad: int) -> torch.Tensor:
    """`cv2.copyMakeBorder(img, pad, pad, pad, pad, BORDER_REFLECT_101)`
    of (..., H, W)."""
    h, w = img.shape[-2:]
    dev = img.device
    ys = reflect101(torch.arange(-pad, h + pad, device=dev), h)
    xs = reflect101(torch.arange(-pad, w + pad, device=dev), w)
    return img[..., ys, :][..., xs]


def gaussian_kernel(sigma: float) -> torch.Tensor:
    """cv2's Gaussian taps for a float image at `sigma` with ksize (0, 0):
    round(8 sigma + 1) | 1 taps, normalised in double, stored as float32."""
    n = int(round(sigma * 4 * 2 + 1)) | 1
    scale = -0.5 / (sigma * sigma)
    taps = [math.exp(scale * (i - (n - 1) * 0.5) ** 2) for i in range(n)]
    total = sum(taps)
    return torch.tensor([t / total for t in taps], dtype=torch.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """`cv2.GaussianBlur(img, (0, 0), sigma)` of a float32 (..., H, W)
    image, BORDER_REFLECT_101: rows, then columns, each tap added in
    order in float32 (no tensor cores, so the card and the CPU agree
    bit for bit)."""
    kern = gaussian_kernel(sigma).tolist()
    r = len(kern) // 2
    h, w = img.shape[-2:]
    x = img.to(torch.float32)
    xs = reflect101(torch.arange(-r, w + r, device=img.device), w)
    padded = x[..., xs]
    rows = padded[..., 0:w] * kern[0]
    for k in range(1, len(kern)):
        rows = rows + padded[..., k: k + w] * kern[k]
    ys = reflect101(torch.arange(-r, h + r, device=img.device), h)
    padded = rows[..., ys, :]
    out = padded[..., 0:h, :] * kern[0]
    for k in range(1, len(kern)):
        out = out + padded[..., k: k + h, :] * kern[k]
    return out


_PYR = (1, 4, 6, 4, 1)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """`cv2.pyrDown` of a uint8 (..., H, W) image: the 5 x 5 binomial
    [1 4 6 4 1]^2 / 256 at every second pixel, rounded as cv2 rounds
    uint8, BORDER_REFLECT_101; ((H + 1) // 2, (W + 1) // 2)."""
    h, w = img.shape[-2:]
    oh, ow = (h + 1) // 2, (w + 1) // 2
    dev = img.device
    x = img.to(torch.int32)
    cols = 2 * torch.arange(ow, device=dev)
    rows = None
    for k, c in enumerate(_PYR):
        term = x[..., reflect101(cols + k - 2, w)] * c
        rows = term if rows is None else rows + term
    ys = 2 * torch.arange(oh, device=dev)
    out = None
    for k, c in enumerate(_PYR):
        term = rows[..., reflect101(ys + k - 2, h), :] * c
        out = term if out is None else out + term
    return ((out + 128) >> 8).to(torch.uint8)


def scharr_deriv(img: torch.Tensor) -> torch.Tensor:
    """The Scharr derivatives of a uint8 (..., H, W) image as
    `cv2.calcOpticalFlowPyrLK` computes them (`calcSharrDeriv`): unscaled
    int16 (..., H, W, 2) holding (d/dx, d/dy), BORDER_REFLECT_101."""
    h, w = img.shape[-2:]
    dev = img.device
    x = img.to(torch.int32)
    ys = torch.arange(h, device=dev)
    up = x[..., reflect101(ys - 1, h), :]
    down = x[..., reflect101(ys + 1, h), :]
    smooth = (up + down) * 3 + x * 10  # vertical [3 10 3]
    diff = down - up  # vertical [-1 0 1]
    xs = torch.arange(w, device=dev)
    left, right = reflect101(xs - 1, w), reflect101(xs + 1, w)
    dx = smooth[..., right] - smooth[..., left]
    dy = (diff[..., right] + diff[..., left]) * 3 + diff * 10
    return torch.stack([dx, dy], -1).to(torch.int16)
