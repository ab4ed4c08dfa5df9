"""Pyramidal Lucas-Kanade point tracking, forward and backward
(`csrc/lk.cu`), with the plain torch version beside the kernel.

This replaces the two `cv2.calcOpticalFlowPyrLK` calls of
`FlowTrackingLandmarker._track` (`faceoff_tpu/preprocess/detectors.py:483`
and `:488`; winSize 21, maxLevel 3, criteria COUNT|EPS 30 / 0.01, flags 0,
minEigThreshold 1e-4); no PyTorch call computes it. One call tracks every
point from frame A to frame B, then back from B to A starting at its own
result, and returns both results, both statuses and the round-trip
distance.

The arithmetic is OpenCV's (`lkpyramid.cpp`):
  * the pyramid levels (`build_pyramid`, cv2's pyrDown) are padded by the
    window with BORDER_REFLECT_101, their Scharr derivatives with zeros;
    a level smaller than the window is dropped, with the levels above it;
  * bilinear weights are 14-bit fixed point, rounded half to even; the
    window's image values are descaled by 9 bits and the derivatives by
    14, as integers;
  * the sums of the 2 x 2 system are taken exactly in integers here (cv2
    adds its products in float32, so its sums differ in the last bits),
    then converted to float32 and scaled by 2^-20; minEig is divided by
    the window's area; epsilon is squared and compared in double;
  * a step that nearly cancels the previous one (|d + d_prev| < 0.01 on
    both axes) is halved and ends the loop;
  * a point that leaves [-win, size) or whose minEig falls below the
    threshold loses its status only at level 0; at other levels it keeps
    its guess. The guess starts at the point scaled to the top level and
    doubles at each level down.
Every float32 operation is one IEEE operation in the order written, in
the kernel (no contraction to fused multiply-adds) as in torch, so the
kernel and the plain version agree bit for bit.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. `launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional

import torch

from faceoff_tpu_torch.ops import cuda_build
from faceoff_tpu_torch.preprocess.imgproc import (pad_reflect101, pyr_down,
                                                  scharr_deriv)

SOURCE = cuda_build.CSRC / "lk.cu"
WIN, MAX_LEVEL, MAX_ITER, EPS, MIN_EIG = 21, 3, 30, 0.01, 1e-4
W_BITS = 14
FLT_SCALE = 1.0 / (1 << 20)
FLT_EPSILON = 1.1920928955078125e-07

# What bounds the kernel's integer sums (lk.cu sums a thread's products in
# 32 bits); tests/test_torch_ccl_lk_arith.py checks each claim.
# |Scharr derivative| of uint8 frames: (3 + 10 + 3) * 255.
DERIV_MAX = 16 * 255
# The four bilinear weights sum to 2^14; the first three are roundings of
# products in [0, 1] and the fourth, 2^14 less them, is at least -1: the
# sum of their magnitudes is at most 2^14 + 2, of the positive ones 2^14 + 1.
WEIGHT_MIN = -1
WEIGHT_ABS_SUM_MAX = (1 << W_BITS) + 2
# A window value (descaled by 9 bits) lies in [0, IVAL_MAX], a derivative
# (descaled by 14) in [-IDER_MAX, IDER_MAX].
IVAL_MAX = (255 * ((1 << W_BITS) + 1) + (1 << (W_BITS - 6))) >> (W_BITS - 5)
IDER_MAX = (DERIV_MAX * WEIGHT_ABS_SUM_MAX + (1 << (W_BITS - 1))) >> W_BITS
# The largest product summed: (J - I) * dI; dI * dI is smaller.
PRODUCT_MAX = IVAL_MAX * IDER_MAX
INT32_MAX = 2 ** 31 - 1


# Warps the kernel gives a point (lk.cu's kWarpsPerPoint).
POINT_WARPS = 4


def lane_pixels(win: int) -> int:
    """Window pixels a thread of the kernel owns (lk.cu's KPL): 4 up to a
    window of 22 x 22, 8 up to 32 x 32. A thread's sum of that many
    products, at most KPL * PRODUCT_MAX in magnitude, fits int32."""
    return 4 if win * win <= 4 * 32 * POINT_WARPS else 8

# kernel launches made through the wrapper in this process
launches = 0

_lib: Optional[ctypes.CDLL] = None
_count_lock = threading.Lock()  # preprocessing threads launch at once


class Pyramid(NamedTuple):
    """One frame's pyramid as the tracker reads it.

    img: every level, padded by `win` on each side (BORDER_REFLECT_101),
    flattened one after the other, uint8. deriv: each level's Scharr
    (d/dx, d/dy), padded by `win` with zeros, flattened likewise, int16
    pairs. levels (L, 4) int64: rows, cols, offset into img, offset into
    deriv (in int16 elements). sizes: the levels' (rows, cols) on the
    host."""

    img: torch.Tensor
    deriv: torch.Tensor
    levels: torch.Tensor
    sizes: List[tuple]
    win: int


def build_pyramids(grays: torch.Tensor, win: int = WIN,
                   max_level: int = MAX_LEVEL) -> List[Pyramid]:
    """The pyramids of uint8 (N, H, W) frames, as `calcOpticalFlowPyrLK`
    builds them (`buildOpticalFlowPyramid` without derivatives, then
    `calcSharrDeriv` per level), on the frames' device: all N at once
    (a few dozen tensor operations whatever N), each frame's pyramid a
    view into the batch's buffers."""
    if grays.dim() != 3 or grays.dtype != torch.uint8:
        raise ValueError(f"grays must be (N, H, W) uint8, got "
                         f"{tuple(grays.shape)} {grays.dtype}")
    n = grays.shape[0]
    levels = [grays]
    h, w = grays.shape[1:]
    for _ in range(max_level):
        h, w = (h + 1) // 2, (w + 1) // 2
        if w <= win or h <= win:
            break
        levels.append(pyr_down(levels[-1]))
    imgs, derivs, table = [], [], []
    img_off = der_off = 0
    for lvl in levels:
        rows, cols = lvl.shape[1:]
        padded = pad_reflect101(lvl, win).reshape(n, -1)
        d = torch.nn.functional.pad(
            scharr_deriv(lvl).permute(0, 3, 1, 2).to(torch.int32),
            (win, win, win, win)).permute(0, 2, 3, 1).to(torch.int16)
        imgs.append(padded)
        derivs.append(d.reshape(n, -1))
        table.append([rows, cols, img_off, der_off])
        img_off += padded.shape[1]
        der_off += derivs[-1].shape[1]
    img, deriv = torch.cat(imgs, 1), torch.cat(derivs, 1)
    level_t = torch.tensor(table, dtype=torch.int64, device=grays.device)
    sizes = [tuple(t[:2]) for t in table]
    return [Pyramid(img[i], deriv[i], level_t, sizes, win) for i in range(n)]


def build_pyramid(gray: torch.Tensor, win: int = WIN,
                  max_level: int = MAX_LEVEL) -> Pyramid:
    """`build_pyramids` of one uint8 (H, W) frame."""
    if gray.dim() != 2:
        raise ValueError(f"gray must be (H, W), got {tuple(gray.shape)}")
    return build_pyramids(gray[None], win, max_level)[0]


def library_path() -> Path:
    return cuda_build.library_path(SOURCE, "faceoff_lk")


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    return cuda_build.build(SOURCE, "faceoff_lk")


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.faceoff_pyr_lk
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_double]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class Tracks(NamedTuple):
    """A forward-backward track of N points: fwd (N, 2) float32, st_fwd
    (N,) bool, back (N, 2) float32 (tracked from fwd), st_back (N,) bool
    and fb (N,) float32, the distance from back to the start."""

    fwd: torch.Tensor
    st_fwd: torch.Tensor
    back: torch.Tensor
    st_back: torch.Tensor
    fb: torch.Tensor


def _round_fix(v: torch.Tensor) -> torch.Tensor:
    """cvRound(v * 2^14) of float32 v, half to even, as int64."""
    return torch.round(v * float(1 << W_BITS)).to(torch.int64)


def _weights(a: torch.Tensor, b: torch.Tensor):
    one = torch.ones_like(a)
    iw00 = _round_fix((one - a) * (one - b))
    iw01 = _round_fix(a * (one - b))
    iw10 = _round_fix((one - a) * b)
    iw11 = (1 << W_BITS) - iw00 - iw01 - iw10
    return iw00, iw01, iw10, iw11


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def _track_plain(src: Pyramid, dst: Pyramid, pts: torch.Tensor,
                 max_iter: int, eps: float, min_eig: float,
                 work: Optional[dict] = None):
    """One direction of `pyr_lk_plain`: points (P, 2) float32 of src's
    frame into dst's. Returns (points, status); adds the window setups
    and iterations it ran to `work`."""
    win = src.win
    dev = pts.device
    n_pts = pts.shape[0]
    half = torch.tensor((win - 1) * 0.5, dtype=torch.float32, device=dev)
    status = torch.ones(n_pts, dtype=torch.bool, device=dev)
    nxt = torch.zeros_like(pts)
    eps2 = min(max(eps, 0.0), 10.0) ** 2
    wy, wx = torch.meshgrid(torch.arange(win, device=dev),
                            torch.arange(win, device=dev), indexing="ij")
    wy, wx = wy.reshape(1, -1), wx.reshape(1, -1)
    n_levels = len(src.sizes)
    img_i, der_i = src.img.to(torch.int64), src.deriv.to(torch.int64)
    img_j = dst.img.to(torch.int64)
    for level in range(n_levels - 1, -1, -1):
        rows, cols = src.sizes[level]
        stride = cols + 2 * win
        _, _, ioff, doff = (int(v) for v in src.levels[level])
        joff = int(dst.levels[level][2])
        prev = pts * float(1.0 / (1 << level))
        if level == n_levels - 1:
            nxt = prev.clone()
        else:
            nxt = nxt * 2.0
        prev = prev - half
        ip = torch.floor(prev).to(torch.int64)
        out = ((ip[:, 0] < -win) | (ip[:, 0] >= cols)
               | (ip[:, 1] < -win) | (ip[:, 1] >= rows))
        if level == 0:
            status &= ~out
        live = ~out
        if work is not None:
            work["setups"] += int(live.sum())
        a = prev[:, 0] - ip[:, 0].to(torch.float32)
        b = prev[:, 1] - ip[:, 1].to(torch.float32)
        w00, w01, w10, w11 = (w[:, None] for w in _weights(a, b))
        ipc = torch.where(live[:, None], ip, torch.zeros_like(ip))
        pos = (ipc[:, 1:2] + win + wy) * stride + ipc[:, 0:1] + win + wx

        def interp(buf, base, step, off):
            return (buf[base + off + pos * step] * w00
                    + buf[base + off + (pos + 1) * step] * w01
                    + buf[base + off + (pos + stride) * step] * w10
                    + buf[base + off + (pos + stride + 1) * step] * w11)

        ival = _descale(interp(img_i, ioff, 1, 0), W_BITS - 5)
        ix = _descale(interp(der_i, doff, 2, 0), W_BITS)
        iy = _descale(interp(der_i, doff, 2, 1), W_BITS)
        a11 = (ix * ix).sum(1).to(torch.float32) * FLT_SCALE
        a12 = (ix * iy).sum(1).to(torch.float32) * FLT_SCALE
        a22 = (iy * iy).sum(1).to(torch.float32) * FLT_SCALE
        det = a11 * a22 - a12 * a12
        diff = a11 - a22
        four = torch.full_like(a12, 4.0)
        eig = (a22 + a11 - torch.sqrt(diff * diff + four * a12 * a12)) \
            / float(2 * win * win)
        bad = (eig < torch.tensor(min_eig, dtype=torch.float32)) | (
            det < FLT_EPSILON)
        if level == 0:
            status &= ~(live & bad)
        live &= ~bad
        inv = torch.ones_like(det) / det
        cur = nxt - half
        prev_dx = torch.zeros_like(a)
        prev_dy = torch.zeros_like(a)
        running = live.clone()
        for j in range(max_iter):
            if not bool(running.any()):
                break
            inx = torch.floor(cur).to(torch.int64)
            gone = running & ((inx[:, 0] < -win) | (inx[:, 0] >= cols)
                              | (inx[:, 1] < -win) | (inx[:, 1] >= rows))
            if level == 0:
                status &= ~gone
            running &= ~gone
            if work is not None:
                work["iters"] += int(running.sum())
            a = cur[:, 0] - inx[:, 0].to(torch.float32)
            b = cur[:, 1] - inx[:, 1].to(torch.float32)
            w00, w01, w10, w11 = (w[:, None] for w in _weights(a, b))
            inc = torch.where(running[:, None], inx, torch.zeros_like(inx))
            pos = (inc[:, 1:2] + win + wy) * stride + inc[:, 0:1] + win + wx
            jval = _descale(interp(img_j, joff, 1, 0), W_BITS - 5) - ival
            b1 = (jval * ix).sum(1).to(torch.float32) * FLT_SCALE
            b2 = (jval * iy).sum(1).to(torch.float32) * FLT_SCALE
            dx = (a12 * b2 - a22 * b1) * inv
            dy = (a12 * b1 - a11 * b2) * inv
            step = running[:, None]
            cur = torch.where(step, cur + torch.stack([dx, dy], 1), cur)
            nxt = torch.where(step, cur + half, nxt)
            dd = dx.double() * dx.double() + dy.double() * dy.double()
            small = running & (dd <= eps2)
            cancel = running & ~small & (
                (dx + prev_dx).abs().double() < 0.01) & (
                (dy + prev_dy).abs().double() < 0.01)
            if j == 0:
                cancel = torch.zeros_like(cancel)
            halved = nxt - torch.stack([dx, dy], 1) * 0.5
            nxt = torch.where(cancel[:, None], halved, nxt)
            running &= ~(small | cancel)
            prev_dx, prev_dy = dx, dy
    return nxt, status


def pyr_lk_plain(src: Pyramid, dst: Pyramid, pts: torch.Tensor, *,
                 max_iter: int = MAX_ITER, eps: float = EPS,
                 min_eig: float = MIN_EIG,
                 work: Optional[dict] = None) -> Tracks:
    """The plain torch version of `pyr_lk`: points (N, 2) float32 tracked
    from src's frame to dst's and back. `work`, a dict, gets the counts
    of window setups ("setups", one a point and level) and of iterations
    ("iters") that these inputs needed, both directions."""
    if work is not None:
        work.setdefault("setups", 0)
        work.setdefault("iters", 0)
    fwd, st_f = _track_plain(src, dst, pts, max_iter, eps, min_eig, work)
    back, st_b = _track_plain(dst, src, fwd, max_iter, eps, min_eig, work)
    d = back - pts
    fb = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    return Tracks(fwd, st_f, back, st_b, fb)


def _check(src: Pyramid, dst: Pyramid, pts: torch.Tensor) -> None:
    if src.sizes != dst.sizes or src.win != dst.win:
        raise ValueError("the two pyramids differ in size or window")
    if pts.dim() != 2 or pts.shape[1] != 2 or pts.dtype != torch.float32:
        raise ValueError(f"points must be (N, 2) float32, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    for name, t in (("src", src.img), ("dst", dst.img), ("points", pts)):
        if t.device != src.img.device:
            raise ValueError(f"{name} on {t.device}, src on "
                             f"{src.img.device}")


def launch_kernel(src: Pyramid, dst: Pyramid, pts: torch.Tensor, *,
                  max_iter: int = MAX_ITER, eps: float = EPS,
                  min_eig: float = MIN_EIG):
    """The kernel alone on CUDA pyramids and points (N, 2) float32: (fwd
    (N, 2), st (2, N) uint8 (forward, backward), back (N, 2), fb (N,))."""
    global launches
    _check(src, dst, pts)
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"points on {dev}: the kernel takes CUDA tensors")
    if src.win * src.win > 1024:
        raise ValueError(f"window {src.win}: at most 32 x 32")
    n = pts.shape[0]
    pts = pts.contiguous()
    fwd = torch.empty_like(pts)
    back = torch.empty_like(pts)
    st = torch.empty((2, n), dtype=torch.uint8, device=dev)
    fb = torch.empty((n,), dtype=torch.float32, device=dev)
    eps2 = min(max(eps, 0.0), 10.0) ** 2
    kpl = lane_pixels(src.win)
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.faceoff_pyr_lk(
            src.img.data_ptr(), src.deriv.data_ptr(), dst.img.data_ptr(),
            dst.deriv.data_ptr(), src.levels.data_ptr(), len(src.sizes),
            src.win, max_iter, min_eig, eps2, pts.data_ptr(),
            fwd.data_ptr(), st[0].data_ptr(), back.data_ptr(),
            st[1].data_ptr(), fb.data_ptr(), n, kpl, stream)
    if status == 1:
        raise ValueError(f"window {src.win}: the kernel has no launch for "
                         f"{kpl} pixels a thread")
    if status != 0:
        raise RuntimeError(f"pyr_lk kernel launch failed: cudaError "
                           f"{status - 1000}")
    with _count_lock:
        launches += 1
    return fwd, st, back, fb


def pyr_lk(src: Pyramid, dst: Pyramid, pts: torch.Tensor, *,
           max_iter: int = MAX_ITER, eps: float = EPS,
           min_eig: float = MIN_EIG) -> Tracks:
    """Track points (N, 2) float32 from src's frame to dst's and back
    (one launch on CUDA, the plain version on the CPU)."""
    _check(src, dst, pts)
    dev = pts.device
    if dev.type == "cpu":
        return pyr_lk_plain(src, dst, pts, max_iter=max_iter, eps=eps,
                            min_eig=min_eig)
    if dev.type != "cuda":
        raise ValueError(f"points on {dev}: CPU or CUDA only")
    fwd, st, back, fb = launch_kernel(src, dst, pts, max_iter=max_iter,
                                      eps=eps, min_eig=min_eig)
    return Tracks(fwd, st[0].bool(), back, st[1].bool(), fb)
