"""The bilinear warp kernels (`csrc/warp.cu`): build, load and launch.

The source is compiled at first use by `ops/cuda_build.py` (plain `nvcc`,
a C interface, seconds) and loaded with ctypes. A failed build or load
raises: there is no fallback to the plain version.

`bilinear_warp` launches the forward and `bilinear_warp_backward` the
backward; each checks its inputs, allocates its outputs, launches on
PyTorch's current stream and counts its launches (`launches`,
`backward_launches`). The plain reference is `ops/warp._bilinear_sample`
and autograd through it.

The forward gathers one output pixel a thread. The backward works on
16 x 16 tiles of output pixels: a tile whose source footprint has at most
WINDOW_CELLS pixels splats through shared memory, the others add their
taps into d_imgs directly; `tile_footprints` is the plain twin of that
rule.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from faceoff_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "warp.cu"
# the backward's tile side, largest footprint in pixels and most channels
# that it splats through shared memory (kTile, kWindowCells and
# kStageChannels in warp.cu)
TILE = 16
WINDOW_CELLS = 1024
STAGE_CHANNELS = 4

# kernel launches made through the wrappers in this process
launches = 0
backward_launches = 0

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the build for the current source and flags lives."""
    return cuda_build.library_path(SOURCE, "faceoff_warp")


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    return cuda_build.build(SOURCE, "faceoff_warp")


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.faceoff_bilinear_warp
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        bwd = lib.faceoff_bilinear_warp_backward
        bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def tile_origins(v: torch.Tensor, n: int) -> torch.Tensor:
    """floor(v) clipped to [-2, n], NaN to -2, as int64: the kernels' tap
    origins. Both taps of a clipped origin are inside the image exactly
    where those of the unclipped one are."""
    f = torch.floor(v).clamp(-2, n)
    return torch.where(torch.isnan(f), torch.full_like(f, -2.0), f).long()


def tile_footprints(
    xs: torch.Tensor, ys: torch.Tensor, h: int, w: int, c: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's footprint rule in plain torch, for grids xs/ys
    (N, OH, OW) over (h, w, c) images.

    Returns boxes (N, TY, TX, 4) int64: per TILE x TILE output tile (the
    last row and column of tiles may be partial), the source box
    (x_min, y_min, x_max + 1, y_max + 1) that its taps reach, from the
    clipped tap origins of its pixels (`tile_origins`). Also returns
    fits (N, TY, TX) bool: whether the box has at most WINDOW_CELLS
    pixels and c <= STAGE_CHANNELS. Those tiles splat through shared
    memory; the others add their taps into d_imgs directly."""
    n, oh, ow = xs.shape
    th, tw = -(-oh // TILE), -(-ow // TILE)

    def reduce(v, fill, fn):
        full = v.new_full((n, th * TILE, tw * TILE), fill)
        full[:, :oh, :ow] = v
        return fn(full.view(n, th, TILE, tw, TILE), dim=(2, 4))

    xi, yi = tile_origins(xs, w), tile_origins(ys, h)
    x_min, x_max = reduce(xi, w, torch.amin), reduce(xi, -2, torch.amax)
    y_min, y_max = reduce(yi, h, torch.amin), reduce(yi, -2, torch.amax)
    fits = ((x_max - x_min + 2) * (y_max - y_min + 2) <= WINDOW_CELLS) & (
        c <= STAGE_CHANNELS)
    return torch.stack([x_min, y_min, x_max + 1, y_max + 1], -1), fits


def _check(imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
           *extra: Tuple[str, torch.Tensor]) -> None:
    for name, t in (("imgs", imgs), ("xs", xs), ("ys", ys), *extra):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != imgs.device:
            raise ValueError(f"{name} is on {t.device}, imgs on {imgs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if imgs.dim() != 4 or xs.dim() != 3 or xs.shape != ys.shape:
        raise ValueError(
            f"want imgs (N,H,W,C) and xs/ys (N,OH,OW); got "
            f"{tuple(imgs.shape)}, {tuple(xs.shape)}, {tuple(ys.shape)}"
        )
    n, h, w, c = imgs.shape
    if xs.shape[0] != n:
        raise ValueError(f"{xs.shape[0]} grids for {n} images")
    oh = xs.shape[1]
    if min(n, h, w, c) < 1 or not (1 <= n <= 65535 and 1 <= oh <= 65535):
        raise ValueError(f"unsupported sizes imgs {tuple(imgs.shape)}, "
                         f"grid {tuple(xs.shape)}")


def bilinear_warp(
    imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
) -> torch.Tensor:
    """Launch the warp: imgs (N, H, W, C), xs/ys (N, OH, OW), all float32,
    contiguous and on one CUDA device -> (N, OH, OW, C) float32."""
    global launches
    _check(imgs, xs, ys)
    n, h, w, c = imgs.shape
    oh, ow = xs.shape[1:]
    out = torch.empty((n, oh, ow, c), dtype=torch.float32, device=imgs.device)
    if ow == 0:
        return out
    lib = load()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.faceoff_bilinear_warp(
            imgs.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
            n, h, w, c, oh, ow, stream,
        )
    if err != 0:
        raise RuntimeError(f"bilinear warp launch failed: cudaError {err}")
    launches += 1
    return out


def bilinear_warp_backward(
    g: torch.Tensor, imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
    *, need_imgs: bool = True, need_coords: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """Launch the backward of `bilinear_warp` for the output gradient g
    (N, OH, OW, C) -> (d_imgs (N, H, W, C), d_xs, d_ys (N, OH, OW)), each
    None where it is not asked for. All float32, contiguous, on one CUDA
    device.

    Each value of d_imgs is a sum of g w_tap over the taps that land on
    it: summed per 16 x 16 output tile, then added into d_imgs with one
    atomic per tile (or one per tap where the tile's footprint is too
    large). The order of the additions differs from autograd's and, across
    tiles, from run to run, so the result agrees with autograd through
    `ops/warp._bilinear_sample` to float32 rounding of those terms
    (chip_smoke.py and the card tests hold it to 1e-4), not bit for bit."""
    global backward_launches
    _check(imgs, xs, ys, ("g", g))
    n, h, w, c = imgs.shape
    oh, ow = xs.shape[1:]
    if tuple(g.shape) != (n, oh, ow, c):
        raise ValueError(f"g is {tuple(g.shape)}, want {(n, oh, ow, c)}")
    dev = imgs.device
    d_imgs = torch.zeros_like(imgs) if need_imgs else None
    d_xs = torch.empty_like(xs) if need_coords else None
    d_ys = torch.empty_like(ys) if need_coords else None
    if ow == 0 or not (need_imgs or need_coords):
        return d_imgs, d_xs, d_ys
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.faceoff_bilinear_warp_backward(
            imgs.data_ptr(), xs.data_ptr(), ys.data_ptr(), g.data_ptr(),
            d_imgs.data_ptr() if need_imgs else None,
            d_xs.data_ptr() if need_coords else None,
            d_ys.data_ptr() if need_coords else None,
            n, h, w, c, oh, ow, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"bilinear warp backward launch failed: cudaError {err}")
    backward_launches += 1
    return d_imgs, d_xs, d_ys


class BilinearWarp(torch.autograd.Function):
    """`bilinear_warp` with its backward kernel as the gradient."""

    @staticmethod
    def forward(ctx, imgs, xs, ys):
        ctx.save_for_backward(imgs, xs, ys)
        return bilinear_warp(imgs, xs, ys)

    @staticmethod
    def backward(ctx, g):
        imgs, xs, ys = ctx.saved_tensors
        need_img, need_x, need_y = ctx.needs_input_grad
        d_imgs, d_xs, d_ys = bilinear_warp_backward(
            g.contiguous(), imgs, xs, ys,
            need_imgs=need_img, need_coords=need_x or need_y,
        )
        return d_imgs, d_xs if need_x else None, d_ys if need_y else None
