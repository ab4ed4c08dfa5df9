"""The tiled backward of the warp kernels (`csrc/warp.cu`), emulated on the
CPU.

The kernels cannot run here, so their rules are checked in plain torch:

- `warp_cuda.tile_footprints`, the twin of the backward's footprint rule,
  against a box computed pixel by pixel for every tile;
- an emulation of the backward as it works a tile: the footprint from the
  kernel's clipped tap origins; for a tile whose footprint fits, every
  source value of the footprint that lies inside the image sums g w_tap
  over the pixels whose origin is the cell that puts one of their four
  taps on it, and that sum is added into d_imgs once; a tile that does
  not fit adds its inside taps directly. d_xs/d_ys come from the direct
  gathers. Its gradients must equal autograd through
  `ops/warp._bilinear_sample` and `jax.vjp` of the JAX package's
  `_bilinear_sample` within 1e-5 (sums of a few float32 terms a source
  value, added in another order).

Inputs are made with numpy from a seed: smooth affine grids, edge
coordinates (-1, -0.5, 0, w-1, w-0.5, w) on one row, and one tile whose
coordinates reach far past two corners, so that its footprint has more
than WINDOW_CELLS pixels. The kernels themselves are held to the same
references on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.ops import warp as JW
from faceoff_tpu_torch.ops import cuda_build
from faceoff_tpu_torch.ops import warp as TW
from faceoff_tpu_torch.ops import warp_cuda as WC

T = WC.TILE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grids(seed, n, h, w, oh, ow, oversized=True):
    """Affine grids (scale 0.8-1.25, rotation up to 0.3 rad, shifts that
    leave the image), the edge coordinates on row 0 of frame 0, and, with
    `oversized`, the tile at tile row 1, column 1 of the last frame
    stretched to (-40, -40) and (w + 40, h + 40)."""
    rng = np.random.default_rng(seed)
    oy, ox = np.mgrid[0:oh, 0:ow].astype(np.float32)
    xs = np.empty((n, oh, ow), np.float32)
    ys = np.empty((n, oh, ow), np.float32)
    for f in range(n):
        ang = rng.uniform(-0.3, 0.3)
        s = rng.uniform(0.8, 1.25)
        tx, ty = rng.uniform(-0.2, 0.2, 2) * (w, h)
        xs[f] = s * (np.cos(ang) * ox - np.sin(ang) * oy) + tx + 2
        ys[f] = s * (np.sin(ang) * ox + np.cos(ang) * oy) + ty + 2
    xs += rng.uniform(-0.3, 0.3, xs.shape).astype(np.float32)
    xs[:, ::5, ::3] = np.round(xs[:, ::5, ::3])
    edges = np.array([-1.0, -0.5, 0.0, w - 1.0, w - 0.5, w], np.float32)
    xs[0, 0, :len(edges)] = edges
    ys[0, 0, :len(edges)] = edges * (h / w)
    if oversized:
        xs[-1, T, T], ys[-1, T, T] = -40.0, -40.0
        xs[-1, T + 1, T + 1], ys[-1, T + 1, T + 1] = w + 40.0, h + 40.0
    return xs, ys


def _brute_boxes(xs, ys, h, w):
    n, oh, ow = xs.shape
    th, tw = -(-oh // T), -(-ow // T)
    boxes = np.zeros((n, th, tw, 4), np.int64)

    def origin(v, size):
        return -2 if np.isnan(v) else int(min(max(np.floor(v), -2), size))

    for f in range(n):
        for ty in range(th):
            for tx in range(tw):
                px = [origin(v, w) for v in
                      xs[f, ty * T:(ty + 1) * T, tx * T:(tx + 1) * T].ravel()]
                py = [origin(v, h) for v in
                      ys[f, ty * T:(ty + 1) * T, tx * T:(tx + 1) * T].ravel()]
                boxes[f, ty, tx] = (min(px), min(py), max(px) + 1,
                                    max(py) + 1)
    return boxes


@pytest.mark.parametrize("kind", ["affine", "uniform", "nonfinite"])
def test_tile_footprints_match_brute_force(kind):
    n, h, w, oh, ow = 2, 30, 44, 37, 41
    if kind == "affine":
        xs, ys = _grids(1, n, h, w, oh, ow)
    else:
        rng = np.random.default_rng(2)
        xs = rng.uniform(-5, w + 5, (n, oh, ow)).astype(np.float32)
        ys = rng.uniform(-5, h + 5, (n, oh, ow)).astype(np.float32)
        if kind == "nonfinite":
            xs[0, 3, 4], ys[1, 20, 33] = np.nan, np.nan
            xs[1, 0, 0], ys[0, 36, 40] = np.inf, -np.inf
            xs[0, 17, 17], ys[0, 17, 17] = 1e30, -1e30
    boxes, fits = WC.tile_footprints(torch.from_numpy(xs),
                                     torch.from_numpy(ys), h, w, 3)
    want = _brute_boxes(xs, ys, h, w)
    np.testing.assert_array_equal(boxes.numpy(), want)
    bw = want[..., 2] - want[..., 0] + 1
    bh = want[..., 3] - want[..., 1] + 1
    np.testing.assert_array_equal(fits.numpy(), bw * bh <= WC.WINDOW_CELLS)
    # more channels than the kernel stages: every tile splats directly
    assert not WC.tile_footprints(torch.from_numpy(xs), torch.from_numpy(ys),
                                  h, w, WC.STAGE_CHANNELS + 1)[1].any()
    if kind == "uniform":
        assert not fits.any()  # scattered taps: every tile gathers directly


def test_twin_constants_match_the_kernel_source():
    src = (cuda_build.CSRC / "warp.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src)[1]) == WC.TILE
    assert int(re.search(r"constexpr int kWindowCells = (\d+);", src)[1]) \
        == WC.WINDOW_CELLS
    assert int(re.search(r"constexpr int kStageChannels = (\d+);", src)[1]) \
        == WC.STAGE_CHANNELS


def _emulate(imgs, xs, ys, g):
    """The backward, tile by tile, in float32: (d_imgs, d_xs, d_ys)."""
    n, h, w, c = imgs.shape
    boxes, fits = WC.tile_footprints(xs, ys, h, w, c)
    d_img = torch.zeros_like(imgs)
    d_xs, d_ys = torch.zeros_like(xs), torch.zeros_like(ys)
    for f in range(n):
        for ty in range(boxes.shape[1]):
            for tx in range(boxes.shape[2]):
                sl = (f, slice(ty * T, (ty + 1) * T),
                      slice(tx * T, (tx + 1) * T))
                x, y = xs[sl].reshape(-1), ys[sl].reshape(-1)
                gv = g[sl].reshape(-1, c)
                fx, fy = torch.floor(x), torch.floor(y)
                dx, dy = x - fx, y - fy
                weights = [(1 - dx) * (1 - dy), dx * (1 - dy),
                           (1 - dx) * dy, dx * dy]
                vals = _direct(imgs[f], fx, fy, d_img[f], gv, weights,
                               splat=not bool(fits[f, ty, tx]))
                if bool(fits[f, ty, tx]):
                    _splat(d_img[f], boxes[f, ty, tx], x, y, gv, weights)
                v00, v01, v10, v11 = vals
                dxc, dyc = dx[:, None], dy[:, None]
                top = v00 * (1 - dxc) + v01 * dxc
                bot = v10 * (1 - dxc) + v11 * dxc
                gx = (gv * ((v01 - v00) * (1 - dyc)
                            + (v11 - v10) * dyc)).sum(1)
                d_xs[sl] = gx.reshape(xs[sl].shape)
                d_ys[sl] = (gv * (bot - top)).sum(1).reshape(xs[sl].shape)
    return d_img, d_xs, d_ys


def _splat(d_img, box, x, y, gv, weights):
    """One fitting tile: each footprint cell (u, v) inside the image sums,
    per channel, g w_tap over the pixels whose clipped tap origin is the
    cell (u - a, v - e) of tap (a, e), and is added into d_img once."""
    h, w, c = d_img.shape
    x0, y0, x1, y1 = (int(v) for v in box)
    bw, bh = x1 - x0 + 1, y1 - y0 + 1
    assert bw * bh <= WC.WINDOW_CELLS
    origin = ((WC.tile_origins(y, h) - y0) * bw
              + (WC.tile_origins(x, w) - x0))  # each pixel's origin cell
    vv, uu = torch.meshgrid(torch.arange(bh), torch.arange(bw), indexing="ij")
    vv, uu = vv.reshape(-1), uu.reshape(-1)
    acc = torch.zeros((bh * bw, c))
    for tap, wt in enumerate(weights):
        a, e = tap & 1, tap >> 1
        cu, cv = uu - a, vv - e
        src = torch.where((cu >= 0) & (cv >= 0), cv * bw + cu, -1)
        on_list = src[:, None] == origin[None, :]  # (cells, pixels)
        acc += on_list.float() @ (gv * wt[:, None])
    sy, sx = y0 + vv, x0 + uu
    inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    d_img[sy[inside], sx[inside]] += acc[inside]


def _direct(img, fx, fy, d_img, gv, weights, splat):
    """The direct gathers with per-tap inside tests (for d_xs/d_ys), and,
    with `splat`, each inside tap's g w_tap added straight into d_img."""
    h, w, c = img.shape
    vals = []
    for (ox, oy), wt in zip(((0, 0), (1, 0), (0, 1), (1, 1)), weights):
        tx, ty = fx + ox, fy + oy
        inside = (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
        xc = tx.clamp(0, w - 1).long()
        yc = ty.clamp(0, h - 1).long()
        vals.append(img[yc, xc] * inside[:, None])
        if splat:
            d_img.index_put_((yc[inside], xc[inside]),
                             (gv * wt[:, None])[inside], accumulate=True)
    return vals


def _case(c, seed=3, n=2, h=64, w=80, oh=40, ow=56):
    xs, ys = _grids(seed, n, h, w, oh, ow)
    rng = np.random.default_rng(seed + 1)
    imgs = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    g = rng.normal(size=(n, oh, ow, c)).astype(np.float32)
    return imgs, xs, ys, g


@pytest.mark.parametrize("c", [1, 3, 4])
def test_emulated_tiles_match_autograd(c):
    """All three gradients, with C = 1, 3, 4 and an output grid (40 x 56,
    ragged against the 16-pixel tile) of another size than the 64 x 80
    source; both paths occur."""
    imgs, xs, ys, g = (torch.from_numpy(a) for a in _case(c))
    fits = WC.tile_footprints(xs, ys, imgs.shape[1], imgs.shape[2], c)[1]
    assert bool(fits.any()) and not bool(fits.all())
    d_img, d_xs, d_ys = _emulate(imgs, xs, ys, g)
    leaves = [t.clone().requires_grad_(True) for t in (imgs, xs, ys)]
    grads = torch.autograd.grad(TW._bilinear_sample(*leaves), leaves, g)
    for got, want in zip((d_img, d_xs, d_ys), grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_emulated_tiles_match_jax_vjp():
    """The emulation's gradients against `jax.vjp` of the JAX package's
    per-frame `_bilinear_sample`, vmapped over the frames (C = 3)."""
    imgs, xs, ys, g = _case(3, seed=7)
    d_img, d_xs, d_ys = _emulate(*(torch.from_numpy(a)
                                   for a in (imgs, xs, ys, g)))

    @jax.jit
    def vjp(i, x, y, gg):
        return jax.vjp(jax.vmap(JW._bilinear_sample), i, x, y)[1](gg)

    want = vjp(*(jnp.asarray(a) for a in (imgs, xs, ys, g)))
    for got, ref in zip((d_img, d_xs, d_ys), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_strong_minification_takes_the_direct_path_everywhere():
    """A grid that shrinks 3x (its first row just above the image) gives
    every tile a footprint of more than WINDOW_CELLS pixels; the
    emulation's direct path alone still matches autograd."""
    rng = np.random.default_rng(11)
    n, h, w, c, oh, ow = 1, 100, 100, 3, 32, 32
    oy, ox = np.mgrid[0:oh, 0:ow].astype(np.float32)
    xs = (3.0 * ox + 2.5)[None].copy()
    ys = (3.0 * oy - 1.5)[None].copy()
    imgs = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    g = rng.normal(size=(n, oh, ow, c)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (imgs, xs, ys, g)]
    assert not bool(WC.tile_footprints(*args[1:3], h, w, c)[1].any())
    d_img, d_xs, d_ys = _emulate(*args)
    leaves = [t.clone().requires_grad_(True) for t in args[:3]]
    grads = torch.autograd.grad(TW._bilinear_sample(*leaves), leaves, args[3])
    for got, want in zip((d_img, d_xs, d_ys), grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
