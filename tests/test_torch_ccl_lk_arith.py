"""The arithmetic that kernels A (`csrc/ccl.cu`) and B (`csrc/lk.cu`) rest
on where they work otherwise than their plain versions in
`ops/ccl_cuda.py` and `ops/lk_cuda.py`, checked over every value it can
meet, on the CPU:

  * A labels 2 x 2 pixel blocks: their foreground pixels are one
    component under 8-connectivity, the four rules by which a block joins
    its W, NW, N and NE neighbours (read from the source) say exactly
    whether a foreground pixel of each touches, and the per-block
    statistics (box, area, first pixel; read from the source) are those
    of the block's foreground pixels;
  * B sums a thread's products in int32: the bilinear weights, the
    Scharr derivatives, the window values and derivatives stay within the
    bounds `lk_cuda` states, so those sums cannot overflow; the launcher
    has a form for each window size.

Those kernels replace cv2 calls that reach no JAX code, so the reference
here is the plain versions' own arithmetic and brute force.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest
import torch

from faceoff_tpu_torch.ops import ccl_cuda as A
from faceoff_tpu_torch.ops import lk_cuda as B
from faceoff_tpu_torch.preprocess.imgproc import scharr_deriv

CCL_SRC = A.SOURCE.read_text()
LK_SRC = B.SOURCE.read_text()
# the pixels of a block by bit: 1 top left, 2 top right, 4 bottom left, 8
# bottom right, as (row, column) in the block
PIXELS = {1: (0, 0), 2: (0, 1), 4: (1, 0), 8: (1, 1)}
# a neighbour block's offset (rows, columns) for each rule
NEIGHBOURS = {"w": (0, -1), "nw": (-1, -1), "n": (-1, 0), "ne": (-1, 1)}


def _pixels(bits, dy=0, dx=0):
    return [(2 * dy + r, 2 * dx + c) for b, (r, c) in PIXELS.items()
            if bits & b]


def _touch(p, q):
    return max(abs(p[0] - q[0]), abs(p[1] - q[1])) == 1


def test_a_block_is_one_component():
    for bits in range(1, 16):
        px = _pixels(bits)
        assert all(_touch(p, q) for p in px for q in px if p != q)


@pytest.mark.parametrize("name", sorted(NEIGHBOURS))
def test_a_block_links_equal_pixel_adjacency(name):
    """linked_<name>(me, nb) in ccl.cu, over all 16 x 16 pairs of block
    patterns, against whether some foreground pixel of each block is
    8-adjacent to some of the other."""
    m = re.search(rf"bool linked_{name}\(int me, int nb\) \{{\s*return "
                  rf"\(me & (\d+)\) && \(nb & (\d+)\);", CCL_SRC)
    assert m, f"linked_{name} not found in {A.SOURCE}"
    mine, theirs = int(m.group(1)), int(m.group(2))
    dy, dx = NEIGHBOURS[name]
    for me in range(16):
        for nb in range(16):
            rule = bool(me & mine) and bool(nb & theirs)
            brute = any(_touch(p, q) for p in _pixels(me)
                        for q in _pixels(nb, dy, dx))
            assert rule == brute, (name, me, nb)


def test_a_looking_back_covers_every_neighbour():
    """The four rules look back (W, NW, N, NE); the other four neighbours
    (E, SE, S, SW) are those of the blocks that look back at this one."""
    back = set(NEIGHBOURS.values())
    ahead = {(-dy, -dx) for dy, dx in back}
    ring = {(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)} - {(0, 0)}
    assert back | ahead == ring and not back & ahead


def test_a_block_statistics():
    """local_kernel's box offsets (v0..v3), area (__popc) and first pixel
    of a block, as written in ccl.cu, against its foreground pixels."""
    offsets = {}
    for m in re.finditer(r"const int v(\d) = ([xy]) \+ \(\(me & (\d+)\) \? "
                         r"(\d) : (\d)\);", CCL_SRC):
        offsets[int(m.group(1))] = (m.group(2), int(m.group(3)),
                                    int(m.group(4)), int(m.group(5)))
    assert sorted(offsets) == [0, 1, 2, 3]
    m = re.search(r"const int first = \(me & (\d+)\) \? \(\(me & (\d+)\) \? x "
                  r": x \+ 1\)\s*: \(\(me & (\d+)\) \? x : x \+ 1\);", CCL_SRC)
    assert m, "local_kernel's first pixel not found"
    top, top_left, bottom_left = (int(v) for v in m.groups())
    assert "const int v4 = __popc(me);" in CCL_SRC
    for bits in range(1, 16):
        px = _pixels(bits)
        rows, cols = [p[0] for p in px], [p[1] for p in px]
        want = {0: min(cols), 1: min(rows), 2: max(cols), 3: max(rows)}
        for v, (_, mask, hit, miss) in offsets.items():
            assert (hit if bits & mask else miss) == want[v], (v, bits)
        row = 0 if bits & top else 1
        col = (0 if bits & top_left else 1) if row == 0 else (
            0 if bits & bottom_left else 1)
        assert (row, col) == min(px), bits
        assert bin(bits).count("1") == len(px)


def test_a_block_index_is_cv2_key():
    """A block's index within its frame is the cv2 label-order key of each
    of its pixels, so a component's smallest block index is its key."""
    for h, w in ((1, 1), (5, 7), (6, 9), (37, 53)):
        bw = (w + 1) // 2
        ys, xs = np.mgrid[0:h, 0:w]
        assert np.array_equal((ys // 2) * bw + xs // 2,
                              (ys // 2) * ((w + 1) // 2) + xs // 2)
        assert ((h + 1) // 2) * bw >= ((ys // 2) * bw + xs // 2).max() + 1


@functools.lru_cache(maxsize=1)
def _weight_grid():
    """lk_cuda._weights (the float steps both versions run) over a grid of
    2^-9 in a and b, random fractions, and the edges of [0, 1)."""
    g = torch.arange(512, dtype=torch.float32) / 512
    a, b = torch.meshgrid(g, g, indexing="ij")
    gen = torch.Generator().manual_seed(0)
    r = torch.rand((2, 1 << 18), generator=gen)
    edge = torch.tensor([0.0, 2.0 ** -24, 2.0 ** -14, 0.25, 0.5,
                         1 - 2.0 ** -24, 1 - 2.0 ** -14], dtype=torch.float32)
    ea, eb = torch.meshgrid(edge, edge, indexing="ij")
    a = torch.cat([a.reshape(-1), r[0], ea.reshape(-1)])
    b = torch.cat([b.reshape(-1), r[1], eb.reshape(-1)])
    return torch.stack(B._weights(a, b), 1)


def test_b_weight_bounds():
    w = _weight_grid()
    one = 1 << B.W_BITS
    assert torch.equal(w.sum(1), torch.full_like(w[:, 0], one))
    assert int(w[:, :3].min()) >= 0 and int(w.max()) <= one
    assert int(w[:, 3].min()) == B.WEIGHT_MIN
    assert int(w.abs().sum(1).max()) <= B.WEIGHT_ABS_SUM_MAX
    assert int(w.clamp(min=0).sum(1).max()) <= one + 1


def test_b_derivative_bound_holds_and_is_reached():
    gen = torch.Generator().manual_seed(1)
    noise = torch.randint(0, 256, (8, 40, 50), generator=gen,
                          dtype=torch.uint8)
    step = torch.zeros((2, 16, 16), dtype=torch.uint8)
    step[0, :, 8:] = 255  # a vertical edge: d/dx
    step[1, 8:, :] = 255  # a horizontal edge: d/dy
    d_noise, d_step = scharr_deriv(noise), scharr_deriv(step)
    assert int(d_noise.abs().max()) <= B.DERIV_MAX
    assert int(d_step[0, ..., 0].abs().max()) == B.DERIV_MAX == 16 * 255
    assert int(d_step[1, ..., 1].abs().max()) == B.DERIV_MAX


def _corners(lo, hi):
    """Every assignment of lo or hi to the four corners: (16, 4)."""
    bits = torch.arange(16)[:, None] >> torch.arange(4) & 1
    return torch.where(bits.bool(), hi, lo).to(torch.int64)


def test_b_window_value_and_derivative_bounds():
    """The descaled interpolation of a window value (by 9 bits) lies in
    [0, IVAL_MAX] and of a derivative (by 14) within IDER_MAX, for every
    weight set of the grid at the extreme corners; IVAL_MAX is reached."""
    w = torch.unique(_weight_grid(), dim=0)
    img = _corners(0, 255) @ w.T
    ival = B._descale(img, B.W_BITS - 5)
    assert int(ival.min()) >= 0 and int(ival.max()) == B.IVAL_MAX == 8160
    der = B._descale(_corners(-B.DERIV_MAX, B.DERIV_MAX) @ w.T, B.W_BITS)
    assert int(der.abs().max()) <= B.IDER_MAX
    assert B.PRODUCT_MAX == B.IVAL_MAX * B.IDER_MAX >= B.IDER_MAX ** 2
    # the 32-bit interpolation sums before descaling
    assert 255 * ((1 << B.W_BITS) + 1) <= B.INT32_MAX
    assert B.DERIV_MAX * B.WEIGHT_ABS_SUM_MAX <= B.INT32_MAX


@pytest.mark.parametrize("kpl", [4, 8])
def test_b_thread_sums_fit_int32(kpl):
    """A thread's sum of kpl products (lk.cu adds them in int32) is at most
    kpl * PRODUCT_MAX in magnitude, within int32, for each window size the
    wrapper gives that kpl."""
    assert kpl * B.PRODUCT_MAX <= B.INT32_MAX
    assert kpl in {B.lane_pixels(win) for win in range(1, 33)}


def test_b_launcher_has_a_form_for_every_window():
    """lane_pixels covers every window of up to 32 x 32 with lk.cu's warps
    a point, and lk.cu's launcher has a kernel for each pixels-a-thread
    count that the wrapper passes."""
    m = re.search(r"constexpr int kWarpsPerPoint = (\d+);", LK_SRC)
    assert m and int(m.group(1)) == B.POINT_WARPS
    forms = {int(k) for k in re.findall(r"if \(kpl == (\d+)\)", LK_SRC)}
    for win in range(1, 33):
        kpl = B.lane_pixels(win)
        assert 32 * B.POINT_WARPS * kpl >= win * win
        assert kpl in forms


@pytest.mark.parametrize("kpl", [4, 8])
def test_b_thread_sum_in_int32_is_exact(kpl):
    """kpl products at the bound, of both signs and mixed, added one by one
    in int32 as lk.cu adds them, equal their exact sum: no partial sum
    wraps."""
    rng = np.random.default_rng(2)
    cases = [np.full(kpl, B.PRODUCT_MAX), np.full(kpl, -B.PRODUCT_MAX),
             np.where(np.arange(kpl) % 2, B.PRODUCT_MAX, -B.PRODUCT_MAX),
             rng.integers(-B.PRODUCT_MAX, B.PRODUCT_MAX + 1, kpl)]
    for v in cases:
        acc = np.int32(0)
        for x in v.astype(np.int32):
            wide = int(acc) + int(x)
            assert abs(wide) <= B.INT32_MAX
            acc = np.int32(wide)
        assert int(acc) == int(v.astype(np.int64).sum())
