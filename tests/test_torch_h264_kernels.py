"""The plain versions of the H.264 decoder's four device stages
(`ops/h264_cuda.py`: H1 residual, H2 inter_predict, H3
intra_reconstruct, H4 deblock) against numpy transcriptions of the
standard's equations (ITU-T H.264, 8.3, 8.4.2.2, 8.5, 8.7), on the CPU.
Tolerance 0: every stage is integer arithmetic.

  * H1: 8.5.12.1's scaling with both qP branches (the plain version's
    c * v << qP/6 is exact for flat matrices), the Intra16x16 DC
    Hadamard and its qP < 36 rounding, the chroma DC 2x2 transform,
    Table 8-15 with chroma_qp_index_offset, at QP 0 and 51;
  * H2: all 16 luma quarter positions (the centre from unrounded
    intermediates, taken here from the vertical ones across) and the
    eighth-pel chroma filter, with vectors crossing every picture edge;
  * H3: the literal raster-order loop of Intra4x4 (blocks in decoding
    order, 6.4.12's neighbours, the top-right rules), Intra16x16, chroma
    and I_PCM, against the wave-vectorised plain version, on pictures
    with slices, constrained intra prediction and every mode;
  * H4: one edge at each bS 1-4 (luma and chroma), and the literal
    raster-order filter loop against the wave-vectorised plain version;
  * the wrappers refuse tensors that are not on the card once a kernel
    is asked for.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from faceoff_tpu_torch.io import mpeg4
from faceoff_tpu_torch.ops import h264_cuda as K

CPU = torch.device("cpu")

# 8.5.9's normAdjust4x4 values v (m = qP % 6; columns: both indices even,
# both odd, otherwise) and Table 8-15, written out from the standard
V = [[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18], [16, 25, 20],
     [18, 29, 23]]
QPC = list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37,
                         37, 37, 38, 38, 38, 39, 39, 39, 39]
ALPHA = [0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
                    32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127,
                    144, 162, 182, 203, 226, 255, 255]
BETA = [0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10,
                   10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                   17, 18, 18]
TC0 = ([[0, 0, 0]] * 17 + [[0, 0, 1]] * 4 + [[0, 1, 1]] * 2 + [[1, 1, 1]] * 4
       + [[1, 1, 2]] * 4 + [[1, 2, 3]] * 2
       + [[2, 2, 3], [2, 2, 4], [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6],
          [3, 4, 6], [4, 5, 7], [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11],
          [6, 8, 13], [7, 10, 14], [8, 11, 16], [9, 12, 18], [10, 13, 20],
          [11, 15, 23], [13, 17, 25]])
ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
BLK_XY = [(0, 0), (4, 0), (0, 4), (4, 4), (8, 0), (12, 0), (8, 4), (12, 4),
          (0, 8), (4, 8), (0, 12), (4, 12), (8, 8), (12, 8), (8, 12),
          (12, 12)]


@pytest.fixture(autouse=True)
def one_thread():
    with mpeg4.plain_threads(CPU):
        yield


def clip1(x):
    return min(max(int(x), 0), 255)


def clip3(lo, hi, x):
    return min(max(int(x), lo), hi)


# -- H1 ------------------------------------------------------------------------


def level_scale(m, i, j):
    """LevelScale4x4 with the flat weightScale 16 (8.5.9)."""
    k = 0 if i % 2 == 0 and j % 2 == 0 else (1 if i % 2 and j % 2 else 2)
    return 16 * V[m][k]


def scale_4x4(c, qp, skip_dc):
    """8.5.12.1: d from levels c (4x4, raster), d[0][0] left to the
    caller where skip_dc."""
    d = np.zeros((4, 4), np.int64)
    for i in range(4):
        for j in range(4):
            if i == 0 and j == 0 and skip_dc:
                continue
            ls = level_scale(qp % 6, i, j)
            if qp >= 24:
                d[i, j] = (int(c[i, j]) * ls) << (qp // 6 - 4)
            else:
                d[i, j] = (int(c[i, j]) * ls + (1 << (3 - qp // 6))) >> (
                    4 - qp // 6)
    return d


def transform_4x4(d):
    """8.5.12.2, then (h + 2^5) >> 6."""
    f = np.zeros((4, 4), np.int64)
    for i in range(4):
        e = d[i, 0] + d[i, 2]
        ff = d[i, 0] - d[i, 2]
        g = (d[i, 1] >> 1) - d[i, 3]
        h = d[i, 1] + (d[i, 3] >> 1)
        f[i] = [e + h, ff + g, ff - g, e - h]
    r = np.zeros((4, 4), np.int64)
    for j in range(4):
        g_ = f[0, j] + f[2, j]
        h_ = f[0, j] - f[2, j]
        i_ = (f[1, j] >> 1) - f[3, j]
        j_ = f[1, j] + (f[3, j] >> 1)
        r[:, j] = [g_ + j_, h_ + i_, h_ - i_, g_ - j_]
    return (r + 32) >> 6


def luma_dc(c, qp):
    """8.5.10: the Intra16x16 DC Hadamard and scaling."""
    h = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                  [1, -1, 1, -1]], np.int64)
    f = h @ c.astype(np.int64) @ h
    ls = level_scale(qp % 6, 0, 0)
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    return (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def chroma_dc(c, qpc):
    """8.5.11: the 2x2 transform and scaling (4:2:0)."""
    h = np.array([[1, 1], [1, -1]], np.int64)
    f = h @ c.astype(np.int64) @ h
    return ((f * level_scale(qpc % 6, 0, 0)) << (qpc // 6)) >> 5


def residual_reference(coef, bmap, mb, mbw):
    """H1 literally, macroblock by macroblock."""
    n, m, _ = bmap.shape
    mbh = m // mbw
    ry = np.zeros((n, 16 * mbh, 16 * mbw), np.int64)
    rc = np.zeros((n, 2, 8 * mbh, 8 * mbw), np.int64)

    def block(f, a, b):
        k = bmap[f, a, b]
        return coef[k].reshape(4, 4).astype(np.int64) if k >= 0 else \
            np.zeros((4, 4), np.int64)

    for f in range(n):
        for a in range(m):
            kind, qp = mb[f, a, K.F_KIND], mb[f, a, K.F_QP]
            if kind in (K.H_SKIP, K.H_PCM):
                continue
            x0, y0 = 16 * (a % mbw), 16 * (a // mbw)
            dc = luma_dc(block(f, a, 16), qp) if kind == K.H_I16 else None
            for b in range(16):
                bx, by = b % 4, b // 4
                d = scale_4x4(block(f, a, b), qp, dc is not None)
                if dc is not None:
                    d[0, 0] = dc[by, bx]
                ry[f, y0 + 4 * by: y0 + 4 * by + 4,
                   x0 + 4 * bx: x0 + 4 * bx + 4] = transform_4x4(d)
            qpc = QPC[clip3(0, 51, qp + mb[f, a, K.F_QPC])]
            for c in range(2):
                cdc = chroma_dc(block(f, a, 17 + c)[0].reshape(2, 2), qpc)
                for j in range(4):
                    d = scale_4x4(block(f, a, 19 + 4 * c + j), qpc, True)
                    d[0, 0] = cdc[j // 2, j % 2]
                    yy, xx = y0 // 2 + 4 * (j // 2), x0 // 2 + 4 * (j % 2)
                    rc[f, c, yy: yy + 4, xx: xx + 4] = transform_4x4(d)
    return ry, rc


def test_residual_by_hand():
    """Every macroblock kind at QPs 0-51 (0 and 51 included) with random
    levels, the chroma QP offset from -12 to 12: the plain H1 equals
    8.5.10-12 as written."""
    rng = np.random.default_rng(0)
    mbw, n = 3, 3
    m = 2 * mbw
    mb = np.zeros((n, m, K.MB_FIELDS), np.int32)
    mb[..., K.F_KIND] = rng.choice([K.H_SKIP, K.H_INTER, K.H_I4, K.H_I16,
                                    K.H_PCM], (n, m), p=[.1, .3, .2, .3, .1])
    mb[..., K.F_QP] = rng.integers(0, 52, (n, m))
    mb[0, :2, K.F_QP] = [0, 51]
    mb[..., K.F_QPC] = rng.integers(-12, 13, (n, m))
    present = rng.random((n, m, K.NBLK)) < 0.6
    bmap = np.where(present, np.cumsum(present).reshape(present.shape) - 1,
                    -1).astype(np.int32)
    coef = rng.integers(-60, 61, (int(present.sum()), 16)).astype(np.int16)
    coef[rng.random(coef.shape) < 0.5] = 0
    ry, rc = K.residual_plain(torch.from_numpy(coef), torch.from_numpy(bmap),
                              torch.from_numpy(mb), mbw)
    want_y, want_c = residual_reference(coef, bmap, mb, mbw)
    np.testing.assert_array_equal(ry.numpy(), want_y)
    np.testing.assert_array_equal(rc.numpy(), want_c)
    assert (mb[..., K.F_KIND] == K.H_I16).sum() >= 2


# -- H2 ------------------------------------------------------------------------


def luma_pred(ref, x_int, y_int, fx, fy):
    """8.4.2.2.1 for one sample, positions clamped to the picture; j from
    the vertical intermediates cc, dd, h1, m1, ee, ff."""
    h, w = ref.shape

    def p(x, y):
        return int(ref[clip3(0, h - 1, y), clip3(0, w - 1, x)])

    def tap(v):
        return v[0] - 5 * v[1] + 20 * v[2] + 20 * v[3] - 5 * v[4] + v[5]

    def vert(x):
        return tap([p(x, y_int + k) for k in range(-2, 4)])

    G, H, M = p(x_int, y_int), p(x_int + 1, y_int), p(x_int, y_int + 1)
    b1 = tap([p(x_int + k, y_int) for k in range(-2, 4)])
    s1 = tap([p(x_int + k, y_int + 1) for k in range(-2, 4)])
    h1, m1 = vert(x_int), vert(x_int + 1)
    j1 = tap([vert(x_int + k) for k in range(-2, 4)])
    b, h_, s = clip1((b1 + 16) >> 5), clip1((h1 + 16) >> 5), \
        clip1((s1 + 16) >> 5)
    m_, j = clip1((m1 + 16) >> 5), clip1((j1 + 512) >> 10)
    named = {
        (0, 0): G, (0, 1): (G + h_ + 1) >> 1, (0, 2): h_,
        (0, 3): (M + h_ + 1) >> 1, (1, 0): (G + b + 1) >> 1,
        (1, 1): (b + h_ + 1) >> 1, (1, 2): (h_ + j + 1) >> 1,
        (1, 3): (h_ + s + 1) >> 1, (2, 0): b, (2, 1): (b + j + 1) >> 1,
        (2, 2): j, (2, 3): (j + s + 1) >> 1, (3, 0): (H + b + 1) >> 1,
        (3, 1): (b + m_ + 1) >> 1, (3, 2): (j + m_ + 1) >> 1,
        (3, 3): (m_ + s + 1) >> 1}
    return named[(fx, fy)]


def chroma_pred(ref, x_int, y_int, fx, fy):
    """8.4.2.2.2 for one sample."""
    h, w = ref.shape

    def p(x, y):
        return int(ref[clip3(0, h - 1, y), clip3(0, w - 1, x)])

    return ((8 - fx) * (8 - fy) * p(x_int, y_int)
            + fx * (8 - fy) * p(x_int + 1, y_int)
            + (8 - fx) * fy * p(x_int, y_int + 1)
            + fx * fy * p(x_int + 1, y_int + 1) + 32) >> 6


@pytest.mark.parametrize("mbw,mbh", [(2, 2), (3, 1)])
def test_inter_prediction_by_hand(mbw, mbh):
    """Every (xFrac, yFrac) of luma and every chroma phase, vectors
    reaching 1-48 px past each edge of the coded picture, two reference
    slots, skipped and intra macroblocks left alone: the plain H2 equals
    8.4.2.2 plus the residual, clipped."""
    rng = np.random.default_rng(mbw * 10 + mbh)
    m = mbw * mbh
    hl, wl = 16 * mbh, 16 * mbw
    planes = [torch.from_numpy(rng.integers(0, 256, (3, hl // s, wl // s))
                               .astype(np.uint8)) for s in (1, 2, 2)]
    mb = np.zeros((m, K.MB_FIELDS), np.int32)
    mb[:, K.F_KIND] = K.H_INTER
    mb[0, K.F_KIND] = K.H_SKIP
    mb[-1, K.F_KIND] = K.H_I4 if m > 2 else K.H_INTER
    blk = np.zeros((m, 16, 4), np.int32)
    phase = np.arange(m * 16) % 16
    reach = rng.integers(1, 49, m * 16) * rng.choice([-1, 1], m * 16)
    blk[..., 0] = (4 * (reach + (rng.random(m * 16) < 0.5) * wl)
                   + phase // 4).reshape(m, 16)
    blk[..., 1] = (4 * rng.integers(-60, 60, m * 16) + phase % 4).reshape(
        m, 16)
    blk[..., 2] = rng.integers(0, 2, (m, 16))
    ry = rng.integers(-30, 31, (hl, wl)).astype(np.int16)
    rc = rng.integers(-30, 31, (2, hl // 2, wl // 2)).astype(np.int16)
    before = [p.clone() for p in planes]
    K.inter_predict_plain(planes, 2, torch.from_numpy(mb),
                          torch.from_numpy(blk), torch.from_numpy(ry),
                          torch.from_numpy(rc), mbw)
    want = [p[2].numpy().copy() for p in before]
    for a in range(m):
        if mb[a, K.F_KIND] > K.H_INTER:
            continue
        x0, y0 = 16 * (a % mbw), 16 * (a // mbw)
        for yy in range(16):
            for xx in range(16):
                mvx, mvy, slot, _ = blk[a, (yy // 4) * 4 + xx // 4]
                ref = before[0][slot].numpy()
                X, Y = x0 + xx, y0 + yy
                want[0][Y, X] = clip1(luma_pred(ref, X + (mvx >> 2),
                                                Y + (mvy >> 2), mvx & 3,
                                                mvy & 3) + ry[Y, X])
        for c in range(2):
            for yy in range(8):
                for xx in range(8):
                    mvx, mvy, slot, _ = blk[a, (yy // 2) * 4 + xx // 2]
                    ref = before[1 + c][slot].numpy()
                    X, Y = x0 // 2 + xx, y0 // 2 + yy
                    want[1 + c][Y, X] = clip1(chroma_pred(
                        ref, X + (mvx >> 3), Y + (mvy >> 3), mvx & 7,
                        mvy & 7) + rc[c, Y, X])
    for p, w in zip(planes, want):
        np.testing.assert_array_equal(p[2].numpy(), w)
    assert {(v[0] & 3, v[1] & 3) for v in blk.reshape(-1, 4)} == {
        (a, b) for a in range(4) for b in range(4)}


# -- H3 ------------------------------------------------------------------------


class IntraPicture:
    """The literal raster-order intra reconstruction (8.3) of one picture:
    neighbouring samples by 6.4.12, marked not available per 8.3.1.2,
    8.3.3 and 8.3.4."""

    def __init__(self, planes, mb, pcm, ry, rc, mbw):
        self.y, self.u, self.v = planes
        self.mb, self.pcm, self.ry, self.rc, self.w = mb, pcm, ry, rc, mbw
        self.h = len(mb) // mbw

    def mb_at(self, a, xn, yn, size):
        """mbAddrN of luma/chroma location (xn, yn) relative to macroblock
        a (6.4.12), or None where not available (8.3.1.2 etc.)."""
        if yn > size - 1 or (xn > size - 1 and yn >= 0):
            return None
        x, y = a % self.w, a // self.w
        dx = -1 if xn < 0 else (1 if xn > size - 1 else 0)
        dy = -1 if yn < 0 else 0
        if dx == 0 and dy == 0:
            return a
        nx, ny = x + dx, y + dy
        if not (0 <= nx < self.w and 0 <= ny < self.h):
            return None
        n = ny * self.w + nx
        if self.mb[n, K.F_SLICE] != self.mb[a, K.F_SLICE]:
            return None
        if self.mb[a, K.F_CIP] and self.mb[n, K.F_KIND] <= K.H_INTER:
            return None
        return n

    def sample(self, plane, a, xn, yn, size):
        if self.mb_at(a, xn, yn, size) is None:
            return None
        x0, y0 = size * (a % self.w), size * (a // self.w)
        return int(plane[y0 + yn, x0 + xn])

    def run(self):
        for a in range(len(self.mb)):
            kind = self.mb[a, K.F_KIND]
            x0, y0 = 16 * (a % self.w), 16 * (a // self.w)
            if kind == K.H_PCM:
                s = self.pcm[self.mb[a, K.F_PCM]]
                self.y[y0: y0 + 16, x0: x0 + 16] = s[:256].reshape(16, 16)
                self.u[y0 // 2: y0 // 2 + 8, x0 // 2: x0 // 2 + 8] = \
                    s[256:320].reshape(8, 8)
                self.v[y0 // 2: y0 // 2 + 8, x0 // 2: x0 // 2 + 8] = \
                    s[320:].reshape(8, 8)
            elif kind == K.H_I4:
                self.intra4(a, x0, y0)
                self.chroma(a)
            elif kind == K.H_I16:
                self.intra16(a, x0, y0)
                self.chroma(a)

    def intra4(self, a, x0, y0):
        modes = int(self.mb[a, K.F_MODES]) & 0xFFFFFFFF, \
            int(self.mb[a, K.F_MODES_HI]) & 0xFFFFFFFF
        for idx, (xo, yo) in enumerate(BLK_XY):
            b = (yo // 4) * 4 + xo // 4
            mode = (modes[b // 8] >> (4 * (b % 8))) & 15

            def P(x, y):
                if x > 3 and idx in (3, 11):
                    return None
                return self.sample(self.y, a, xo + x, yo + y, 16)

            top = [P(x, -1) for x in range(8)]
            if all(t is None for t in top[4:]) and top[3] is not None:
                top[4:] = [top[3]] * 4
            left = [P(-1, y) for y in range(4)]
            tl = P(-1, -1)

            def p(x, y):
                v = tl if (x, y) == (-1, -1) else (
                    top[x] if y == -1 else left[y])
                assert v is not None, (a, idx, mode, x, y)
                return v

            pred = np.zeros((4, 4), np.int64)
            for y in range(4):
                for x in range(4):
                    pred[y, x] = self.i4_sample(mode, p, x, y, top, left)
            yy, xx = y0 + yo, x0 + xo
            blk = pred + self.ry[yy: yy + 4, xx: xx + 4]
            self.y[yy: yy + 4, xx: xx + 4] = np.clip(blk, 0, 255)

    @staticmethod
    def i4_sample(mode, p, x, y, top, left):
        if mode == 0:
            return p(x, -1)
        if mode == 1:
            return p(-1, y)
        if mode == 2:
            t_ok = all(t is not None for t in top[:4])
            l_ok = all(t is not None for t in left)
            if t_ok and l_ok:
                return (sum(top[:4]) + sum(left) + 4) >> 3
            if l_ok:
                return (sum(left) + 2) >> 2
            if t_ok:
                return (sum(top[:4]) + 2) >> 2
            return 128
        if mode == 3:
            if x == 3 and y == 3:
                return (p(6, -1) + 3 * p(7, -1) + 2) >> 2
            return (p(x + y, -1) + 2 * p(x + y + 1, -1) + p(x + y + 2, -1)
                    + 2) >> 2
        if mode == 4:
            if x > y:
                return (p(x - y - 2, -1) + 2 * p(x - y - 1, -1)
                        + p(x - y, -1) + 2) >> 2
            if x < y:
                return (p(-1, y - x - 2) + 2 * p(-1, y - x - 1)
                        + p(-1, y - x) + 2) >> 2
            return (p(0, -1) + 2 * p(-1, -1) + p(-1, 0) + 2) >> 2
        if mode == 5:
            z = 2 * x - y
            if z >= 0 and z % 2 == 0:
                return (p(x - (y >> 1) - 1, -1) + p(x - (y >> 1), -1)
                        + 1) >> 1
            if z > 0:
                return (p(x - (y >> 1) - 2, -1) + 2 * p(x - (y >> 1) - 1, -1)
                        + p(x - (y >> 1), -1) + 2) >> 2
            if z == -1:
                return (p(-1, 0) + 2 * p(-1, -1) + p(0, -1) + 2) >> 2
            return (p(-1, y - 1) + 2 * p(-1, y - 2) + p(-1, y - 3) + 2) >> 2
        if mode == 6:
            z = 2 * y - x
            if z >= 0 and z % 2 == 0:
                return (p(-1, y - (x >> 1) - 1) + p(-1, y - (x >> 1))
                        + 1) >> 1
            if z > 0:
                return (p(-1, y - (x >> 1) - 2) + 2 * p(-1, y - (x >> 1) - 1)
                        + p(-1, y - (x >> 1)) + 2) >> 2
            if z == -1:
                return (p(-1, 0) + 2 * p(-1, -1) + p(0, -1) + 2) >> 2
            return (p(x - 1, -1) + 2 * p(x - 2, -1) + p(x - 3, -1) + 2) >> 2
        if mode == 7:
            if y in (0, 2):
                return (p(x + (y >> 1), -1) + p(x + (y >> 1) + 1, -1)
                        + 1) >> 1
            return (p(x + (y >> 1), -1) + 2 * p(x + (y >> 1) + 1, -1)
                    + p(x + (y >> 1) + 2, -1) + 2) >> 2
        z = x + 2 * y
        if z in (0, 2, 4):
            return (p(-1, y + (x >> 1)) + p(-1, y + (x >> 1) + 1) + 1) >> 1
        if z in (1, 3):
            return (p(-1, y + (x >> 1)) + 2 * p(-1, y + (x >> 1) + 1)
                    + p(-1, y + (x >> 1) + 2) + 2) >> 2
        if z == 5:
            return (p(-1, 2) + 3 * p(-1, 3) + 2) >> 2
        return p(-1, 3)

    def intra16(self, a, x0, y0):
        mode = self.mb[a, K.F_I16]
        top = [self.sample(self.y, a, x, -1, 16) for x in range(16)]
        left = [self.sample(self.y, a, -1, y, 16) for y in range(16)]
        tl = self.sample(self.y, a, -1, -1, 16)
        t_ok, l_ok = top[0] is not None, left[0] is not None
        pred = np.zeros((16, 16), np.int64)
        for y in range(16):
            for x in range(16):
                if mode == 0:
                    pred[y, x] = top[x]
                elif mode == 1:
                    pred[y, x] = left[y]
                elif mode == 2:
                    pred[y, x] = ((sum(top) + sum(left) + 16) >> 5
                                  if t_ok and l_ok else
                                  (sum(left) + 8) >> 4 if l_ok else
                                  (sum(top) + 8) >> 4 if t_ok else 128)
                else:
                    def pt(i):
                        return tl if i < 0 else top[i]

                    def pl(i):
                        return tl if i < 0 else left[i]
                    hh = sum((i + 1) * (pt(8 + i) - pt(6 - i))
                             for i in range(8))
                    vv = sum((i + 1) * (pl(8 + i) - pl(6 - i))
                             for i in range(8))
                    aa = 16 * (left[15] + top[15])
                    bb, cc = (5 * hh + 32) >> 6, (5 * vv + 32) >> 6
                    pred[y, x] = clip1((aa + bb * (x - 7) + cc * (y - 7)
                                        + 16) >> 5)
        blk = pred + self.ry[y0: y0 + 16, x0: x0 + 16]
        self.y[y0: y0 + 16, x0: x0 + 16] = np.clip(blk, 0, 255)

    def chroma(self, a):
        mode = self.mb[a, K.F_CMODE]
        x0, y0 = 8 * (a % self.w), 8 * (a // self.w)
        for c, plane in enumerate((self.u, self.v)):
            top = [self.sample(plane, a, x, -1, 8) for x in range(8)]
            left = [self.sample(plane, a, -1, y, 8) for y in range(8)]
            tl = self.sample(plane, a, -1, -1, 8)
            t_ok, l_ok = top[0] is not None, left[0] is not None
            pred = np.zeros((8, 8), np.int64)
            for y in range(8):
                for x in range(8):
                    if mode == 0:
                        xo, yo = 4 * (x // 4), 4 * (y // 4)
                        st = sum(top[xo: xo + 4]) if t_ok else 0
                        sl = sum(left[yo: yo + 4]) if l_ok else 0
                        if (xo, yo) in ((0, 0), (4, 4)):
                            v = ((st + sl + 4) >> 3 if t_ok and l_ok else
                                 (sl + 2) >> 2 if l_ok else
                                 (st + 2) >> 2 if t_ok else 128)
                        elif yo == 0:
                            v = ((st + 2) >> 2 if t_ok else
                                 (sl + 2) >> 2 if l_ok else 128)
                        else:
                            v = ((sl + 2) >> 2 if l_ok else
                                 (st + 2) >> 2 if t_ok else 128)
                        pred[y, x] = v
                    elif mode == 1:
                        pred[y, x] = left[y]
                    elif mode == 2:
                        pred[y, x] = top[x]
                    else:
                        def pt(i):
                            return tl if i < 0 else top[i]

                        def pl(i):
                            return tl if i < 0 else left[i]
                        hh = sum((i + 1) * (pt(4 + i) - pt(2 - i))
                                 for i in range(4))
                        vv = sum((i + 1) * (pl(4 + i) - pl(2 - i))
                                 for i in range(4))
                        aa = 16 * (left[7] + top[7])
                        bb, cc = (34 * hh + 32) >> 6, (34 * vv + 32) >> 6
                        pred[y, x] = clip1((aa + bb * (x - 3) + cc * (y - 3)
                                            + 16) >> 5)
            blk = pred + self.rc[c, y0: y0 + 8, x0: x0 + 8]
            plane[y0: y0 + 8, x0: x0 + 8] = np.clip(blk, 0, 255)


def _i4_modes(rng, avail_a, avail_b, avail_c, avail_d, cover):
    """Random Intra4x4 modes (raster order) that use only available
    samples: per block the modes whose neighbours exist, cycling through
    `cover` first so that every mode occurs."""
    modes = [0] * 16
    for idx, (xo, yo) in enumerate(BLK_XY):
        bx, by = xo // 4, yo // 4
        left = bx > 0 or avail_a
        top = by > 0 or avail_b
        tl = (bx > 0 and by > 0) or (bx == 0 and by > 0 and avail_a) or (
            bx > 0 and by == 0 and avail_b) or (bx == 0 and by == 0
                                               and avail_d)
        ok = [2]
        if top:
            ok += [0, 3, 7]
        if left:
            ok += [1, 8]
        if top and left and tl:
            ok += [4, 5, 6]
        want = [m for m in cover if m in ok]
        mode = want[0] if want else int(rng.choice(ok))
        if want:
            cover.remove(mode)
        modes[by * 4 + bx] = mode
    return modes


def _intra_case(seed, mbw, mbh, cip, slices, kinds=None):
    """A random picture for H3 (records, I_PCM rows, planes, residuals):
    kinds drawn at random unless given, every intra mode chosen among
    those its available neighbours allow."""
    rng = np.random.default_rng(seed)
    m = mbw * mbh
    mb = np.zeros((m, K.MB_FIELDS), np.int32)
    drawn = rng.choice([K.H_INTER, K.H_SKIP, K.H_I4, K.H_I16, K.H_PCM], m,
                       p=[.2, .1, .35, .25, .1])
    kinds = drawn if kinds is None else np.asarray(kinds)
    mb[:, K.F_KIND] = kinds
    mb[:, K.F_CIP] = cip
    bounds = sorted(rng.choice(np.arange(1, m), slices - 1, replace=False)) \
        if slices > 1 else []
    mb[:, K.F_SLICE] = np.searchsorted(bounds, np.arange(m), side="right")
    pcm_rows = []
    cover = list(range(9))
    cover16, cover_c = list(range(4)), list(range(4))

    def pick(ok, wanted):
        want = [k for k in wanted if k in ok]
        if want:
            wanted.remove(want[0])
            return want[0]
        return int(rng.choice(ok))

    for a in range(m):
        x, y = a % mbw, a // mbw

        def ok(dx, dy):
            nx, ny = x + dx, y + dy
            if not (0 <= nx < mbw and 0 <= ny < mbh):
                return False
            n = ny * mbw + nx
            return mb[n, K.F_SLICE] == mb[a, K.F_SLICE] and not (
                cip and mb[n, K.F_KIND] <= K.H_INTER)

        av = [ok(-1, 0), ok(0, -1), ok(1, -1), ok(-1, -1)]
        if kinds[a] == K.H_PCM:
            mb[a, K.F_PCM] = len(pcm_rows)
            pcm_rows.append(rng.integers(0, 256, 384))
        if kinds[a] == K.H_I4:
            modes = _i4_modes(rng, *av, cover)
            lo = sum(modes[b] << (4 * b) for b in range(8))
            hi = sum(modes[8 + b] << (4 * b) for b in range(8))
            mb[a, K.F_MODES] = lo - (1 << 32) if lo >> 31 else lo
            mb[a, K.F_MODES_HI] = hi - (1 << 32) if hi >> 31 else hi
        if kinds[a] in (K.H_I4, K.H_I16):
            ok16 = [2] + ([0] if av[1] else []) + ([1] if av[0] else []) + (
                [3] if all(av[:2]) and av[3] else [])
            if kinds[a] == K.H_I16:
                mb[a, K.F_I16] = pick(ok16, cover16)
            mb[a, K.F_CMODE] = pick([0] + ([2] if av[1] else []) + (
                [1] if av[0] else []) + ([3] if all(av[:2]) and av[3]
                                         else []), cover_c)
    pcm = np.asarray(pcm_rows, np.uint8).reshape(-1, 384)
    hl, wl = 16 * mbh, 16 * mbw
    planes = [rng.integers(0, 256, (hl // s, wl // s)).astype(np.uint8)
              for s in (1, 2, 2)]
    ry = rng.integers(-40, 41, (hl, wl)).astype(np.int16)
    rc = rng.integers(-40, 41, (2, hl // 2, wl // 2)).astype(np.int16)
    return mb, pcm, planes, ry, rc


INTRA_CASES = [(1, 4, 3, 0, 1), (2, 5, 3, 1, 1), (3, 4, 4, 0, 3),
               (4, 3, 5, 1, 4), (5, 5, 4, 0, 2)]


@pytest.mark.parametrize("seed,mbw,mbh,cip,slices", INTRA_CASES)
def test_intra_waves_equal_the_raster_loop(seed, mbw, mbh, cip, slices):
    """Random pictures of intra (every Intra4x4, Intra16x16 and chroma
    mode the neighbours allow), inter and I_PCM macroblocks, with
    slices and constrained intra prediction: the plain H3 (waves x + 2y,
    sub-waves bx + 2by) equals the literal loop in raster order."""
    mb, pcm, planes, ry, rc = _intra_case(seed, mbw, mbh, cip, slices)
    ref = IntraPicture([p.astype(np.int64) for p in planes], mb, pcm,
                       ry.astype(np.int64), rc.astype(np.int64), mbw)
    ref.run()
    got = [torch.from_numpy(p.copy()).unsqueeze(0) for p in planes]
    K.intra_reconstruct_plain(got, 0, torch.from_numpy(mb),
                              torch.from_numpy(pcm), torch.from_numpy(ry),
                              torch.from_numpy(rc), mbw)
    for g, w in zip(got, (ref.y, ref.u, ref.v)):
        np.testing.assert_array_equal(g[0].numpy(), w)


def test_intra_cases_cover_every_mode():
    """The pictures above hold every Intra4x4 mode, every Intra16x16 and
    chroma mode, and I_PCM."""
    i4, i16, cm, pcm = set(), set(), set(), 0
    for args in INTRA_CASES:
        mb = _intra_case(*args)[0]
        for row in mb:
            if row[K.F_KIND] == K.H_I4:
                v = (int(row[K.F_MODES]) & 0xFFFFFFFF) | (
                    (int(row[K.F_MODES_HI]) & 0xFFFFFFFF) << 32)
                i4 |= {(v >> (4 * b)) & 15 for b in range(16)}
            if row[K.F_KIND] == K.H_I16:
                i16.add(int(row[K.F_I16]))
            if row[K.F_KIND] in (K.H_I4, K.H_I16):
                cm.add(int(row[K.F_CMODE]))
            pcm += row[K.F_KIND] == K.H_PCM
    assert i4 == set(range(9)) and i16 == set(range(4))
    assert cm == set(range(4)) and pcm > 0


def test_intra4_tap_table_follows_the_equations():
    """INTRA4_TAPS, which the kernel and the plain version read, gives
    8.3.1.2.1-9's samples for every mode but DC on random edges."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        edge = rng.integers(0, 256, 13)
        top, left, tl = list(edge[5:]), list(edge[3::-1]), int(edge[4])

        def p(x, y):
            return tl if (x, y) == (-1, -1) else (
                top[x] if y == -1 else left[y])

        for mode in (0, 1, 3, 4, 5, 6, 7, 8):
            for pos in range(16):
                t = K.INTRA4_TAPS[mode, pos]
                got = (edge[t[0]] * t[3] + edge[t[1]] * t[4] + edge[t[2]]
                       * t[5] + t[6]) >> t[7]
                want = IntraPicture.i4_sample(mode, p, pos % 4, pos // 4,
                                              top, left)
                assert got == want, (mode, pos)


# -- H4 ------------------------------------------------------------------------


def filter_line(p, q, bs, qpav, off_a, off_b, chroma):
    """8.7.2.3-4 on one line: p = [p0, p1, p2, p3], q = [q0, ...]; the
    filtered (p, q)."""
    ia = clip3(0, 51, qpav + off_a)
    ib = clip3(0, 51, qpav + off_b)
    alpha, beta = ALPHA[ia], BETA[ib]
    p, q = list(p), list(q)
    if not (bs > 0 and abs(p[0] - q[0]) < alpha and abs(p[1] - p[0]) < beta
            and abs(q[1] - q[0]) < beta):
        return p, q
    ap, aq = abs(p[2] - p[0]), abs(q[2] - q[0])
    out_p, out_q = list(p), list(q)
    if bs < 4:
        tc0 = TC0[ia][bs - 1]
        tc = tc0 + 1 if chroma else tc0 + (ap < beta) + (aq < beta)
        delta = clip3(-tc, tc, (((q[0] - p[0]) << 2) + (p[1] - q[1]) + 4)
                      >> 3)
        out_p[0], out_q[0] = clip1(p[0] + delta), clip1(q[0] - delta)
        if not chroma and ap < beta:
            out_p[1] = p[1] + clip3(-tc0, tc0, (p[2] + ((p[0] + q[0] + 1)
                                                        >> 1) - (p[1] << 1))
                                    >> 1)
        if not chroma and aq < beta:
            out_q[1] = q[1] + clip3(-tc0, tc0, (q[2] + ((p[0] + q[0] + 1)
                                                        >> 1) - (q[1] << 1))
                                    >> 1)
        return out_p, out_q
    small = abs(p[0] - q[0]) < ((alpha >> 2) + 2)
    for s, o in ((p, q), (q, p)):
        out = out_p if s is p else out_q
        if not chroma and abs(s[2] - s[0]) < beta and small:
            out[0] = (s[2] + 2 * s[1] + 2 * s[0] + 2 * o[0] + o[1] + 4) >> 3
            out[1] = (s[2] + s[1] + s[0] + o[0] + 2) >> 2
            out[2] = (2 * s[3] + 3 * s[2] + s[1] + s[0] + o[0] + 4) >> 3
        else:
            out[0] = (2 * s[1] + s[0] + o[1] + 2) >> 2
    return out_p, out_q


@pytest.mark.parametrize("bs", [1, 2, 3, 4])
@pytest.mark.parametrize("chroma", [False, True])
def test_one_edge_at_each_bs(bs, chroma):
    """Lines across one edge, smooth enough that the filter runs on most,
    at QPs 20-51 with offsets: filter_lines equals 8.7.2.3-4."""
    rng = np.random.default_rng(bs + 10 * chroma)
    n = 400
    base = rng.integers(40, 200, (n, 1))
    lines = np.clip(base + rng.integers(-6, 7, (n, 8))
                    + np.where(np.arange(8) >= 4, rng.integers(-9, 10, (n, 1)),
                               0), 0, 255)
    qpav = rng.integers(20, 52, n)
    off_a = rng.choice([-12, -2, 0, 2, 12], n)
    off_b = rng.choice([-12, -2, 0, 2, 12], n)
    got = K.filter_lines(torch.from_numpy(lines).int(),
                         torch.full((n,), bs, dtype=torch.int32),
                         torch.from_numpy(qpav).int(),
                         torch.from_numpy(off_a).int(),
                         torch.from_numpy(off_b).int(), chroma).numpy()
    changed = 0
    for i in range(n):
        p, q = filter_line(lines[i, 3::-1], lines[i, 4:], bs, int(qpav[i]),
                           int(off_a[i]), int(off_b[i]), chroma)
        want = list(p[::-1]) + list(q)
        np.testing.assert_array_equal(got[i], want, err_msg=f"line {i}")
        changed += want != list(lines[i])
    assert changed > n // 4


class DeblockPicture:
    """The loop filter of one picture literally (8.7): macroblocks in
    raster order, each its luma vertical edges left to right, then its
    horizontal edges top to bottom, then chroma's likewise; bS by
    8.7.2.1, QPs by 8.7.2.2."""

    def __init__(self, planes, mb, blk, mbw):
        self.planes, self.mb, self.blk, self.w = planes, mb, blk, mbw

    def bs(self, pm, pb, qm, qb, mb_edge):
        kp, kq = self.mb[pm, K.F_KIND], self.mb[qm, K.F_KIND]
        if kp >= K.H_I4 or kq >= K.H_I4:
            return 4 if mb_edge else 3
        p, q = self.blk[pm, pb], self.blk[qm, qb]
        if p[3] or q[3]:
            return 2
        if p[2] != q[2] or abs(p[0] - q[0]) >= 4 or abs(p[1] - q[1]) >= 4:
            return 1
        return 0

    def qp(self, a, chroma):
        q = 0 if self.mb[a, K.F_KIND] == K.H_PCM else self.mb[a, K.F_QP]
        return QPC[clip3(0, 51, q + self.mb[a, K.F_QPC])] if chroma else q

    def run(self):
        for q in range(len(self.mb)):
            if self.mb[q, K.F_FILTER]:
                continue
            x, y = q % self.w, q // self.w
            for vertical in (True, False):
                for plane_i in range(3):
                    chroma = plane_i > 0
                    size = 8 if chroma else 16
                    edges = (0, 4) if chroma else (0, 4, 8, 12)
                    for e in edges:
                        if e == 0 and (x if vertical else y) == 0:
                            continue
                        pm = q if e else (q - 1 if vertical else q - self.w)
                        for k in range(size):
                            # the luma sample under this chroma line
                            lk, le = (2 * k, 2 * e) if chroma else (k, e)
                            if vertical:
                                qb = (lk // 4) * 4 + le // 4
                                pb = (lk // 4) * 4 + ((le - 1) % 16) // 4
                            else:
                                qb = (le // 4) * 4 + lk // 4
                                pb = (((le - 1) % 16) // 4) * 4 + lk // 4
                            bs = self.bs(pm, pb, q, qb, e == 0)
                            self.line(self.planes[plane_i], size, x, y, e, k,
                                      vertical, bs,
                                      (self.qp(pm, chroma)
                                       + self.qp(q, chroma) + 1) >> 1,
                                      self.mb[q, K.F_ALPHA],
                                      self.mb[q, K.F_BETA], chroma)

    @staticmethod
    def line(plane, size, x, y, e, k, vertical, bs, qpav, off_a, off_b,
             chroma):
        if vertical:
            row, col = size * y + k, size * x + e
            p = [int(plane[row, col - 1 - i]) for i in range(4)]
            q = [int(plane[row, col + i]) for i in range(4)]
        else:
            row, col = size * y + e, size * x + k
            p = [int(plane[row - 1 - i, col]) for i in range(4)]
            q = [int(plane[row + i, col]) for i in range(4)]
        p, q = filter_line(p, q, bs, qpav, off_a, off_b, chroma)
        for i in range(3):
            if vertical:
                plane[row, col - 1 - i] = p[i]
                plane[row, col + i] = q[i]
            else:
                plane[row - 1 - i, col] = p[i]
                plane[row + i, col] = q[i]


@pytest.mark.parametrize("seed,mbw,mbh", [(1, 4, 3), (2, 3, 4), (3, 5, 2)])
def test_deblock_waves_equal_the_raster_loop(seed, mbw, mbh):
    """Random pictures (every macroblock kind, vectors and references
    that differ by little and much, coefficients, QPs 15-51 with I_PCM
    at 0, chroma offsets, slices that do not filter, filter offsets):
    the plain H4 (lines gathered by step, waves x + 2y) equals the
    literal filter in raster order."""
    rng = np.random.default_rng(seed)
    m = mbw * mbh
    mb = np.zeros((m, K.MB_FIELDS), np.int32)
    mb[:, K.F_KIND] = rng.choice([K.H_SKIP, K.H_INTER, K.H_I4, K.H_I16,
                                  K.H_PCM], m, p=[.25, .35, .15, .15, .1])
    mb[:, K.F_QP] = rng.integers(15, 52, m)
    mb[:, K.F_QPC] = rng.integers(-6, 7, m)
    mb[:, K.F_FILTER] = rng.random(m) < 0.15
    mb[:, K.F_ALPHA] = 2 * rng.integers(-6, 7, m)
    mb[:, K.F_BETA] = 2 * rng.integers(-6, 7, m)
    blk = np.zeros((m, 16, 4), np.int32)
    blk[..., :2] = rng.integers(-6, 7, (m, 16, 2))
    blk[..., 2] = rng.integers(0, 2, (m, 16))
    blk[..., 3] = (rng.random((m, 16)) < 0.3) * rng.integers(1, 16, (m, 16))
    base = rng.integers(60, 190, (1, 1))
    planes = [np.clip(base + rng.integers(-12, 13, (16 * mbh // s,
                                                     16 * mbw // s)), 0, 255)
              .astype(np.uint8) for s in (1, 2, 2)]
    ref = DeblockPicture([p.astype(np.int64) for p in planes], mb, blk, mbw)
    ref.run()
    got = [torch.from_numpy(p.copy()).unsqueeze(0) for p in planes]
    K.deblock_plain(got, 0, torch.from_numpy(mb), torch.from_numpy(blk), mbw)
    for g, w, p in zip(got, ref.planes, planes):
        np.testing.assert_array_equal(g[0].numpy(), w)
    assert not np.array_equal(got[0][0].numpy(), planes[0])


# -- the kernels' layout (csrc/h264.cu) ------------------------------------------


def test_kernel_constants_follow_the_host_tables():
    """H3's kTrInside in csrc/h264.cu is _TR_INSIDE as a bit mask, its
    row masks (kMaxChunks words of 32) cover MAX_MB_WIDTH, and every
    entry of INTRA4_TAPS fits the word H3 packs it into (three 4-bit
    indices, three 2-bit weights, 2-bit rounding and shift)."""
    src = K.SOURCE.read_text()
    mask = int(re.search(r"kTrInside = (0x[0-9a-fA-F]+);", src).group(1), 16)
    assert [(mask >> b) & 1 for b in range(16)] == list(K._TR_INSIDE)
    chunks = int(re.search(r"kMaxChunks = (\d+);", src).group(1))
    assert 32 * chunks == K.MAX_MB_WIDTH
    t = K.INTRA4_TAPS
    assert t.min() >= 0 and t[..., :3].max() <= 12 and t[..., 3:].max() <= 3


def _lane_bs(kinds, blocks, x, y):
    """H4's bS gather (deblock_kernel) for macroblock (x, y): lanes 0-15
    each the bS of their 4x4 block's left and top edges, from the block
    records of the macroblock and of its left and top neighbours; then
    each lane's 4 vertical and 4 horizontal slots (luma lane l: line l;
    lane 16 + 8c + k: chroma line k of component c, slots 0 and 1 its
    edges 0 and 4)."""
    kq, kl, kt = kinds
    q, left, top = blocks
    both = []
    for lane in range(16):
        bx, by = lane & 3, lane >> 2
        rec = q[lane]

        def bs(kp, p, mb_edge):
            if kp >= K.H_I4 or kq >= K.H_I4:
                return 4 if mb_edge else 3
            if p[3] or rec[3]:
                return 2
            return int(p[2] != rec[2] or abs(p[0] - rec[0]) >= 4
                       or abs(p[1] - rec[1]) >= 4)
        bsv = 0 if bx == 0 and x == 0 else bs(
            kq if bx else kl, q[lane - 1] if bx else left[4 * by + 3],
            bx == 0)
        bsh = 0 if by == 0 and y == 0 else bs(
            kq if by else kt, q[lane - 4] if by else top[12 + bx], by == 0)
        both.append((bsv, bsh))
    out = []
    for lane in range(32):
        li, k = lane & 15, lane & 7
        slots = []
        for j in range(4):
            if lane >= 16:
                sv, sh = 4 * (k >> 1) + 2 * (j & 1), 8 * (j & 1) + (k >> 1)
            else:
                sv, sh = 4 * (li >> 2) + j, 4 * j + (li >> 2)
            off = lane >= 16 and j >= 2
            slots.append((0 if off else both[sv][0],
                          0 if off else both[sh][1]))
        out.append(slots)
    return out


def test_deblock_lane_bs_equals_the_lines():
    """The per-lane table of bS that H4's lanes gather by shuffles
    (_lane_bs) equals boundary_strength's bS of each line and edge as
    deblock_lines lists them, on random macroblocks of every kind."""
    rng = np.random.default_rng(7)
    mbw, mbh = 3, 3
    m = mbw * mbh
    mb = np.zeros((m, K.MB_FIELDS), np.int32)
    mb[:, K.F_KIND] = rng.choice([K.H_SKIP, K.H_INTER, K.H_I4, K.H_PCM], m,
                                 p=[.3, .5, .1, .1])
    mb[:, K.F_QP] = 30
    blk = np.zeros((m, 16, 4), np.int32)
    blk[..., :2] = rng.integers(-5, 6, (m, 16, 2))
    blk[..., 2] = rng.integers(0, 2, (m, 16))
    blk[..., 3] = rng.random((m, 16)) < 0.2
    step, idx, bs, *_ = K.deblock_lines(torch.from_numpy(mb),
                                        torch.from_numpy(blk), mbw)
    hl, wl = 16 * mbh, 16 * mbw
    want = {}  # (plane, y, x, vertical) of q0 -> bS
    for st, line, b in zip(step.tolist(), idx.tolist(), bs.tolist()):
        q0 = line[4]
        plane = 0 if q0 < hl * wl else 1 + (q0 - hl * wl) // (hl * wl // 4)
        w = wl if plane == 0 else wl // 2
        q0 -= 0 if plane == 0 else hl * wl + (plane - 1) * (hl * wl // 4)
        want[(plane, q0 // w, q0 % w, line[5] - line[4] == 1)] = b
    for a in range(m):
        x, y = a % mbw, a // mbw
        table = _lane_bs((mb[a, K.F_KIND], mb[a - 1, K.F_KIND],
                          mb[a - mbw, K.F_KIND]),
                         (blk[a], blk[a - 1], blk[a - mbw]), x, y)
        for lane in range(32):
            plane = 0 if lane < 16 else 1 + ((lane >> 3) & 1)
            n = 16 if plane == 0 else 8
            line = lane & 15 if plane == 0 else lane & 7
            for j in range(4 if plane == 0 else 2):
                for vertical in (True, False):
                    yy, xx = (n * y + line, n * x + 4 * j) if vertical else (
                        n * y + 4 * j, n * x + line)
                    got = table[lane][j][0 if vertical else 1]
                    assert got == want.get((plane, yy, xx, vertical), 0), (
                        a, lane, j, vertical)


# -- the wavefronts' latency bounds (chip_smoke.py) ---------------------------

LINK, HANDOFF = 1.0, 0.25  # exact in binary: a bound's ms names its path


def _chain_records(kinds, mbw, modes=0, i16=0, cmode=2, slices=None,
                   cip=0):
    """Intra records for h264_intra_chain: one Intra4x4 mode for all 16
    blocks, one Intra16x16 and one chroma mode."""
    m = len(kinds)
    mb = np.zeros((m, K.MB_FIELDS), np.int32)
    mb[:, K.F_KIND] = kinds
    word = np.array([sum(modes << (4 * b) for b in range(8))], np.uint32)
    mb[:, K.F_MODES] = mb[:, K.F_MODES_HI] = word.view(np.int32)[0]
    mb[:, K.F_I16] = i16
    mb[:, K.F_CMODE] = cmode
    mb[:, K.F_SLICE] = np.arange(m) if slices == "each" else 0
    mb[:, K.F_CIP] = cip
    return mb


I4, I16 = K.H_I4, K.H_I16


@pytest.mark.parametrize("kinds,mbw,opts,want", [
    # one macroblock: DC reads left and top (bx + by + 1 steps), vertical
    # only the top, horizontal only the left
    ([I4], 1, {"modes": 2}, (7.0, 7, 0)),
    ([I4], 1, {"modes": 0}, (4.0, 4, 0)),
    ([I4], 1, {"modes": 1}, (4.0, 4, 0)),
    # horizontal across a row: 4 blocks a macroblock
    ([I4] * 3, 3, {"modes": 1}, (12.0, 12, 0)),
    # Intra16x16: a step a macroblock, along the row only where it reads
    # the left; down a column with a handoff a row
    ([I16] * 3, 3, {"i16": 1}, (3.0, 3, 0)),
    ([I16] * 3, 3, {"i16": 0}, (1.0, 1, 0)),
    ([I16] * 3, 1, {"i16": 0}, (3.5, 3, 2)),
    # a slice a macroblock: no neighbour is available
    ([I16] * 3, 3, {"i16": 1, "slices": "each"}, (1.0, 1, 0)),
    # chroma's own chain (horizontal) beside luma's single steps
    ([I16] * 3, 3, {"i16": 0, "cmode": 1}, (3.0, 3, 0)),
    # diagonal down-left (top and top-right) over 2 x 2 macroblocks: 4
    # steps in the top row (block (1, 1) has no top-right), then block
    # (0, 0) below after the top-right macroblock's, a handoff, 4 more
    ([I4] * 4, 2, {"modes": 3}, (8.25, 8, 1)),
    # inter neighbours are final before any step; under
    # constrained_intra_pred they are not read at all
    ([I16, K.H_INTER, I16], 3, {"i16": 1}, (1.0, 1, 0)),
    ([I16, K.H_INTER, I16], 3, {"i16": 1, "cip": 1}, (1.0, 1, 0)),
])
def test_intra_latency_bound_counts_the_block_graph(kinds, mbw, opts,
                                                   want):
    """chip_smoke.h264_intra_chain, H3's latency bound, on pictures whose
    longest dependent path is worked out by hand: (ms, links, handoffs)
    at a link of 1 and a handoff of 0.25."""
    import chip_smoke as cs

    mb = _chain_records(kinds, mbw, **opts)
    assert cs.h264_intra_chain(mb, mbw, LINK, HANDOFF) == want


class DeblockChain(DeblockPicture):
    """DeblockPicture's raster loop with each line's filter replaced by
    its step on the dependence graph: a sample's time is that of the
    line that last wrote it; a line (bS > 0, alpha and beta > 0) starts
    after the latest sample it reads, plus a handoff where that sample's
    writer lies in another macroblock row, and writes the samples the
    filter may change."""

    def __init__(self, mb, blk, mbw):
        mbh = len(mb) // mbw
        planes = [np.zeros((16 * mbh // s, 16 * mbw // s)) for s in (1, 2, 2)]
        super().__init__(planes, mb, blk, mbw)
        self.writer = [np.full(p.shape, -1) for p in planes]
        self.best = 0.0

    def line(self, plane, size, x, y, e, k, vertical, bs, qpav, off_a,
             off_b, chroma):
        if bs == 0 or not (ALPHA[clip3(0, 51, qpav + off_a)]
                           and BETA[clip3(0, 51, qpav + off_b)]):
            return
        writer = self.writer[[id(p) for p in self.planes].index(id(plane))]
        row, col = (size * y + k, size * x + e) if vertical else (
            size * y + e, size * x + k)

        def at(side, i):  # p_i (side -1) or q_i (side 1)
            d = -1 - i if side < 0 else i
            return (row, col + d) if vertical else (row + d, col)
        n_read = 2 if chroma else (4 if bs == 4 else 3)
        n_write = 1 if chroma else (3 if bs == 4 else 2)
        t = max(plane[at(s, i)] + HANDOFF * (writer[at(s, i)] not in (-1, y))
                for s in (-1, 1) for i in range(n_read)) + LINK
        for s in (-1, 1):
            for i in range(n_write):
                plane[at(s, i)] = t
                writer[at(s, i)] = y
        self.best = max(self.best, t)


@pytest.mark.parametrize("seed,mbw,mbh,chroma_only", [
    (1, 4, 3, False), (2, 3, 4, False), (3, 6, 2, False), (4, 4, 3, True)])
def test_deblock_latency_bound_equals_the_raster_loop(seed, mbw, mbh,
                                                      chroma_only):
    """chip_smoke.h264_deblock_chain, H4's latency bound (lines gathered
    by step, vectorised), equals the same graph walked by the literal
    raster-order loop on random pictures of every kind, QPs that do and
    do not filter, and slices that do not filter; and on one where only
    chroma filters (luma QP 4, chroma's 16: luma's alpha is 0)."""
    import chip_smoke as cs

    rng = np.random.default_rng(seed)
    m = mbw * mbh
    mb = np.zeros((m, K.MB_FIELDS), np.int32)
    mb[:, K.F_KIND] = rng.choice([K.H_SKIP, K.H_INTER, K.H_I4, K.H_I16,
                                  K.H_PCM], m, p=[.25, .35, .15, .15, .1])
    mb[:, K.F_QP] = rng.integers(10, 52, m)
    mb[:, K.F_QPC] = rng.integers(-6, 7, m)
    mb[:, K.F_FILTER] = rng.random(m) < 0.15
    mb[:, K.F_ALPHA] = 2 * rng.integers(-6, 7, m)
    mb[:, K.F_BETA] = 2 * rng.integers(-6, 7, m)
    if chroma_only:
        mb[:, K.F_KIND] = rng.choice([K.H_I4, K.H_I16], m)
        mb[:, K.F_QP], mb[:, K.F_QPC] = 4, 12
        mb[:, K.F_ALPHA], mb[:, K.F_BETA] = 2, 6
    blk = np.zeros((m, 16, 4), np.int32)
    blk[..., :2] = rng.integers(-6, 7, (m, 16, 2))
    blk[..., 2] = rng.integers(0, 2, (m, 16))
    blk[..., 3] = (rng.random((m, 16)) < 0.3) * rng.integers(1, 16, (m, 16))
    ref = DeblockChain(mb, blk, mbw)
    ref.run()
    got = cs.h264_deblock_chain(torch.from_numpy(mb), torch.from_numpy(blk),
                                mbw, LINK, HANDOFF)
    assert ref.best > 2 * LINK
    assert got[0] == ref.best
    assert got[1] * LINK + got[2] * HANDOFF == got[0]


# -- the wrappers --------------------------------------------------------------


def test_wavefront_kernels_refuse_what_they_cannot_take():
    """H3 and H4 move 16-byte rows and keep a bit a macroblock of a row:
    a tensor off a 16-byte boundary, or a picture wider than
    MAX_MB_WIDTH macroblocks, is refused before any launch."""
    buf = torch.zeros(64, dtype=torch.uint8)
    K._wave_ok([buf[16:]], K.MAX_MB_WIDTH)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K._wave_ok([buf[16:], buf[1:]], 4)
    with pytest.raises(ValueError, match="macroblocks wide"):
        K._wave_ok([buf], K.MAX_MB_WIDTH + 1)


def test_wrappers_refuse_tensors_off_the_card():
    """A wrapper given device tensors launches its kernel; a host tensor
    among them is refused (meta stands in for the card here, so the
    refusal comes before any library is loaded)."""
    meta = torch.device("meta")
    mb = torch.zeros((4, K.MB_FIELDS), dtype=torch.int32)
    blk = torch.zeros((4, 16, 4), dtype=torch.int32)
    planes = [torch.zeros((2, 32, 32), dtype=torch.uint8, device=meta)] + [
        torch.zeros((2, 16, 16), dtype=torch.uint8, device=meta)] * 2
    res_y = torch.zeros((32, 32), dtype=torch.int16, device=meta)
    res_c = torch.zeros((2, 16, 16), dtype=torch.int16, device=meta)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        K.inter_predict(planes, 1, mb, blk, res_y, res_c, 2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        K.intra_reconstruct(planes, 1, mb, torch.zeros((0, 384),
                                                       dtype=torch.uint8),
                            res_y, res_c, 2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        K.deblock(planes, 1, mb, blk, 2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        K.residual(torch.zeros((1, 16), dtype=torch.int16, device=meta),
                   torch.zeros((1, 4, 27), dtype=torch.int32), mb[None], 2)
