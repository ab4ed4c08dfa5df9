"""The arithmetic that kernels V1-V5 of `csrc/mpeg4.cu` do otherwise
than their plain versions in `ops/mpeg4_cuda.py`, checked over every value
it can meet, on the CPU:

  * V1 dequantises as 2 qp |l| + c0 clamped by sign, and reads a row's
    DC-only shortcut from its levels; its column pass runs in int32 where
    every |input| <= COL_SAFE: no partial sum can then leave int32 (the
    bound is reached, and one more breaks it), and the int32 pass equals
    the plain one on every column it admits;
  * V2 averages half pels in 16-bit lanes with one four-tap form for all
    four phases and both rounding types, takes the chroma rounding by two
    compares, and adds the residual in those lanes, clamped first;
  * V2's quarter-pel form and V5 run the 8-tap filter two outputs a word
    (16-bit lanes, a bias that keeps them positive), as tasks of 8 half
    samples whose mirrored taps are fixed byte orders, mean the two
    predictions byte-wise, read a window in aligned words only where it
    lies inside the clamp box, and launch a warp a macroblock;

  * V4 divides by 2 qp and by the intra DC scaler with a multiply-high by
    `RECIP[d]` = ceil(2^32 / d) (sent to the kernel's constant memory):
    equal to floor division for every reachable divisor and numerator;
  * `F_MAX` bounds what `fdct_plain` gives on samples and residuals in
    [-255, 255] (and is reached), so those numerators are all covered;
  * V4's butterflies rest on the symmetry of the FDCT matrix;
  * V3 packs the plain 64-bit key into 31 bits (`search_key`): the same
    order over the key's whole range.

Those stages reach no JAX code (the JAX package hands the mp4v codec to
cv2), so the reference here is the plain version's own arithmetic.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from faceoff_tpu_torch.io.mpeg4 import plain_threads
from faceoff_tpu_torch.ops import mpeg4_cuda as K

QPS = np.arange(1, 32)
SRC = K.SOURCE.read_text()


def _divisors():
    """Every divisor V4 meets: 2 qp, and the luma and chroma DC scalers,
    for qp 1..31."""
    qp = torch.from_numpy(QPS)
    scalers = [K.dc_scaler(qp, torch.full_like(qp, luma, dtype=torch.bool))
               for luma in (True, False)]
    return sorted(set((2 * QPS).tolist())
                  | set(torch.cat(scalers).tolist()))


def test_every_divisor_has_a_reciprocal():
    ds = _divisors()
    assert min(ds) == 2 and max(ds) == 62
    assert all(K.RECIP[d] for d in ds)
    assert len(K.RECIP) == 64 and K.RECIP.dtype == np.uint32


@pytest.mark.parametrize("d", _divisors())
def test_multiply_high_equals_floor_division(d):
    """(n * RECIP[d]) >> 32 == n // d for every numerator up to
    QUANT_N_MAX: |F|, |F| - qp // 2 and the intra DC's F + s // 2 or
    -F + s - 1."""
    n = np.arange(K.QUANT_N_MAX + 1, dtype=np.uint64)
    got = (n * np.uint64(K.RECIP[d])) >> np.uint64(32)
    assert np.array_equal(got, n // np.uint64(d))


def test_numerators_stay_within_the_checked_range():
    assert K.QUANT_N_MAX >= K.F_MAX + max(_divisors())


def _sign_patterns():
    """(64 + 2, 64) inputs of +-255: the sign pattern of every DCT basis
    product (the inputs that make each coefficient largest), and the two
    constant blocks."""
    c = np.sign(K.FDCT)
    rows = [np.where(np.outer(c[v], c[u]) >= 0, 255, -255).reshape(64)
            for v in range(8) for u in range(8)]
    rows += [np.full(64, 255), np.full(64, -255)]
    return torch.from_numpy(np.stack(rows).astype(np.int64))


def test_fdct_bound_holds_and_is_reached():
    """|fdct_plain| <= F_MAX on the extreme inputs and on noise, with
    equality on a white block; so a level never reaches the 2047 clamp
    from 8-bit input (F_MAX // 2 at qp 1)."""
    rng = np.random.default_rng(3)
    noise = torch.from_numpy(rng.integers(-255, 256, (4096, 64)))
    f = K.fdct_plain(torch.cat([_sign_patterns(), noise]))
    assert int(f.abs().max()) == K.F_MAX == 2039
    assert K.F_MAX // 2 < 2047


def test_quantize_by_reciprocals_equals_quantize_plain():
    """The kernel's quantisation, written with the reciprocals, equals
    quantize_plain on every coefficient value at every qp, intra and
    inter, luma and chroma."""
    f = torch.arange(-K.F_MAX, K.F_MAX + 1, dtype=torch.int64)
    recip = torch.from_numpy(K.RECIP.astype(np.int64))

    def mulhi(n, d):
        return (n * recip[d]) >> 32

    for qp in QPS.tolist():
        for intra in (False, True):
            for luma in (False, True):
                n = f.numel()
                blocks = f.view(-1, 1).expand(n, 64).contiguous()
                want = K.quantize_plain(
                    blocks, torch.full((n,), qp), torch.full((n,), intra),
                    torch.full((n,), luma))
                a = f.abs()
                num = a if intra else (a - qp // 2).clamp(min=0)
                mag = mulhi(num, torch.full_like(num, 2 * qp)).clamp(max=2047)
                lv = torch.where(f < 0, -mag, mag)
                if intra:
                    s = int(K.dc_scaler(torch.tensor(qp), torch.tensor(luma)))
                    q = f + (s >> 1)
                    dc = torch.where(q >= 0, mulhi(q.clamp(min=0), s),
                                     -mulhi((-q + s - 1).clamp(min=0), s))
                    assert torch.equal(want[:, 0], dc.clamp(1, 254).to(
                        torch.int16))
                assert torch.equal(want[:, 1], lv.to(torch.int16))


def test_fdct_rows_are_even_or_odd():
    """C[u][7 - k] = (-1)^u C[u][k]: V4's even/odd butterflies."""
    for u in range(8):
        assert np.array_equal(K.FDCT[u, ::-1], (-1) ** u * K.FDCT[u])


def _plain_key(sad, dx, dy):
    cheb = np.maximum(np.abs(dx), np.abs(dy))
    r = K.SEARCH_RANGE
    return (np.asarray(sad, np.int64) << 17) | (cheb << 12) | (
        (dy + r) << 6) | (dx + r)


def test_search_key_keeps_the_plain_order():
    """Over all 1089 candidates the 15-bit order sorts as the plain
    (Chebyshev length, dy, dx); with the SAD above it (up to 255 * 256)
    the key fits 31 bits, so comparing keys compares (SAD, order)."""
    r = K.SEARCH_RANGE
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                         indexing="ij")
    dx, dy = dx.ravel(), dy.ravel()
    order = K.search_key(0, dx, dy)
    assert np.array_equal(np.argsort(order, kind="stable"),
                          np.argsort(_plain_key(0, dx, dy), kind="stable"))
    assert len(set(order.tolist())) == dx.size
    assert order.max() < 1 << K.ORDER_BITS
    top = K.search_key(255 * 256, dx, dy)
    assert top.max() < 1 << 31
    # random candidates at SADs over the whole range, the extremes included
    rng = np.random.default_rng(5)
    sads = np.concatenate([[0, 1, 2, 255 * 256 - 1, 255 * 256],
                           rng.integers(0, 255 * 256 + 1, 20000)])
    pick = rng.integers(0, dx.size, sads.size)
    ours = K.search_key(sads, dx[pick], dy[pick])
    plain = _plain_key(sads, dx[pick], dy[pick])
    assert np.array_equal(np.argsort(ours, kind="stable"),
                          np.argsort(plain, kind="stable"))


# -- V1 -------------------------------------------------------------------

def test_kernel_constants_are_the_plain_ones():
    """csrc/mpeg4.cu's IDCT weights and COL_SAFE are the module's, and the
    column rounding W4 (x0 + 32) is the plain W4 (x0 + 2^19 // W4)."""
    for i in range(1, 8):
        m = re.search(rf"\bW{i} = (\d+)", SRC)
        assert int(m.group(1)) == getattr(K, f"W{i}")
    assert int(re.search(r"COL_SAFE = (\d+);", SRC).group(1)) == K.COL_SAFE
    assert (1 << (K.COL_SHIFT - 1)) // K.W4 == 32


def test_dequantisation_as_the_kernel_writes_it():
    """|F| = 2 qp |l| + c0 (c0 = qp - 1 + (qp & 1)), clamped to 2047 above
    and 2048 below, 0 for l = 0, equals dequantize_plain's AC for every
    int16 level at every qp; and F = 0 only for l = 0, so a row is DC-only
    exactly where its seven AC levels are 0."""
    lv = np.arange(-32768, 32768, dtype=np.int64)
    with plain_threads(torch.device("cpu")):
        for qp in QPS.tolist():
            c0 = qp - 1 + (qp & 1)
            mag = np.minimum(2 * qp * np.abs(lv) + c0,
                             np.where(lv < 0, 2048, 2047))
            ours = np.where(lv == 0, 0, np.where(lv < 0, -mag, mag))
            blocks = torch.from_numpy(lv).view(-1, 1).expand(-1, 2)
            n = blocks.shape[0]
            want = K.dequantize_plain(blocks, torch.full((n,), qp),
                                      torch.zeros(n, dtype=torch.bool),
                                      torch.ones(n, dtype=torch.bool))
            assert np.array_equal(ours, want[:, 1].numpy())
            assert np.array_equal(ours == 0, lv == 0)


def _linear_terms(first):
    """Every partial sum of the simple IDCT's butterfly (csrc/mpeg4.cu
    idct8, evaluated left to right) as (coefficients of x0..x7,
    constant)."""
    W = {i: getattr(K, f"W{i}") for i in range(1, 8)}

    def term(c, k):
        v = np.zeros(8, np.int64)
        v[k] = c
        return v, 0

    def add(p, q, sign=1):
        return p[0] + sign * q[0], p[1] + sign * q[1]

    out = []

    def chain(start, parts):
        acc = start
        for sign, c, k in parts:
            acc = add(acc, term(c, k), sign)
            out.append(acc)
        return acc

    a = first(W)
    out.append(a)
    a0 = chain(a, [(1, W[2], 2), (1, W[4], 4), (1, W[6], 6)])
    a1 = chain(a, [(1, W[6], 2), (-1, W[4], 4), (-1, W[2], 6)])
    a2 = chain(a, [(-1, W[6], 2), (-1, W[4], 4), (1, W[2], 6)])
    a3 = chain(a, [(-1, W[2], 2), (1, W[4], 4), (-1, W[6], 6)])
    b = [chain(term(W[1], 1), [(1, W[3], 3), (1, W[5], 5), (1, W[7], 7)]),
         chain(term(W[3], 1), [(-1, W[7], 3), (-1, W[1], 5), (-1, W[5], 7)]),
         chain(term(W[5], 1), [(-1, W[1], 3), (1, W[7], 5), (1, W[3], 7)]),
         chain(term(W[7], 1), [(-1, W[5], 3), (1, W[3], 5), (-1, W[1], 7)])]
    for ai, bi in zip((a0, a1, a2, a3), b):
        out += [add(ai, bi), add(ai, bi, -1)]
    return out


def _reach(terms, m):
    """The largest |partial sum| over inputs with every |x_k| <= m."""
    return max(int(np.abs(c).sum()) * m + abs(d) for c, d in terms)


def test_column_certificate_keeps_int32():
    """With every |column input| <= COL_SAFE no partial sum of the column
    pass reaches 2^31 (122424 * 17537 + 524256 = 2147473944); the bound
    is reached by the all-COL_SAFE column, and COL_SAFE + 1 would break
    it. Rows (inputs within [-2048, 2047]) stay far inside int32."""
    cols = _linear_terms(lambda W: (np.eye(8, dtype=np.int64)[0] * W[4],
                                    W[4] * 32))
    rows = _linear_terms(lambda W: (np.eye(8, dtype=np.int64)[0] * W[4],
                                    1 << 10))
    reach = _reach(cols, K.COL_SAFE)
    assert reach == 122424 * 17537 + 524256 < 2 ** 31
    assert _reach(cols, K.COL_SAFE + 1) >= 2 ** 31
    assert _reach(rows, 2048) < 2 ** 31
    # reached: the all-COL_SAFE column's first output sum
    col = torch.full((1, 8), K.COL_SAFE, dtype=torch.int64)
    s = K._idct_cols(col)[0, 0]
    assert int(s) == reach >> K.COL_SHIFT


def _idct_cols_int32(x):
    """The kernel's int32 column pass: every operation wrapped to int32,
    in the order idct8 writes it; (N, 8) -> (N, 8) wrapped to int16."""
    def w32(v):
        return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31

    W = {i: getattr(K, f"W{i}") for i in range(1, 8)}
    x = [x[:, k].astype(np.int64) for k in range(8)]

    def s(*terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = w32(acc + w32(t))
        return acc

    a = w32(W[4] * (x[0] + 32))
    a0 = s(a, W[2] * x[2], W[4] * x[4], W[6] * x[6])
    a1 = s(a, W[6] * x[2], -W[4] * x[4], -W[2] * x[6])
    a2 = s(a, -W[6] * x[2], -W[4] * x[4], W[2] * x[6])
    a3 = s(a, -W[2] * x[2], W[4] * x[4], -W[6] * x[6])
    b0 = s(W[1] * x[1], W[3] * x[3], W[5] * x[5], W[7] * x[7])
    b1 = s(W[3] * x[1], -W[7] * x[3], -W[1] * x[5], -W[5] * x[7])
    b2 = s(W[5] * x[1], -W[1] * x[3], W[7] * x[5], W[3] * x[7])
    b3 = s(W[7] * x[1], -W[5] * x[3], W[3] * x[5], -W[1] * x[7])
    out = [s(a0, b0), s(a1, b1), s(a2, b2), s(a3, b3), s(a3, -b3),
           s(a2, -b2), s(a1, -b1), s(a0, -b0)]
    out = np.stack(out, 1) >> K.COL_SHIFT
    return ((out + 32768) & 0xFFFF) - 32768


def test_int32_column_pass_equals_the_plain_one():
    """On columns the certificate admits (all 3^8 sign patterns of 0 and
    +-COL_SAFE, and random ones) the int32 pass equals _idct_cols; a
    column at COL_SAFE + 1 that it would refuse differs."""
    m = K.COL_SAFE
    grid = np.stack(np.meshgrid(*[np.array([-m, 0, m])] * 8,
                                indexing="ij"), -1).reshape(-1, 8)
    rng = np.random.default_rng(4)
    cols = np.concatenate([grid, rng.integers(-m, m + 1, (200000, 8))])
    want = K._wrap16(K._idct_cols(torch.from_numpy(cols))).numpy()
    assert np.array_equal(_idct_cols_int32(cols), want)
    over = np.full((1, 8), m + 1, np.int64)
    assert not np.array_equal(_idct_cols_int32(over), K._wrap16(
        K._idct_cols(torch.from_numpy(over))).numpy())


# -- V2 -------------------------------------------------------------------

def _byte_perm(x, y, s):
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    r = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        sel = np.uint64(((s >> (4 * i)) & 7) * 8)
        r |= ((v >> sel) & np.uint64(0xFF)) << np.uint64(8 * i)
    return r.astype(np.uint32)


def _hpel4(a, b, c, d, rnd):
    """csrc/mpeg4.cu hpel4, then the byte_perm 0x6420 that packs it."""
    z = np.zeros_like(a)
    k = np.uint32((2 - rnd) * 0x00010001)
    lo = (_byte_perm(a, z, 0x4140) + _byte_perm(b, z, 0x4140)
          + _byte_perm(c, z, 0x4140) + _byte_perm(d, z, 0x4140) + k) >> 2
    hi = (_byte_perm(a, z, 0x4342) + _byte_perm(b, z, 0x4342)
          + _byte_perm(c, z, 0x4342) + _byte_perm(d, z, 0x4342) + k) >> 2
    return lo.astype(np.uint32), hi.astype(np.uint32)


def _pack(lo, hi):
    return _byte_perm(lo, hi, 0x6420)


def _words(bytes4):
    """(N, 4) bytes -> (N,) little-endian uint32."""
    b = bytes4.astype(np.uint32)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def _bytes(w):
    return np.stack([(w >> (8 * i)) & 0xFF for i in range(4)], 1).astype(
        np.int64)


@pytest.mark.parametrize("rnd", [0, 1])
def test_one_form_serves_every_half_pel_phase(rnd):
    """Over all byte pairs in every byte of a word: the four-tap form
    with the x (y) taps repeated gives _interp's two-tap averages (a + b
    + 1 - rnd) >> 1, and with both repeated the byte itself."""
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    a, b = a.ravel(), b.ravel()
    pair = (a + b + 1 - rnd) >> 1
    for pos in range(4):
        rows_a = np.zeros((a.size, 4), np.int64)
        rows_b = np.zeros((a.size, 4), np.int64)
        rows_a[:, pos], rows_b[:, pos] = a, b
        rows_a[:, (pos + 1) % 4], rows_b[:, (pos + 1) % 4] = 255, 255
        wa, wb = _words(rows_a), _words(rows_b)
        for got in (_pack(*_hpel4(wa, wb, wa, wb, rnd)),    # x phase
                    _pack(*_hpel4(wa, wa, wb, wb, rnd))):   # y phase
            assert np.array_equal(_bytes(got)[:, pos], pair)
        assert np.array_equal(_pack(*_hpel4(wa, wa, wa, wa, rnd)), wa)


@pytest.mark.parametrize("rnd", [0, 1])
def test_four_tap_lanes_over_every_sum(rnd):
    """Every four-tap sum 0..1020 in every byte of a word, its neighbours
    at 0 and at 255: (a + b + c + d + 2 - rnd) >> 2 exactly, no lane
    disturbing another; then random words."""
    s = np.arange(1021)
    taps = np.stack([np.clip(s - 255 * i, 0, 255) for i in range(4)], 1)
    assert np.array_equal(taps.sum(1), s)
    want = (s + 2 - rnd) >> 2
    for pos in range(4):
        for fill in (0, 255):
            w = []
            for i in range(4):
                r = np.full((s.size, 4), fill, np.int64)
                r[:, pos] = taps[:, i]
                w.append(_words(r))
            got = _bytes(_pack(*_hpel4(*w, rnd)))
            assert np.array_equal(got[:, pos], want)
            other = [q for q in range(4) if q != pos]
            assert (got[:, other] == ((4 * fill + 2 - rnd) >> 2)).all()
    rng = np.random.default_rng(6)
    w = [rng.integers(0, 2 ** 32, 100000, dtype=np.uint64).astype(np.uint32)
         for _ in range(4)]
    got = _bytes(_pack(*_hpel4(*w, rnd)))
    want = (sum(_bytes(x) for x in w) + 2 - rnd) >> 2
    assert np.array_equal(got, want)


def test_residual_adds_to_the_lanes_bytes():
    """add_clip4 masks hpel4's shifted lane words with 0x00FF00FF: for
    every pair of lane sums 0..1022 that leaves the two averages (the bits
    a shift brings down from the next lane lie above the byte). It then
    clamps each int16 residual to [-256, 255] and takes max(min(p + r,
    255), 0) in 16-bit lanes: equal to clip(p + r, 0, 255) for every byte
    p and every int16 r, no lane sum leaving int16."""
    s0, s1 = np.meshgrid(np.arange(1023), np.arange(1023), indexing="ij")
    lane = ((s0.ravel() | (s1.ravel() << 16)).astype(np.uint64) >> 2)
    lane = lane.astype(np.uint32) & np.uint32(0x00FF00FF)
    assert np.array_equal(lane & 0xFFFF, s0.ravel() >> 2)
    assert np.array_equal(lane >> 16, s1.ravel() >> 2)
    p, r = np.meshgrid(np.arange(256, dtype=np.int32),
                       np.arange(-32768, 32768, dtype=np.int32), indexing="ij")
    rc = np.minimum(np.maximum(r, -256), 255)
    total = p + rc
    assert total.min() >= -32768 and total.max() <= 32767
    got = np.maximum(np.minimum(total, 255), 0)
    assert np.array_equal(got, np.clip(p + r, 0, 255))


def test_chroma_vector_by_compares():
    """(q >= 3) + (q >= 14) for q = s & 15 is Table 7-9's rounding, and
    the kernel's chroma vector equals chroma_vector on every sum of four
    vectors the fcode allows (|v| <= 2048 half pels)."""
    q = np.arange(16)
    assert np.array_equal((q >= 3).astype(int) + (q >= 14),
                          K._CHROMA_ROUND.numpy())
    s = np.arange(-4 * 2048, 4 * 2048 + 1)
    qs = s & 15
    ours = (qs >= 3).astype(np.int64) + (qs >= 14) + ((s >> 3) & ~1)
    assert np.array_equal(ours, K.chroma_vector(torch.from_numpy(s)).numpy())


# -- V2 at quarter-pel and V5 ---------------------------------------------

def _u32(v):
    return np.asarray(v, np.uint64).astype(np.uint32)


def _funnel(lo, hi, sh):
    """__funnelshift_r for a shift below 32."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v >> np.uint64(sh)).astype(np.uint32)


def _lanes(w):
    """The two signed 16-bit lanes of words."""
    return (w & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int64), \
        (w >> 16).astype(np.uint16).view(np.int16).astype(np.int64)


def _lowpass2(s0, s1, s2, s3, rnd):
    """csrc/mpeg4.cu lowpass2 in uint32 arithmetic, its DPX clip
    max(min(x - 112, 255), 0) a 16-bit lane at a time."""
    k = _u32((K.QP_BIAS + 16 - rnd) * 0x00010001)
    u = ((s0 * _u32(20) + k + s2 * _u32(3)) - (s1 * _u32(6) + s3))
    x = (u >> _u32(5)) & _u32(0x07FF07FF)
    lo, hi = _lanes(x)
    lo = np.clip(((lo - 112 + 32768) % 65536) - 32768, None, 255).clip(0)
    hi = np.clip(((hi - 112 + 32768) % 65536) - 32768, None, 255).clip(0)
    return _u32(lo | (hi << 16))


def _mean2(a, b, rnd):
    return ((a + b + _u32((1 - rnd) * 0x00010001)) >> _u32(1)) \
        & _u32(0x00FF00FF)


def _hrow(w, c, fx, rnd):
    """csrc/mpeg4.cu qpel_hrow over words w[0..2] (N,): (N, 8) bytes."""
    z = np.zeros_like(w[0])
    if c == 1:
        t = [w[0], w[1], w[2], _byte_perm(w[2], z, 0x0123)]
    else:
        t = [_byte_perm(w[0], z, 0x0012), _byte_perm(w[0], w[1], 0x4321),
             _byte_perm(w[1], w[2], 0x4321),
             _byte_perm(w[2], z, 0x0321) if c == 0
             else _byte_perm(w[1], w[2], 0x0234)]
    if fx == 0:
        out = [_funnel(t[0], t[1], 24), _funnel(t[1], t[2], 24)]
    else:
        e = [_byte_perm(t[i >> 1], z, 0x4342 if i & 1 else 0x4140)
             for i in range(8)]
        o = [_funnel(e[i], e[i + 1], 16) for i in range(7)]
        p = []
        for q in range(4):
            h = _lowpass2(o[q + 1] + e[q + 2], e[q + 1] + o[q + 2],
                          o[q] + e[q + 3], e[q] + o[q + 3], rnd)
            if fx == 1:
                h = _mean2(h, o[q + 1], rnd)
            elif fx == 3:
                h = _mean2(h, e[q + 2], rnd)
            p.append(h)
        out = [_pack(p[0], p[1]), _pack(p[2], p[3])]
    return np.concatenate([_bytes(v) for v in out], 1)


def _vrow(taps, fy, rnd):
    """csrc/mpeg4.cu qpel_vrow: 8 tap rows (N, 8, 8) bytes -> (N, 8)."""
    z = np.zeros(taps.shape[0], np.uint32)
    c = []
    for i in range(8):
        x, y = _words(taps[:, i, :4]), _words(taps[:, i, 4:])
        c.append([_byte_perm(x, z, 0x4140), _byte_perm(x, z, 0x4342),
                  _byte_perm(y, z, 0x4140), _byte_perm(y, z, 0x4342)])
    p = []
    for j in range(4):
        h = _lowpass2(c[3][j] + c[4][j], c[2][j] + c[5][j],
                      c[1][j] + c[6][j], c[0][j] + c[7][j], rnd)
        if fy == 1:
            h = _mean2(h, c[3][j], rnd)
        elif fy == 3:
            h = _mean2(h, c[4][j], rnd)
        p.append(h)
    return np.concatenate([_bytes(_pack(p[0], p[1])),
                           _bytes(_pack(p[2], p[3]))], 1)


def _tile_put(tile, row, size, h):
    """csrc/mpeg4.cu tile_put: row w at 3 + w and at its mirror images."""
    tile[:, 3 + row] = h
    if row <= 2:
        tile[:, 2 - row] = h
    if row >= size - 2:
        tile[:, 2 * size + 4 - row] = h


def _kernel_qpel(full, size, fx, fy, rnd):
    """The kernels' quarter-pel block over windows full (N, size + 1,
    size + 1): every horizontal task (a window row's 8 half samples), the
    rows into a tile with their mirror images, then every vertical task
    (an output row of 8 from 8 consecutive tile rows)."""
    n = full.shape[0]
    cases = (0, 1) if size == 16 else (2,)
    tiles = np.zeros((len(cases), n, size + 7, 8), np.int64)
    half = np.zeros((n, size + 1, size), np.int64)
    for row in range(size + 1):
        for i, c in enumerate(cases):
            first, cnt = K.qpel_task_bytes(c)
            b = np.zeros((n, 12), np.int64)
            b[:, :cnt] = full[:, row, first: first + cnt]
            w = [_words(b[:, 4 * j: 4 * j + 4]) for j in range(3)]
            h = _hrow(w, c, fx, rnd)
            _tile_put(tiles[i], row, size, h)
            half[:, row, 8 * i: 8 * i + 8] = h
    if fy == 0:
        return half[:, :size]
    out = np.zeros((n, size, size), np.int64)
    for r in range(size):
        for i in range(len(cases)):
            out[:, r, 8 * i: 8 * i + 8] = _vrow(tiles[i][:, r: r + 8], fy,
                                                rnd)
    return out


def test_kernel_bias_and_shapes_are_the_modules():
    """csrc/mpeg4.cu's QP_BIAS, MCQ_MBS and BD_MBS are the module's, their
    MINB caps a thread at 64 of the SM's 65536 registers, the launchers
    take their grids and threads as compensate_grid does, and that grid
    gives every (item, macroblock) exactly one warp."""
    assert int(re.search(r"QP_BIAS = (\d+);", SRC).group(1)) == K.QP_BIAS
    assert K.QP_BIAS % 32 == 0
    for name, mbs in (("MCQ", K.QPEL_MBS), ("BD", K.BIDIR_MBS)):
        m = re.search(rf"\b{name}_MBS = (\d+), {name}_MINB = (\d+);", SRC)
        assert int(m.group(1)) == mbs
        assert 65536 // (32 * mbs * int(m.group(2))) == 64
    for name in ("MCQ_MBS", "BD_MBS"):
        assert re.search(
            rf"dim3(?: grid)?\(\(n_mb \+ {name} - 1\) / {name}, g\)", SRC)
        assert len(re.findall(rf"32 \* {name}, 0,", SRC)) >= 1
    for mbs in (1, 2, 4, 8, 16):
        for n_mb in list(range(1, 70)) + [3600, 3601]:
            (blocks, items), threads = K.compensate_grid(n_mb, 3, mbs)
            assert items == 3 and threads == 32 * mbs <= 1024
            warps = [x * mbs + w for x in range(blocks) for w in range(mbs)]
            assert sorted(m for m in warps if m < n_mb) == list(range(n_mb))
            assert len(warps) - n_mb < mbs


@pytest.mark.parametrize("rnd", [0, 1])
def test_lowpass_lanes_equal_the_plain_filter(rnd):
    """lowpass2 on two lanes of tap sums in [0, 510] equals _lowpass's
    clip((20 s0 - 6 s1 + 3 s2 - s3 + 16 - rnd) >> 5, 0, 255) in each lane,
    at the extremes of every sum and on random ones; no lane disturbs the
    other."""
    rng = np.random.default_rng(22 + rnd)
    ext = np.array(np.meshgrid(*[[0, 1, 509, 510]] * 4, indexing="ij"))
    s = np.concatenate([ext.reshape(4, -1),
                        rng.integers(0, 511, (4, 200000))], 1)
    other = s[:, ::-1][:, np.r_[1:s.shape[1], 0]]
    packed = [_u32(a | (b << 16)) for a, b in zip(s, other)]
    got_lo, got_hi = _lanes(_lowpass2(*packed, rnd))
    for got, v in ((got_lo, s), (got_hi, other)):
        want = np.clip((20 * v[0] - 6 * v[1] + 3 * v[2] - v[3] + 16 - rnd)
                       >> 5, 0, 255)
        assert np.array_equal(got, want)
        biased = (20 * v[0] + 3 * v[2] + K.QP_BIAS + 16 - rnd
                  - 6 * v[1] - v[3])
        assert biased.min() >= 0 and (20 * v[0] + 3 * v[2] + K.QP_BIAS
                                      + 16).max() < 2 ** 16


def test_byte_means_are_the_rounded_means():
    """mean2 (both rounding types, 16-bit lanes) and avg8 (bytes, rounding
    up: V5's (f + b + 1) >> 1) over every pair of samples."""
    a, b = (x.ravel() for x in np.meshgrid(np.arange(256), np.arange(256),
                                            indexing="ij"))
    for rnd in (0, 1):
        got = _lanes(_mean2(_u32(a | (b << 16)), _u32(b | (a << 16)), rnd))
        assert np.array_equal(got[0], (a + b + 1 - rnd) >> 1)
        assert np.array_equal(got[1], (a + b + 1 - rnd) >> 1)
    for pos in range(4):
        wa, wb = _u32(a << (8 * pos)), _u32(b << (8 * pos))
        got = (wa | wb) - (((wa ^ wb) >> _u32(1)) & _u32(0x7F7F7F7F))
        assert np.array_equal(_bytes(_u32(got))[:, pos], (a + b + 1) >> 1)


@pytest.mark.parametrize("size", [16, 8])
@pytest.mark.parametrize("rnd", [0, 1])
def test_qpel_tasks_equal_qpel_block(size, rnd):
    """The kernels' quarter-pel block (tasks of 8 half samples from 15
    mirrored taps in fixed byte orders, a tile, rows of 8 from 8 tile
    rows, everything in 16-bit lanes) equals qpel_block at every (fx, fy)
    phase pair, on random windows and on 0/255 patterns that reach the
    filter's extremes."""
    rng = np.random.default_rng(size + rnd)
    h = w = 48
    refs = [rng.integers(0, 256, (h, w))]
    yy, xx = np.mgrid[:h, :w]
    for pat in ((xx + yy) % 2, (xx // 2 + yy // 2) % 2, xx % 3 == 1,
                (xx % 4 < 2) ^ (yy % 4 < 2)):
        refs.append(255 * pat.astype(np.int64))
    n = 40
    for ref in refs:
        bx = rng.integers(0, w - size - 1, n)
        by = rng.integers(0, h - size - 1, n)
        full = np.stack([ref[y: y + size + 1, x: x + size + 1]
                         for x, y in zip(bx, by)])
        for fx in range(4):
            for fy in range(4):
                with plain_threads(torch.device("cpu")):
                    want = K.qpel_block(
                        torch.from_numpy(ref), torch.from_numpy(bx),
                        torch.from_numpy(by), torch.full((n,), fx),
                        torch.full((n,), fy), size, w, h, rnd).numpy()
                got = _kernel_qpel(full, size, fx, fy, rnd)
                assert np.array_equal(got, want), (fx, fy)


@pytest.mark.parametrize("size", [16, 8])
def test_window_rule_reads_the_clamped_samples(size):
    """qpel_words over windows that cross each edge of the clamp box by
    1-24 px, at clamp widths 1-15 below the plane's: a wide read stays in
    its row (16-byte chunks below the plane width, a multiple of 16) and
    needs no clamp; both ways the task's bytes are qpel_block's clamped
    reads (a reference whose sample is its column)."""
    w16 = 64
    for ew in range(w16 - 15, w16 + 1):
        ref = torch.arange(w16).repeat(4, 1)
        for bx in list(range(-24 - size, 1)) + list(
                range(ew - size - 1, ew + 24)):
            cols = torch.cat([K.qpel_block(
                ref, torch.tensor([x]), torch.tensor([0]),
                torch.tensor([0]), torch.tensor([0]), size, ew, 4, 0)[0, 0]
                for x in (bx, bx + 1)]).tolist()
            window = cols[:size] + cols[-1:]
            assert window == [min(max(bx + i, 0), ew - 1)
                              for i in range(size + 1)]
            for case in ((0, 1) if size == 16 else (2,)):
                first, n = K.qpel_task_bytes(case)
                wide, read = K.qpel_words(bx, size, ew, case)
                task = window[first: first + n]
                if wide:
                    assert 0 <= read[0] and read[-1] < w16
                    assert len(read) % 16 == 0 and read[0] % 16 == 0
                    at = bx + first - read[0]
                    assert read[at: at + n] == task
                else:
                    assert read == task
                assert wide == (0 <= bx and bx + size < ew)
