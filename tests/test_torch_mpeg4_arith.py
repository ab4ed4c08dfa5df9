"""The arithmetic that kernels V3 and V4 of `csrc/mpeg4.cu` do otherwise
than their plain versions in `ops/mpeg4_cuda.py`, checked over every value
it can meet, on the CPU:

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

import numpy as np
import pytest
import torch

from faceoff_tpu_torch.ops import mpeg4_cuda as K

QPS = np.arange(1, 32)


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
