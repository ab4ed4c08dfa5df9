"""The split score of the assignment kernel (`csrc/vq.cu`), emulated on
the CPU, against the per-row bound the kernel certifies its picks with
(`ops/vq_cuda.split_score_eps`).

The emulation does what the kernel's arithmetic may do at worst: each
operand split into hi = TF32 rounding (round to nearest, ties away, the
low 13 mantissa bits cleared, as `cvt.rna.tf32.f32`) and lo = the exact
rest; per 8 depths, the cross terms bf16(x_hi) bf16(e_lo) and
bf16(x_lo) bf16(e_hi) (round to nearest even, as `cvt.rn.bf16x2.f32`)
accumulated as one m16n8k16 bf16 step (17 addends), then x_hi e_hi as
one m16n8k8 TF32 step (9 addends); each accumulation aligns its addends
to the largest, truncates them to 24 bits and truncates the sum to
float32. The exact score is taken in float64. Every score must lie
within eps_row of it, and a row whose two best split scores are more
than 2 eps_row apart must have the exact argmax.
"""

import numpy as np
import pytest

from faceoff_tpu_torch.ops import vq_cuda


def tf32_rna(a):
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def bf16_rn(a):
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def split(a):
    hi = tf32_rna(a)
    return hi, a - hi


def truncating_mma(c, prods):
    """c (R, K) + sum of prods (R, K, m), float64 exact inputs: addends
    aligned to the largest and truncated to 24 bits, the sum truncated
    to float32."""
    terms = np.concatenate([c[..., None], prods], axis=-1)
    top = np.abs(terms).max(-1, keepdims=True)
    quantum = np.where(top > 0, 2.0 ** (np.floor(np.log2(
        np.where(top > 0, top, 1.0))) - 23), 1.0)
    s = (np.trunc(terms / quantum) * quantum).sum(-1)
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r.astype(np.float64)


def split_scores(x, e):
    """x (R, D), e (D, K) float32 -> (split scores, half norms), as the
    kernel computes them, the depth padded to a multiple of 8."""
    r, d = x.shape
    dp = -(-d // 8) * 8
    xp = np.zeros((r, dp), np.float32)
    xp[:, :d] = x
    ep = np.zeros((dp, e.shape[1]), np.float32)
    ep[:d] = e
    (xh, xl), (eh, el) = split(xp), split(ep)
    c = np.zeros((r, e.shape[1]))
    def prods(a, b, sl):
        return (a[:, None, sl].astype(np.float64)
                * b[sl].T[None].astype(np.float64))

    for k0 in range(0, dp, 8):
        sl = slice(k0, k0 + 8)
        cross = np.concatenate([prods(bf16_rn(xh), bf16_rn(el), sl),
                                prods(bf16_rn(xl), bf16_rn(eh), sl)], -1)
        c = truncating_mma(c, cross)
        c = truncating_mma(c, prods(xh, eh, sl))
    hn = np.zeros(e.shape[1], np.float32)
    for row in e:
        hn = np.float32(hn + row * row)
    hn = np.float32(0.5) * hn
    approx = (c.astype(np.float32) - hn).astype(np.float64)
    return approx, hn.astype(np.float64)


def eps_rows(x, e):
    c1, c2 = vq_cuda.split_score_eps(x.shape[1])
    emax2 = float((e.astype(np.float64) ** 2).sum(0).max())
    nx = np.sqrt((x.astype(np.float64) ** 2).sum(1))
    return c1 * nx * np.sqrt(emax2) + c2 * emax2


def check(x, e):
    approx, hn = split_scores(x, e)
    exact = x.astype(np.float64) @ e.astype(np.float64) - hn
    eps = eps_rows(x, e)
    err = np.abs(approx - exact).max(1)
    assert (err <= eps).all(), float((err / eps).max())
    top2 = np.sort(approx, 1)[:, -2:]
    certified = top2[:, 1] - top2[:, 0] > 2 * eps
    assert (approx.argmax(1)[certified] == exact.argmax(1)[certified]).all()
    # and a row whose exact gap exceeds 4 eps is never left to the re-score
    ex2 = np.sort(exact, 1)[:, -2:]
    assert certified[ex2[:, 1] - ex2[:, 0] > 4 * eps].all()
    return certified, float((err / eps).max())


@pytest.mark.parametrize("r,d,k", [(256, 64, 64), (128, 13, 40),
                                   (64, 224, 24)])
def test_split_scores_within_bound(r, d, k):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((r, d)).astype(np.float32)
    e = rng.standard_normal((d, k)).astype(np.float32)
    certified, worst = check(x, e)
    print(f"certified {certified.mean():.4f}, worst error {worst:.4f} eps")


def test_split_scores_within_bound_over_magnitudes():
    """Entries spanning 2^-12 .. 2^12 in both operands, so that the
    truncating alignment drops whole small products."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((128, 64))
         * 2.0 ** rng.integers(-12, 13, (128, 64))).astype(np.float32)
    e = (rng.standard_normal((64, 48))
         * 2.0 ** rng.integers(-12, 13, (64, 48))).astype(np.float32)
    check(x, e)


def test_near_equal_codes_are_flagged():
    """Codes 5 and 9 equal, codes 20 and 21 one float32 ulp apart, and
    rows drawn near them: the split scores cannot tell such codes apart,
    so every such row must be left to the exact re-score."""
    rng = np.random.default_rng(8)
    d, k = 64, 32
    e = rng.standard_normal((d, k)).astype(np.float32)
    e[:, 9] = e[:, 5]
    e[:, 21] = np.nextafter(e[:, 20], np.float32(np.inf))
    rows = np.concatenate([
        e[:, [5] * 32].T, e[:, [20] * 32].T,
        rng.standard_normal((64, d))]).astype(np.float32)
    rows[:64] += 1e-3 * rng.standard_normal((64, d)).astype(np.float32)
    certified, _ = check(rows, e)
    assert not certified[:64].any()
