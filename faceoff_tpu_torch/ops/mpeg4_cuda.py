"""The device stages of the MPEG-4 Part 2 (`mp4v`) codec and its host
entropy coder (`csrc/mpeg4.cu`), with the plain torch version of each
stage beside its kernel.

    V1 dequant_idct       inverse quantisation (H.263, or MPEG with the
                          VOL's matrices and mismatch control), then the
                          integer 8x8 IDCT, of the coded blocks of a batch
    V2 motion_compensate  the half- or quarter-pel prediction of the k-th
                          anchor VOP of every GOP of a batch from its
                          reference, plus the residual, clipped to 8 bits
    V3 motion_search      the encoder's +-16 pixel full search with
                          half-pel refinement and the intra decision
    V4 fdct_quant         the encoder's integer 8x8 forward DCT and H.263
                          quantisation
    V5 bidir_compensate   the prediction of every B-VOP of a batch from its
                          two anchors (forward, backward, their rounded
                          mean, or direct mode's vector a block), half- or
                          quarter-pel, plus the residual, clipped

They replace work that the JAX package hands to cv2's FFmpeg on the host;
no TPU kernel and no PyTorch call computes them. All five are integer
arithmetic, so each kernel equals its plain version bit for bit. The IDCT
is the integer "simple" IDCT (22725, 21407, 19266, 16383, 12873, 8867,
4520; rows >> 11, columns >> 20, a DC-only row shortcut), which meets IEEE
1180 and is the one FFmpeg decodes its own `mp4v` streams with, or for
Xvid's streams FFmpeg's port of Xvid's IDCT (idct_xvid_plain). The
forward DCT is an orthonormal matrix DCT in 13-bit fixed point (rows
rounded >> 10, columns >> 16). Quarter-pel prediction is the standard's
8-tap half-sample filter (20, -6, 3, -1), taps mirrored at the edges of
the 16 x 16 or 8 x 8 block, the quarter samples the mean of their two
neighbours, in FFmpeg's order of operations.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises (also where a tensor is not aligned for
the kernel's vector loads: 16 bytes for V1's blocks and output, the V2
and V5 residuals, V3's planes and the luma planes of V2's and V5's
quarter-pel forms, 8 for V1's records and the other V2, V4 and V5
planes).
`launches` counts the kernel launches of each stage. The host coder (`parse_vops`, `write_vops`) spreads the VOPs of
a batch over threads in C++ and is called once a batch.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from faceoff_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "mpeg4.cu"

MB_FIELDS = 12
# modes of an anchor (I/P) macroblock record; MB_INTER4V is inter with
# four vectors (8 x 8 prediction blocks)
MB_SKIP, MB_INTER, MB_INTRA, MB_INTER4V = 0, 1, 2, 3
# A B-VOP macroblock record (B_FIELDS int32): mode (MB_INTER), qp, cbp,
# B_DIR bits, then the four luma block vectors of the forward prediction
# (x, y) and those of the backward one, in half or quarter pels
B_FIELDS = 20
B_FWD, B_BWD, B_8X8 = 1, 2, 4
# P-VOP macroblocks go intra where deviation + INTRA_BIAS < best SAD
INTRA_BIAS = 512
SEARCH_RANGE = 16

# kernel launches made through the wrappers in this process
launches: Dict[str, int] = {"dequant_idct": 0, "motion_compensate": 0,
                            "motion_search": 0, "fdct_quant": 0,
                            "bidir_compensate": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

# the simple IDCT's constants
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20
# V1's kernel runs an IDCT column in int32 where every |input| <= COL_SAFE:
# each partial sum is then at most (W1 + W2 + W3 + 2 W4 + W5 + W6 + W7)
# COL_SAFE + W4 (2^19 // W4) = 122424 * 17537 + 524256 < 2^31
# (tests/test_torch_mpeg4_arith.py); other columns take 64 bits
COL_SAFE = 17537


def fdct_matrix() -> np.ndarray:
    """(8, 8) int64: round(2^13 * c(u) / 2 * cos((2x + 1) u pi / 16))."""
    m = np.zeros((8, 8), np.int64)
    for u in range(8):
        cu = math.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            m[u, x] = round(8192 * cu / 2 * math.cos((2 * x + 1) * u
                                                     * math.pi / 16))
    return m


FDCT = fdct_matrix()


def dc_scaler(qp: torch.Tensor, luma: torch.Tensor) -> torch.Tensor:
    """The intra DC step of each qp (Table 7-1), luma or chroma."""
    lum = torch.where(qp < 9, 2 * qp, torch.where(qp < 25, qp + 8,
                                                  2 * qp - 16))
    chrom = torch.where(qp < 25, (qp + 13) // 2, qp - 6)
    return torch.where(qp < 5, torch.full_like(qp, 8),
                       torch.where(luma, lum, chrom))


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """x stored to int16 and read back, as the C code's int16 rows."""
    return ((x + 32768) & 0xFFFF) - 32768


# --- V1: dequantisation and IDCT -------------------------------------------

def _idct_rows(r: torch.Tensor) -> torch.Tensor:
    """The simple IDCT's row pass on (..., 8) int64."""
    x = [r[..., i] for i in range(8)]
    a0 = W4 * x[0] + (1 << (ROW_SHIFT - 1))
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * x[2] + W4 * x[4] + W6 * x[6]
    a1 = a1 + W6 * x[2] - W4 * x[4] - W2 * x[6]
    a2 = a2 - W6 * x[2] - W4 * x[4] + W2 * x[6]
    a3 = a3 - W2 * x[2] + W4 * x[4] - W6 * x[6]
    b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7]
    b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7]
    b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7]
    b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7]
    out = torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                       a3 - b3, a2 - b2, a1 - b1, a0 - b0], -1) >> ROW_SHIFT
    dc_only = (r[..., 1:] == 0).all(-1, keepdim=True)
    out = torch.where(dc_only, (x[0] * 8).unsqueeze(-1).expand_as(out), out)
    return _wrap16(out)


def _idct_cols(c: torch.Tensor) -> torch.Tensor:
    """The column pass on (..., 8) int64 (one column, top to bottom)."""
    x = [c[..., i] for i in range(8)]
    a0 = W4 * (x[0] + ((1 << (COL_SHIFT - 1)) // W4))
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * x[2] + W4 * x[4] + W6 * x[6]
    a1 = a1 + W6 * x[2] - W4 * x[4] - W2 * x[6]
    a2 = a2 - W6 * x[2] - W4 * x[4] + W2 * x[6]
    a3 = a3 - W2 * x[2] + W4 * x[4] - W6 * x[6]
    b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7]
    b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7]
    b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7]
    b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7]
    return torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                        a3 - b3, a2 - b2, a1 - b1, a0 - b0], -1) >> COL_SHIFT


def idct_plain(coef: torch.Tensor) -> torch.Tensor:
    """(N, 64) dequantised coefficients (raster) -> (N, 64) int16."""
    r = _idct_rows(coef.to(torch.int64).view(-1, 8, 8))
    out = _idct_cols(r.transpose(1, 2)).transpose(1, 2)
    return _wrap16(out).reshape(-1, 64).to(torch.int16)


# FFmpeg's port of Xvid's IDCT (libavcodec/xvididct.c), which it decodes
# Xvid's streams with: a row pass with a table and a rounding term for
# each row (rows >> 11), then a column pass of 16-bit fixed-point tangents
# (>> 16) and butterflies (>> 6)
XVID_TABS = ((22725, 21407, 19266, 16384, 12873, 8867, 4520),
             (31521, 29692, 26722, 22725, 17855, 12299, 6270),
             (29692, 27969, 25172, 21407, 16819, 11585, 5906),
             (26722, 25172, 22654, 19266, 15137, 10426, 5315))
XVID_ROW_TAB = (0, 1, 2, 3, 0, 3, 2, 1)
XVID_ROW_RND = (65536, 3597, 2260, 1203, 0, 120, 512, 512)
XVID_TAN1, XVID_TAN2, XVID_TAN3, XVID_SQRT2 = 0x32EC, 0x6A0A, 0xAB0E, 0x5A82


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _xmult(c: int, x: torch.Tensor) -> torch.Tensor:
    """(int)(c * (unsigned)x) >> 16, as the C code's MULT."""
    return _wrap32(c * x) >> 16


def idct_xvid_plain(coef: torch.Tensor) -> torch.Tensor:
    """(N, 64) dequantised coefficients (raster) -> (N, 64) int16 by the
    Xvid IDCT."""
    x = coef.to(torch.int64).view(-1, 8, 8)
    tab = torch.tensor([XVID_TABS[t] for t in XVID_ROW_TAB],
                       device=x.device).view(1, 8, 7)
    rnd = torch.tensor(XVID_ROW_RND, device=x.device).view(1, 8)
    c1, c2, c3, c4, c5, c6, c7 = [tab[..., i] for i in range(7)]
    i = [x[..., k] for k in range(8)]
    k = c4 * i[0] + rnd
    a0 = k + c2 * i[2] + c4 * i[4] + c6 * i[6]
    a1 = k + c6 * i[2] - c4 * i[4] - c2 * i[6]
    a2 = k - c6 * i[2] - c4 * i[4] + c2 * i[6]
    a3 = k - c2 * i[2] + c4 * i[4] - c6 * i[6]
    b0 = c1 * i[1] + c3 * i[3] + c5 * i[5] + c7 * i[7]
    b1 = c3 * i[1] - c7 * i[3] - c1 * i[5] - c5 * i[7]
    b2 = c5 * i[1] - c1 * i[3] + c7 * i[5] + c3 * i[7]
    b3 = c7 * i[1] - c5 * i[3] + c3 * i[5] - c1 * i[7]
    r = torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2,
                     a1 - b1, a0 - b0], -1)
    # (the C code's shortcuts for rows with few coefficients give these
    # same values)
    r = _wrap16(_wrap32(r) >> ROW_SHIFT)
    y = [r[:, k, :] for k in range(8)]   # y[k]: row k, every column
    # odd part
    m0 = _xmult(XVID_TAN1, y[7]) + y[1]
    m1 = _xmult(XVID_TAN1, y[1]) - y[7]
    m2 = _xmult(XVID_TAN3, y[5]) + y[3]
    m3 = _xmult(XVID_TAN3, y[3]) - y[5]
    m7 = m0 + m2
    m4 = m1 - m3
    m0 = m0 - m2
    m1 = m1 + m3
    m6 = 2 * _xmult(XVID_SQRT2, m0 + m1)
    m5 = 2 * _xmult(XVID_SQRT2, m0 - m1)
    # even part
    e3 = _xmult(XVID_TAN2, y[6]) + y[2]
    e2 = _xmult(XVID_TAN2, y[2]) - y[6]
    e0 = y[0] + y[4]
    e1 = y[0] - y[4]
    o = [None] * 8
    t0, t3 = e0 + e3, e0 - e3
    o[0], o[7] = t0 + m7, t0 - m7
    o[3], o[4] = t3 + m4, t3 - m4
    t1, t2 = e1 + e2, e1 - e2
    o[1], o[6] = t1 + m6, t1 - m6
    o[2], o[5] = t2 + m5, t2 - m5
    out = torch.stack([_wrap16(_wrap32(v) >> 6) for v in o], 1)
    return out.reshape(-1, 64).to(torch.int16)


def dequantize_plain(levels: torch.Tensor, qp: torch.Tensor,
                     intra: torch.Tensor, luma: torch.Tensor
                     ) -> torch.Tensor:
    """H.263 inverse quantisation of (N, 64) levels: |F| = qp (2 |l| + 1),
    less one for an even qp; the intra DC is its level times the
    dc_scaler; all clamped to [-2048, 2047]. (N, 64) int64."""
    lv = levels.to(torch.int64)
    q = qp.to(torch.int64).unsqueeze(1)
    mag = q * (2 * lv.abs() + 1) - (1 - (q & 1))
    f = torch.where(lv == 0, torch.zeros_like(lv), torch.sign(lv) * mag)
    dc = lv[:, 0] * dc_scaler(qp.to(torch.int64), luma)
    f[:, 0] = torch.where(intra, dc, f[:, 0])
    return f.clamp(-2048, 2047)


# The default matrices of MPEG quantisation (ISO/IEC 14496-2, 6.3.3), in
# raster order; a VOL may load others
DEFAULT_INTRA_MATRIX = (
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45)
DEFAULT_INTER_MATRIX = (
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33)


def dequantize_mpeg_plain(levels: torch.Tensor, qp: torch.Tensor,
                          intra: torch.Tensor, luma: torch.Tensor,
                          matrices: torch.Tensor) -> torch.Tensor:
    """MPEG inverse quantisation (ISO/IEC 14496-2, 7.4.4.2, quant_type 1)
    of (N, 64) levels with `matrices` (2, 64) (intra, inter; raster):
    F = (2 l + k) W qp / 16, k = 0 for intra blocks and sign(l) for inter
    ones, the division truncating toward zero; the intra DC is its level
    times the dc_scaler; all saturated to [-2048, 2047]; then mismatch
    control on inter blocks: where the sum of the 64 values is even, the
    last one's least bit flips. Intra blocks take no mismatch control, as
    FFmpeg decodes them (the standard asks for it; see io/mpeg4.py).
    (N, 64) int64."""
    lv = levels.to(torch.int64)
    q = qp.to(torch.int64).unsqueeze(1)
    w = matrices.to(lv.device, torch.int64)[
        torch.where(intra, 0, 1).to(torch.int64)]
    k = torch.where(intra.unsqueeze(1), torch.zeros_like(lv), torch.sign(lv))
    num = (2 * lv + k) * w * q
    f = torch.sign(num) * (num.abs() >> 4)
    dc = lv[:, 0] * dc_scaler(qp.to(torch.int64), luma)
    f[:, 0] = torch.where(intra, dc, f[:, 0])
    f = f.clamp(-2048, 2047)
    flip = (~intra) & (f.sum(1) % 2 == 0)
    f[:, 63] = torch.where(flip, f[:, 63] ^ 1, f[:, 63])
    return f


def _block_params(bidx: torch.Tensor, mb: torch.Tensor):
    rows = mb.reshape(-1, mb.shape[-1])[(bidx // 6).to(torch.int64)]
    return (rows[:, 1], rows[:, 0] == MB_INTRA, (bidx % 6) < 4)


def dequant_idct_plain(blocks: torch.Tensor, bidx: torch.Tensor,
                       mb: torch.Tensor, out: torch.Tensor,
                       matrices: Optional[torch.Tensor] = None,
                       xvid: bool = False) -> torch.Tensor:
    """The plain V1: each row of `blocks` (NB, 64) int16 levels,
    dequantised with the qp and mode of its macroblock in `mb` (F, M,
    MB_FIELDS or B_FIELDS), by H.263 rules or, given `matrices` (2, 64)
    int32 (intra, inter), by MPEG rules, inverse transformed (by the Xvid
    IDCT with `xvid`, else the simple IDCT) into row bidx of `out`
    (F * M * 6, 64) int16."""
    if blocks.shape[0] == 0:
        return out
    qp, intra, luma = _block_params(bidx, mb)
    if matrices is None:
        coef = dequantize_plain(blocks, qp, intra, luma)
    else:
        coef = dequantize_mpeg_plain(blocks, qp, intra, luma, matrices)
    idct = idct_xvid_plain if xvid else idct_plain
    out.view(-1, 64)[bidx.to(torch.int64)] = idct(coef)
    return out


# --- V2: motion compensation ------------------------------------------------

_CHROMA_ROUND = torch.tensor([0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2])


def chroma_vector(s: torch.Tensor) -> torch.Tensor:
    """The chroma vector (half pels) from the sum of the four luma block
    vectors (Table 7-9's sixteenth-pel rounding; for four equal vectors
    it is the one-vector rule (v >> 1) | (v & 1))."""
    tab = _CHROMA_ROUND.to(s.device)
    return tab[s & 15] + ((s >> 3) & ~1)


def _interp(ref: torch.Tensor, X: torch.Tensor, Y: torch.Tensor, w: int,
            h: int, rounding: int) -> torch.Tensor:
    """Half-pel bilinear samples of `ref` (H, W) int64 at half-pel
    coordinates X, Y, every tap clamped into the w x h picture."""
    x0, y0, fx, fy = X >> 1, Y >> 1, X & 1, Y & 1
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    a, b = ref[ya, xa], ref[ya, xb]
    c, d = ref[yb, xa], ref[yb, xb]
    r = rounding
    return torch.where(
        fx == 0,
        torch.where(fy == 0, a, (a + c + 1 - r) >> 1),
        torch.where(fy == 0, (a + b + 1 - r) >> 1,
                    (a + b + c + d + 2 - r) >> 2))


def _mc_grids(mbw: int, mbh: int, dev):
    """Per macroblock and pixel: luma (M, 256) block index and x, y
    offsets; chroma (M, 64) offsets."""
    m = torch.arange(mbw * mbh, device=dev)
    my, mx = (m // mbw).unsqueeze(1), (m % mbw).unsqueeze(1)
    p = torch.arange(256, device=dev).unsqueeze(0)
    py, px = p // 16, p % 16
    blk = (py >= 8).to(torch.int64) * 2 + (px >= 8).to(torch.int64)
    q = torch.arange(64, device=dev).unsqueeze(0)
    return (mx * 16 + px, my * 16 + py, blk,
            mx * 8 + q % 8, my * 8 + q // 8)


def _residual_planes(res: torch.Tensor, mbw: int, mbh: int):
    """(M, 6, 64) residual -> luma (M, 256) and chroma (2, M, 64) in the
    macroblocks' pixel order."""
    r = res.to(torch.int64).view(-1, 6, 8, 8)
    luma = r[:, :4].view(-1, 2, 2, 8, 8).permute(0, 1, 3, 2, 4)
    return luma.reshape(-1, 256), r[:, 4:].reshape(-1, 2, 64).transpose(0, 1)


def _mirror_taps(size: int) -> torch.Tensor:
    """(size, 8) sample index of taps -3 .. +4 of each half-sample output
    i (between samples i and i + 1) over samples 0 .. size, mirrored at
    the block's edges (-1 -> 0, -2 -> 1, size + 1 -> size, ...)."""
    i = torch.arange(size).unsqueeze(1) + torch.arange(-3, 5).unsqueeze(0)
    i = torch.where(i < 0, -1 - i, i)
    return torch.where(i > size, 2 * size + 1 - i, i)


def _lowpass(a: torch.Tensor, dim: int, rounding: int) -> torch.Tensor:
    """The 8-tap half-sample filter along `dim` of `a` (size + 1 samples
    there): (20 (s0 + s1) - 6 (s-1 + s2) + 3 (s-2 + s3) - (s-3 + s4) + 16 -
    rounding) >> 5, clipped to [0, 255]; size outputs."""
    a = a.movedim(dim, -1)
    t = a[..., _mirror_taps(a.shape[-1] - 1).to(a.device)]
    v = (20 * (t[..., 3] + t[..., 4]) - 6 * (t[..., 2] + t[..., 5])
         + 3 * (t[..., 1] + t[..., 6]) - (t[..., 0] + t[..., 7]))
    return ((v + 16 - rounding) >> 5).clamp(0, 255).movedim(-1, dim)


def qpel_block(ref: torch.Tensor, bx: torch.Tensor, by: torch.Tensor,
               vx: torch.Tensor, vy: torch.Tensor, size: int, width: int,
               height: int, rounding: int) -> torch.Tensor:
    """Quarter-pel prediction of N blocks of size x size at block origins
    (bx, by) with vectors (vx, vy) in quarter pels from `ref` (H, W)
    int64: (N, size, size) int64. The (size + 1)^2 integer samples from
    (bx + vx >> 2, by + vy >> 2) are read clamped into the width x height
    picture; the horizontal half samples are filtered over each row
    (_lowpass), a quarter position x is the mean of the half sample and
    its integer neighbour, then the same is done down the columns of that
    result: FFmpeg's qpel functions, (a + b + 1 - rounding) >> 1 for each
    mean."""
    dev = ref.device
    r = torch.arange(size + 1, device=dev)
    x0 = (bx + (vx >> 2)).unsqueeze(1) + r
    y0 = (by + (vy >> 2)).unsqueeze(1) + r
    full = ref[y0.clamp(0, height - 1).unsqueeze(2),
               x0.clamp(0, width - 1).unsqueeze(1)]
    fx = (vx & 3).view(-1, 1, 1)
    fy = (vy & 3).view(-1, 1, 1)
    h = _lowpass(full, 2, rounding)

    def mean(a, b):
        return (a + b + 1 - rounding) >> 1

    half = torch.where(fx == 0, full[:, :, :size], torch.where(
        fx == 1, mean(h, full[:, :, :size]), torch.where(
            fx == 2, h, mean(h, full[:, :, 1:]))))
    v = _lowpass(half, 1, rounding)
    return torch.where(fy == 0, half[:, :size], torch.where(
        fy == 1, mean(half[:, :size], v), torch.where(
            fy == 2, v, mean(half[:, 1:], v))))


def _tdiv2(v: torch.Tensor) -> torch.Tensor:
    """v / 2 truncated toward zero (C's division)."""
    return torch.sign(v) * (v.abs() >> 1)


_QPEL_CHROMA2 = torch.tensor([0, 0, 1, 1, 0, 0, 0, 1])


def qpel_half(v: torch.Tensor, rule: int = 0) -> torch.Tensor:
    """The half-pel luma vector that a one-vector quarter-pel macroblock's
    chroma derives from: v / 2 truncated toward zero, or by FFmpeg's DivX
    workarounds (rule 1, FF_BUG_QPEL_CHROMA: (v >> 1) | (v & 1); rule 2,
    FF_BUG_QPEL_CHROMA2: (v >> 1) + (0, 0, 1, 1, 0, 0, 0, 1)[v & 7])."""
    if rule == 1:
        return (v >> 1) | (v & 1)
    if rule == 2:
        return (v >> 1) + _QPEL_CHROMA2.to(v.device)[v & 7]
    return _tdiv2(v)


def chroma_vectors(mv: torch.Tensor, four: torch.Tensor, qpel: bool,
                   rule: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chroma vector (x, y) in half pels of each macroblock from its
    luma block vectors mv (M, 4, 2): half-pel, the rule of chroma_vector
    on their sum; quarter-pel as FFmpeg derives it, with four vectors the
    same rule on the sum of each vector / 2 (truncated toward zero), with
    one vector h = qpel_half(v, rule), then (h >> 1) | (h & 1)."""
    if not qpel:
        s = mv.sum(1)
    else:
        s = torch.where(four.view(-1, 1), _tdiv2(mv).sum(1),
                        4 * qpel_half(mv[:, 0], rule))
    return chroma_vector(s[:, 0]), chroma_vector(s[:, 1])


def _luma_pred(ref: torch.Tensor, mv: torch.Tensor, four: torch.Tensor,
               qpel: bool, grids, width: int, height: int,
               rounding: int) -> torch.Tensor:
    """The luma prediction (M, 256) int64, in each macroblock's pixel
    order, from `ref` (H, W) int64 and block vectors mv (M, 4, 2):
    half-pel bilinear samples per pixel, or quarter-pel blocks (one of
    16 x 16 per macroblock, or four of 8 x 8 where `four`)."""
    lx, ly, blk = grids[:3]
    if not qpel:
        bk = blk.expand(mv.shape[0], -1)
        mvx = torch.gather(mv[:, :, 0], 1, bk)
        mvy = torch.gather(mv[:, :, 1], 1, bk)
        return _interp(ref, 2 * lx + mvx, 2 * ly + mvy, width, height,
                       rounding)
    bx, by = lx[:, 0], ly[:, 0]
    p16 = qpel_block(ref, bx, by, mv[:, 0, 0], mv[:, 0, 1], 16, width,
                     height, rounding)
    p8 = torch.stack([qpel_block(ref, bx + 8 * (b & 1), by + 8 * (b >> 1),
                                 mv[:, b, 0], mv[:, b, 1], 8, width, height,
                                 rounding) for b in range(4)], 1)
    p8 = p8.view(-1, 2, 2, 8, 8).permute(0, 1, 3, 2, 4).reshape(-1, 16, 16)
    return torch.where(four.view(-1, 1, 1), p8, p16).reshape(-1, 256)


def _predict(planes, slot: int, mv: torch.Tensor, four: torch.Tensor,
             qpel: bool, grids, width: int, height: int, rounding: int,
             rule: int = 0):
    """Luma (M, 256) and chroma (2, M, 64) int64 predictions of every
    macroblock of slot `slot` of the planes."""
    y_pl, u_pl, v_pl = planes
    cx, cy = grids[3], grids[4]
    p_l = _luma_pred(y_pl[slot].to(torch.int64), mv, four, qpel, grids,
                     width, height, rounding)
    cmx, cmy = chroma_vectors(mv, four, qpel, rule)
    p_c = torch.stack([_interp(pl[slot].to(torch.int64),
                               2 * cx + cmx.unsqueeze(1),
                               2 * cy + cmy.unsqueeze(1), width // 2,
                               height // 2, rounding)
                       for pl in (u_pl, v_pl)])
    return p_l, p_c


def _store(planes, out: int, grids, p_l, p_c, r_l, r_c) -> None:
    y_pl, u_pl, v_pl = planes
    lx, ly, _, cx, cy = grids
    y_pl[out][ly, lx] = (p_l + r_l).clamp(0, 255).to(torch.uint8)
    for c, pl in enumerate((u_pl, v_pl)):
        pl[out][cy, cx] = (p_c[c] + r_c[c]).clamp(0, 255).to(torch.uint8)


def _residual(res: Optional[torch.Tensor], f: int, mbw: int, mbh: int,
              grids):
    if res is not None:
        return _residual_planes(res[f], mbw, mbh)
    lx, cx = grids[0], grids[3]
    return (torch.zeros_like(lx),
            torch.zeros((2,) + cx.shape, dtype=torch.int64,
                        device=lx.device))


def motion_compensate_plain(planes: Sequence[torch.Tensor], mb: torch.Tensor,
                            res: Optional[torch.Tensor], items: torch.Tensor,
                            width: int, height: int, qpel: bool = False,
                            qpel_chroma: int = 0) -> None:
    """The plain V2. planes: Y (S, H16, W16), U, V (S, H16/2, W16/2) uint8
    slots; items (G, 4) int32 rows (f, reference slot, output slot,
    rounding type): macroblocks mb[f] (F, M, MB_FIELDS) and residual
    res[f] (F, M, 6, 64) int16 (None: zero) make output slot from
    reference slot. Intra macroblocks take the residual alone, not-coded
    ones the reference; every reference tap is clamped into the width x
    height picture. Vectors are in half pels, or in quarter pels with
    `qpel` (MB_INTER4V macroblocks then predict 8 x 8 blocks, others
    16 x 16; `qpel_chroma` is chroma_vectors' rule). Writes the output
    slots in place."""
    h16, w16 = planes[0].shape[1:]
    mbw, mbh = w16 // 16, h16 // 16
    grids = _mc_grids(mbw, mbh, planes[0].device)
    for f, ref, out, rnd in items.tolist():
        rec = mb[f].to(torch.int64)
        intra = rec[:, 0:1] == MB_INTRA
        r_l, r_c = _residual(res, f, mbw, mbh, grids)
        if ref >= 0:
            p_l, p_c = _predict(planes, ref, rec[:, 4:12].view(-1, 4, 2),
                                rec[:, 0] == MB_INTER4V, qpel, grids, width,
                                height, rnd, qpel_chroma)
            p_l = torch.where(intra, torch.zeros_like(p_l), p_l)
            p_c = torch.where(intra.unsqueeze(0), torch.zeros_like(p_c), p_c)
        else:
            p_l = torch.zeros_like(r_l)
            p_c = torch.zeros_like(r_c)
        _store(planes, out, grids, p_l, p_c, r_l, r_c)


# --- V5: bidirectional prediction --------------------------------------------

def bidir_compensate_plain(planes: Sequence[torch.Tensor], bmb: torch.Tensor,
                           res: Optional[torch.Tensor], items: torch.Tensor,
                           width: int, height: int, qpel: bool = False,
                           qpel_chroma: int = 0) -> None:
    """The plain V5. items (G, 4) int32 rows (j, past slot, future slot,
    output slot): the B-VOP macroblocks bmb[j] (FB, M, B_FIELDS) predict
    from the past slot with their forward vectors (B_FWD), from the
    future slot with their backward ones (B_BWD), or from both, the two
    predictions then meeting as (f + b + 1) >> 1; B_8X8 macroblocks
    predict four 8 x 8 blocks with a vector each (direct mode), others
    one 16 x 16 block (which differs only in quarter-pel). Always rounding
    type 0. Plus the residual res[j] (FB, M, 6, 64) int16 (None: zero),
    clipped to 8 bits, into the output slot."""
    h16, w16 = planes[0].shape[1:]
    mbw, mbh = w16 // 16, h16 // 16
    grids = _mc_grids(mbw, mbh, planes[0].device)
    for j, past, future, out in items.tolist():
        rec = bmb[j].to(torch.int64)
        d = rec[:, 3]
        four = (d & B_8X8) != 0
        fwd, bwd = ((d & B_FWD) != 0).view(-1, 1), ((d & B_BWD) != 0).view(
            -1, 1)
        f_l, f_c = _predict(planes, past, rec[:, 4:12].view(-1, 4, 2), four,
                            qpel, grids, width, height, 0, qpel_chroma)
        b_l, b_c = _predict(planes, future, rec[:, 12:20].view(-1, 4, 2),
                            four, qpel, grids, width, height, 0, qpel_chroma)
        p_l = torch.where(fwd & bwd, (f_l + b_l + 1) >> 1,
                          torch.where(fwd, f_l, b_l))
        p_c = torch.where((fwd & bwd).unsqueeze(0), (f_c + b_c + 1) >> 1,
                          torch.where(fwd.unsqueeze(0), f_c, b_c))
        r_l, r_c = _residual(res, j, mbw, mbh, grids)
        _store(planes, out, grids, p_l, p_c, r_l, r_c)


# --- V2 at quarter-pel and V5 on the card --------------------------------------

# macroblocks (warps) a CUDA block of V2's quarter-pel form and of V5
# (csrc/mpeg4.cu's MCQ_MBS and BD_MBS)
QPEL_MBS = 4
BIDIR_MBS = 4
# the bias that keeps the kernels' 8-tap sums positive in 16-bit lanes
# (112 after the filter's shift by 5)
QP_BIAS = 3584


def compensate_grid(n_mb: int, items: int,
                    mbs: int) -> Tuple[Tuple[int, int], int]:
    """The launch of V2's quarter-pel form or V5 over `items` items of
    n_mb macroblocks, a warp a macroblock: ((CUDA blocks, items), threads
    a block). Warp w of block x takes macroblock x * mbs + w; the warps
    past n_mb return at once."""
    return ((n_mb + mbs - 1) // mbs, items), 32 * mbs


def qpel_task_bytes(case: int) -> Tuple[int, int]:
    """(first, count): the window bytes a quarter-pel horizontal task
    reads, case 0 and 1 the left and right half of a 16 x 16 block's row
    (its outputs 0-7 and 8-15, whose mirrored taps reach bytes 0-11 and
    5-16), case 2 an 8 x 8 block's row (bytes 0-8)."""
    return {0: (0, 12), 1: (5, 12), 2: (0, 9)}[case]


def qpel_words(bx: int, size: int, ew: int,
               case: int) -> Tuple[bool, List[int]]:
    """How the kernels read a task's window bytes in one row, for a block
    of `size` (16 or 8) whose window starts at column bx, in a picture
    clamped at ew columns: (wide, columns read). Wide where the window's
    size + 1 columns lie inside [0, ew): aligned 16-byte chunks from
    bx & ~15, two for a 16 x 16 block (one a lane of the pair that takes
    the row's halves, swapped by a shuffle), for an 8 x 8 block one, and
    the next where the 9 bytes reach into it. Otherwise the task's bytes
    a column at a time, each clamped into [0, ew). Rows are clamped
    whole, so no vertical rule is needed."""
    first, n = qpel_task_bytes(case)
    if bx >= 0 and bx + size + 1 <= ew:
        chunks = 2 if size == 16 or (bx & 15) + 9 > 16 else 1
        return True, list(range(bx & ~15, (bx & ~15) + 16 * chunks))
    return False, [min(max(bx + first + i, 0), ew - 1) for i in range(n)]


# --- V3: motion search -------------------------------------------------------

_HALF_ORDER = ((0, 0), (-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
               (-1, 1), (0, 1), (1, 1))


def motion_search_plain(src_y: torch.Tensor, items: torch.Tensor, width: int,
                        height: int) -> torch.Tensor:
    """The plain V3 on luma planes (N, H16, W16) uint8 and items (G, 2)
    int32 (current frame, reference frame): (G, M, 3) int32 rows (mode,
    mvx, mvy), the vector in half pels. The full search scores every
    integer vector of [-16, 16]^2 by the 16 x 16 SAD against the
    reference clamped into the picture, the least key (SAD, then the
    Chebyshev length, then dy, then dx) winning; the half-pel step scores
    the eight neighbours of that vector (rounding 0) after it, the first
    of equal SADs in _HALF_ORDER winning. A macroblock goes intra when its
    deviation from its own mean plus INTRA_BIAS is below the best SAD."""
    n, h16, w16 = src_y.shape
    mbw, mbh = w16 // 16, h16 // 16
    dev = src_y.device
    rng = SEARCH_RANGE
    pad = rng + 2
    yy = (torch.arange(-pad, h16 + pad, device=dev)).clamp(0, height - 1)
    xx = (torch.arange(-pad, w16 + pad, device=dev)).clamp(0, width - 1)
    lx, ly, _, _, _ = _mc_grids(mbw, mbh, dev)
    out = []
    for cur_i, ref_i in items.tolist():
        cur = src_y[cur_i].to(torch.int64)
        ref = src_y[ref_i].to(torch.int64)
        padded = ref[yy][:, xx]
        cur_mb = cur.view(mbh, 16, mbw, 16).permute(0, 2, 1, 3).reshape(-1,
                                                                      256)
        best = torch.full((mbw * mbh,), 2 ** 62, dtype=torch.int64,
                          device=dev)
        dxs = torch.arange(-rng, rng + 1, device=dev)
        for dy in range(-rng, rng + 1):
            rows = padded[pad + dy: pad + dy + h16]
            # every dx at once: (2 rng + 1, h16, w16) shifted windows
            win = rows.unfold(1, w16, 1)[:, pad - rng: pad + rng + 1]
            sad = (win.permute(1, 0, 2) - cur).abs().view(
                -1, mbh, 16, mbw, 16).sum((2, 4)).view(len(dxs), -1)
            order = ((torch.maximum(dxs.abs(), torch.tensor(abs(dy))) << 12)
                     | ((dy + rng) << 6) | (dxs + rng))
            best = torch.minimum(best, ((sad << 17) | order[:, None])
                                 .amin(0))
        order = best & ((1 << 17) - 1)
        bdx = (order & 63) - rng
        bdy = ((order >> 6) & 63) - rng
        keys = []
        for i, (hx, hy) in enumerate(_HALF_ORDER):
            X = 2 * lx + (2 * bdx + hx).unsqueeze(1)
            Y = 2 * ly + (2 * bdy + hy).unsqueeze(1)
            p = _interp(ref, X, Y, width, height, 0)
            keys.append(((p - cur_mb).abs().sum(1) << 4) | i)
        k2 = torch.stack(keys, 1).min(1).values
        sad = k2 >> 4
        pick = torch.tensor(_HALF_ORDER, device=dev)[k2 & 15]
        mvx = 2 * bdx + pick[:, 0]
        mvy = 2 * bdy + pick[:, 1]
        mean = (cur_mb.sum(1) + 128) >> 8
        devn = (cur_mb - mean.unsqueeze(1)).abs().sum(1)
        intra = devn + INTRA_BIAS < sad
        mode = torch.where(intra, MB_INTRA, MB_INTER)
        zero = torch.zeros_like(mvx)
        out.append(torch.stack([mode, torch.where(intra, zero, mvx),
                                torch.where(intra, zero, mvy)], 1))
    if not out:
        return torch.zeros((0, mbw * mbh, 3), dtype=torch.int32, device=dev)
    return torch.stack(out).to(torch.int32)


# --- V4: forward DCT and quantisation ---------------------------------------

def _blocks_of(planes: Sequence[torch.Tensor], slot: int) -> torch.Tensor:
    """The (M, 6, 64) int64 blocks of one slot of Y, U, V planes."""
    y_pl, u_pl, v_pl = planes
    h16, w16 = y_pl.shape[1:]
    mbw, mbh = w16 // 16, h16 // 16
    y = y_pl[slot].to(torch.int64).view(mbh, 2, 8, mbw, 2, 8)
    y = y.permute(0, 3, 1, 4, 2, 5).reshape(-1, 4, 64)
    cs = [pl[slot].to(torch.int64).view(mbh, 8, mbw, 8).permute(0, 2, 1, 3)
          .reshape(-1, 1, 64) for pl in (u_pl, v_pl)]
    return torch.cat([y] + cs, 1)


def fdct_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., 64) int64 samples -> (..., 64) int64 DCT coefficients."""
    m = torch.from_numpy(FDCT).to(x.device)
    b = x.reshape(-1, 8, 8)
    t = ((b.unsqueeze(2) * m.view(1, 1, 8, 8)).sum(-1) + 512) >> 10
    # t[n, y, u]; columns: F[n, v, u] = sum_y m[v, y] t[n, y, u]
    f = ((m.view(1, 8, 8, 1) * t.unsqueeze(1)).sum(2) + 32768) >> 16
    return f.reshape(x.shape)


def quantize_plain(f: torch.Tensor, qp: torch.Tensor, intra: torch.Tensor,
                   luma: torch.Tensor) -> torch.Tensor:
    """H.263 quantisation of (N, 64) int64 coefficients: intra AC
    |F| // (2 qp), inter (|F| - qp // 2) // (2 qp), clamped to 2047; the
    intra DC rounded by its dc_scaler into [1, 254]. (N, 64) int16."""
    q = qp.to(torch.int64).unsqueeze(1)
    a = f.abs()
    mag = torch.where(intra.unsqueeze(1), a // (2 * q),
                      (a - q // 2).clamp(min=0) // (2 * q))
    lv = (torch.sign(f) * mag.clamp(max=2047))
    s = dc_scaler(qp.to(torch.int64), luma)
    dc = ((f[:, 0] + (s >> 1)) // s).clamp(1, 254)
    lv[:, 0] = torch.where(intra, dc, lv[:, 0])
    return lv.to(torch.int16)


def fdct_bound() -> int:
    """The largest |coefficient| fdct_plain can give on samples or
    residuals in [-255, 255]: each pass's largest sum of |C| times its
    largest input, rounded as the pass rounds."""
    reach = int(np.abs(FDCT).sum(1).max())
    row = (reach * 255 + 512) >> 10
    return (reach * row + 32768) >> 16


F_MAX = fdct_bound()
# The kernel divides by 2 qp and by the DC scaler (2 .. 46) with a
# multiply-high by RECIP[d] = ceil(2^32 / d): floor(n / d) == (n *
# RECIP[d]) >> 32 for every numerator up to QUANT_N_MAX (its error term n
# (RECIP[d] d - 2^32) stays below 2^32 / d there; tests check each pair).
# The numerators: |F|, |F| - qp // 2, and the intra DC's F + s // 2 (or
# -F + s - 1 on the negative side) for a DC scaler s below 64.
QUANT_N_MAX = F_MAX + 64


def recip_table() -> np.ndarray:
    """(64,) uint32: ceil(2^32 / d) for d = 2 .. 63, 0 for d < 2."""
    d = np.arange(64, dtype=np.uint64)
    out = np.zeros(64, np.uint64)
    out[2:] = ((1 << 32) + d[2:] - 1) // d[2:]
    return out.astype(np.uint32)


RECIP = recip_table()


# V3's kernel packs the plain key (SAD << 17 | Chebyshev length << 12 |
# dy + 16 << 6 | dx + 16) into 32 bits: the SAD (below 2^16) over a
# mixed-radix order below 2^15 that sorts as (Chebyshev length, dy, dx).
ORDER_BITS = 15


def search_key(sad, dx, dy):
    """The kernel's 31-bit key of candidates (numpy or int arrays)."""
    side = 2 * SEARCH_RANGE + 1
    cheb = np.maximum(np.abs(dx), np.abs(dy))
    order = (cheb * side + dy + SEARCH_RANGE) * side + dx + SEARCH_RANGE
    return (np.asarray(sad, np.int64) << ORDER_BITS) | order


def fdct_quant_plain(src: Sequence[torch.Tensor], pred: Sequence[torch.Tensor],
                     mb: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """The plain V4: for each item (source frame, prediction slot), the
    blocks of macroblocks mb[g] (G, M, MB_FIELDS): intra ones from the
    source, others the source less the prediction, transformed and
    quantised with their qp. (G, M, 6, 64) int16."""
    out = []
    for g, (s, p) in enumerate(items.tolist()):
        rec = mb[g].to(torch.int64)
        intra = (rec[:, 0] == MB_INTRA)
        x = _blocks_of(src, s)
        x = torch.where(intra.view(-1, 1, 1), x, x - _blocks_of(pred, p))
        n_mb = x.shape[0]
        f = fdct_plain(x).view(-1, 64)
        qp = rec[:, 1].repeat_interleave(6)
        luma = (torch.arange(6, device=x.device) < 4).repeat(n_mb)
        out.append(quantize_plain(f, qp, intra.repeat_interleave(6), luma)
                   .view(n_mb, 6, 64))
    if not out:
        return torch.zeros((0,) + tuple(mb.shape[1:2]) + (6, 64),
                           dtype=torch.int16, device=mb.device)
    return torch.stack(out)


# --- the kernels ----------------------------------------------------------------

def library_path() -> Path:
    return cuda_build.library_path(SOURCE, "faceoff_mpeg4")


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    return cuda_build.build(SOURCE, "faceoff_mpeg4")


_P, _I = ctypes.c_void_p, ctypes.c_int


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process and hand
    the C++ entropy coder the VLC tables of `io/mpeg4.py`."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        sigs = {
            "mpeg4_dequant_idct": [_P, _P, _I, _P, _P, _I, _I, _I, _P],
            "mpeg4_motion_compensate": [_P, _P, _P, _I, _I, _P, _I, _P, _P,
                                        _I, _I, _I, _I, _I, _P],
            "mpeg4_set_matrices": [_P, _I, _P],
            "mpeg4_motion_search": [_P, _I, _I, _I, _P, _I, _I, _I, _P,
                                    _P],
            "mpeg4_fdct_quant": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                                 _P, _P, _I, _P, _P],
            "mpeg4_set_vlc": [_I, _I, _P, _P, _P],
            "mpeg4_bidir_compensate": [_P, _P, _P, _I, _I, _P, _I, _P, _P,
                                       _I, _I, _I, _I, _I, _P],
            "mpeg4_parse": [_P, _P, _P, _I, _P, _P, _I, _I,
                            ctypes.POINTER(ctypes.c_int64)],
            "mpeg4_parse_fetch": [_P, _P, _P, _P, _P, _P, _P, _P],
            "mpeg4_write": [_P, _P, _P, _I, _P, _I, ctypes.POINTER(
                ctypes.c_int64)],
            "mpeg4_write_fetch": [_P, _P, _P],
            "mpeg4_free": [_P],
            "mpeg4_error": [_P],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = _I
        lib.mpeg4_parse.restype = _P
        lib.mpeg4_write.restype = _P
        lib.mpeg4_error.restype = ctypes.c_char_p
        lib.mpeg4_set_recip.argtypes = [_P, _I, _P]
        lib.mpeg4_set_recip.restype = _I
        _send_tables(lib)
        _lib = lib
        return lib


_recip_sent: set = set()
_matrices_sent: Dict[Optional[int], bytes] = {}


def _send_matrices(lib: ctypes.CDLL, dev: torch.device,
                   matrices: torch.Tensor) -> None:
    """MPEG quantisation's matrices (a host tensor) into the constant
    memory of `dev`, when they differ from those sent last (synchronous:
    a VOL's matrices are sent once, so a call captured in a CUDA graph
    sends nothing)."""
    if matrices.device.type != "cpu":
        raise ValueError("the MPEG matrices are a host tensor")
    table = np.ascontiguousarray(matrices.numpy().reshape(-1), np.uint16)
    key = table.tobytes()
    with _lock:
        if _matrices_sent.get(dev.index) == key:
            return
        with torch.cuda.device(dev):
            status = lib.mpeg4_set_matrices(table.ctypes.data, len(table),
                                            _stream(dev))
        if status:
            raise RuntimeError(f"mpeg4_set_matrices failed: cudaError "
                               f"{status - 1000}")
        _matrices_sent[dev.index] = key


def _load_for(dev: torch.device) -> ctypes.CDLL:
    """The library, with V4's reciprocals in the constant memory of
    `dev` (sent once a device, before the first launch there)."""
    lib = load()
    with _lock:
        if dev.index not in _recip_sent:
            with torch.cuda.device(dev):
                status = lib.mpeg4_set_recip(RECIP.ctypes.data, len(RECIP),
                                             _stream(dev))
            if status:
                raise RuntimeError(f"mpeg4_set_recip failed: cudaError "
                                   f"{status - 1000}")
            _recip_sent.add(dev.index)
    return lib


def _cuda_check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} on {t.device}: the kernel takes CUDA "
                         f"tensors")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _count(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError "
                           f"{status - 1000}")
    with _lock:
        launches[name] += 1


def _aligned(t: torch.Tensor, what: str, n: int) -> None:
    if t.data_ptr() % n:
        raise ValueError(f"{what} is not {n}-byte aligned: the kernel "
                         f"loads it in {n}-byte vectors")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def dequant_idct(blocks: torch.Tensor, bidx: torch.Tensor, mb: torch.Tensor,
                 out: torch.Tensor, matrices: Optional[torch.Tensor] = None,
                 xvid: bool = False) -> torch.Tensor:
    """V1 into `out` (F, M, 6, 64) int16 (rows not named by bidx keep
    their values), H.263 or, with `matrices` ((2, 64), on the host), MPEG
    inverse quantisation, the simple or (`xvid`) the Xvid IDCT: the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if blocks.device.type == "cpu":
        return dequant_idct_plain(blocks, bidx, mb, out, matrices, xvid)
    for t, n in ((blocks, "blocks"), (bidx, "bidx"), (mb, "mb"),
                 (out, "out")):
        _cuda_check(t, n)
    if blocks.shape[0] == 0:
        return out
    blocks, mb = blocks.contiguous(), mb.contiguous()
    for t, n, size in ((blocks, "blocks", 16), (out, "out", 16),
                       (mb, "mb", 8)):
        _aligned(t, n, size)
    lib = load()
    if matrices is not None:
        _send_matrices(lib, blocks.device, matrices)
    with torch.cuda.device(blocks.device):
        status = lib.mpeg4_dequant_idct(
            blocks.data_ptr(), bidx.contiguous().data_ptr(),
            blocks.shape[0], mb.data_ptr(), out.data_ptr(), mb.shape[-1],
            int(matrices is not None), int(xvid), _stream(blocks.device))
    _count("dequant_idct", status)
    return out


def motion_compensate(planes: Sequence[torch.Tensor], mb: torch.Tensor,
                      res: Optional[torch.Tensor], items: torch.Tensor,
                      width: int, height: int, qpel: bool = False,
                      qpel_chroma: int = 0) -> None:
    """V2 (see motion_compensate_plain), in place on the planes' output
    slots: one launch for every item."""
    y_pl, u_pl, v_pl = planes
    if y_pl.device.type == "cpu":
        return motion_compensate_plain(planes, mb, res, items, width, height,
                                       qpel, qpel_chroma)
    for t, n in ((y_pl, "planes"), (mb, "mb"), (items, "items")):
        _cuda_check(t, n)
    if items.shape[0] == 0:
        return None
    for p in planes:
        _aligned(p, "planes", 8)
    if qpel:
        _aligned(y_pl, "the luma planes", 16)
    if res is not None:
        res = res.contiguous()
        _aligned(res, "res", 16)
    lib = load()
    h16, w16 = y_pl.shape[1:]
    with torch.cuda.device(y_pl.device):
        status = lib.mpeg4_motion_compensate(
            y_pl.data_ptr(), u_pl.data_ptr(), v_pl.data_ptr(), h16, w16,
            mb.contiguous().data_ptr(), mb.shape[1], _ptr(res),
            items.contiguous().data_ptr(), items.shape[0], width, height,
            int(qpel), qpel_chroma, _stream(y_pl.device))
    _count("motion_compensate", status)
    return None


def bidir_compensate(planes: Sequence[torch.Tensor], bmb: torch.Tensor,
                     res: Optional[torch.Tensor], items: torch.Tensor,
                     width: int, height: int, qpel: bool = False,
                     qpel_chroma: int = 0) -> None:
    """V5 (see bidir_compensate_plain), in place on the planes' output
    slots: one launch for every B-VOP item."""
    y_pl, u_pl, v_pl = planes
    if y_pl.device.type == "cpu":
        return bidir_compensate_plain(planes, bmb, res, items, width,
                                      height, qpel, qpel_chroma)
    for t, n in ((y_pl, "planes"), (bmb, "bmb"), (items, "items")):
        _cuda_check(t, n)
    if items.shape[0] == 0:
        return None
    for p in planes:
        _aligned(p, "planes", 8)
    if qpel:
        _aligned(y_pl, "the luma planes", 16)
    if res is not None:
        res = res.contiguous()
        _aligned(res, "res", 16)
    lib = load()
    h16, w16 = y_pl.shape[1:]
    with torch.cuda.device(y_pl.device):
        status = lib.mpeg4_bidir_compensate(
            y_pl.data_ptr(), u_pl.data_ptr(), v_pl.data_ptr(), h16, w16,
            bmb.contiguous().data_ptr(), bmb.shape[1], _ptr(res),
            items.contiguous().data_ptr(), items.shape[0], width, height,
            int(qpel), qpel_chroma, _stream(y_pl.device))
    _count("bidir_compensate", status)
    return None


def motion_search(src_y: torch.Tensor, items: torch.Tensor, width: int,
                  height: int) -> torch.Tensor:
    """V3 (see motion_search_plain): (G, M, 3) int32."""
    if src_y.device.type == "cpu":
        return motion_search_plain(src_y, items, width, height)
    _cuda_check(src_y, "src_y")
    _cuda_check(items, "items")
    n, h16, w16 = src_y.shape
    g = items.shape[0]
    out = torch.empty((g, (h16 // 16) * (w16 // 16), 3), dtype=torch.int32,
                      device=src_y.device)
    if g == 0:
        return out
    src_y = src_y.contiguous()
    _aligned(src_y, "src_y", 16)
    lib = load()
    with torch.cuda.device(src_y.device):
        status = lib.mpeg4_motion_search(
            src_y.data_ptr(), n, h16, w16,
            items.contiguous().data_ptr(), g, width, height,
            out.data_ptr(), _stream(src_y.device))
    _count("motion_search", status)
    return out


def fdct_quant(src: Sequence[torch.Tensor], pred: Sequence[torch.Tensor],
               mb: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """V4 (see fdct_quant_plain): (G, M, 6, 64) int16."""
    if src[0].device.type == "cpu":
        return fdct_quant_plain(src, pred, mb, items)
    for t, n in ((src[0], "src"), (pred[0], "pred"), (mb, "mb"),
                 (items, "items")):
        _cuda_check(t, n)
    g = items.shape[0]
    h16, w16 = src[0].shape[1:]
    out = torch.empty((g, mb.shape[1], 6, 64), dtype=torch.int16,
                      device=mb.device)
    if g == 0:
        return out
    for planes, what in ((src, "src"), (pred, "pred")):
        for p in planes:
            _aligned(p, what, 8)
    lib = _load_for(mb.device)
    with torch.cuda.device(mb.device):
        status = lib.mpeg4_fdct_quant(
            *(p.data_ptr() for p in src), src[0].shape[0],
            *(p.data_ptr() for p in pred), pred[0].shape[0], h16, w16,
            mb.contiguous().data_ptr(), items.contiguous().data_ptr(), g,
            out.data_ptr(), _stream(mb.device))
    _count("fdct_quant", status)
    return out


# --- the host entropy coder -------------------------------------------------------

def threads() -> int:
    """Host threads of the entropy coder: the machine's cores, at most 8."""
    return max(1, min(8, os.cpu_count() or 1))


def _send_tables(lib: ctypes.CDLL) -> None:
    from faceoff_tpu_torch.io import mpeg4 as M
    plain = [M.MCBPC_I, M.MCBPC_P, M.CBPY, M.DC_LUMA, M.DC_CHROMA, M.MVD]
    tables: List[Tuple[Sequence, List[int]]] = [
        (codes, list(range(len(codes)))) for codes in plain]
    for t in (M.INTER_TCOEF, M.INTRA_TCOEF):
        syms = [(last << 16) | (run << 8) | level
                for last, run, level in t.symbols]
        tables.append((list(t.codes) + [M.ESCAPE], syms + [-1]))
    tables.append((M.MB_TYPE_B, list(range(len(M.MB_TYPE_B)))))
    for i, (codes, syms) in enumerate(tables):
        c = np.asarray([code for code, _ in codes], np.int32)
        n = np.asarray([length for _, length in codes], np.int32)
        s = np.asarray(syms, np.int32)
        status = lib.mpeg4_set_vlc(i, len(c), c.ctypes.data, n.ctypes.data,
                                   s.ctypes.data)
        if status:
            raise RuntimeError(f"mpeg4_set_vlc({i}) failed: {status}")


def _host_error(lib, handle, what: str) -> ValueError:
    msg = lib.mpeg4_error(handle).decode()
    lib.mpeg4_free(handle)
    return ValueError(f"{what}: {msg}")


def _align(n: int) -> int:
    """A part's bytes rounded up to 16, so that the next starts where V1
    can load a block row as one 16-byte vector."""
    return (n + 15) & ~15


def parse_batch(samples: Sequence[bytes], vol_fields: Sequence[int],
                n_mb: int, dev: torch.device,
                plan: Optional[np.ndarray] = None, direct_16: bool = False):
    """The C++ parser over a batch of VOPs on host threads (the anchors,
    then the B-VOPs), its records packed into one pinned buffer and copied
    to `dev` in one transfer: io/mpeg4.parse_batch's seven (vop numpy
    (F, 6), mb (F, M, 12), blocks (NB, 64), bidx (NB,), bmb (FB, M, 20),
    bblocks, bbidx). `plan` (F, 3) int32 rows (kind, TRB, TRD) as
    io/mpeg4.plan_stream gives them; without it every VOP is parsed as an
    anchor (a B-VOP then raises)."""
    lib = load()
    n = len(samples)
    sizes = np.asarray([len(s) for s in samples], np.int64)
    offsets = np.zeros(n, np.int64)
    offsets[1:] = np.cumsum(sizes)[:-1]
    data = b"".join(samples) + b"\0" * 8
    vol = np.asarray(vol_fields, np.int32)
    if plan is None:
        plan = np.zeros((n, 3), np.int32)
    plan = np.ascontiguousarray(plan, np.int32)
    counts = (ctypes.c_int64 * 3)()
    handle = lib.mpeg4_parse(data, offsets.ctypes.data, sizes.ctypes.data, n,
                             vol.ctypes.data, plan.ctypes.data,
                             int(direct_16), threads(), counts)
    nb, nbb, fb = counts[0], counts[1], counts[2]
    if lib.mpeg4_error(handle):
        raise _host_error(lib, handle, "mp4v parse")
    parts = [n * 6 * 4, n * n_mb * MB_FIELDS * 4, nb * 4, nb * 64 * 2,
             fb * n_mb * B_FIELDS * 4, nbb * 4, nbb * 64 * 2]
    starts = np.concatenate([[0], np.cumsum([_align(p) for p in parts])])
    buf = torch.empty(int(starts[-1]), dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    base = buf.data_ptr()
    at = [base + int(x) for x in starts[:-1]]
    status = lib.mpeg4_parse_fetch(handle, at[0], at[1], at[3], at[2], at[4],
                                   at[6], at[5])
    lib.mpeg4_free(handle)
    if status:
        raise ValueError("mp4v parse: fetch failed")
    vop = buf[: parts[0]].view(torch.int32).numpy().reshape(n, 6).copy()
    dbuf = buf.to(dev, non_blocking=True)

    def part(i, dtype):
        return dbuf[int(starts[i]): int(starts[i]) + parts[i]].view(dtype)

    return (vop, part(1, torch.int32).view(n, n_mb, MB_FIELDS),
            part(3, torch.int16).view(nb, 64), part(2, torch.int32),
            part(4, torch.int32).view(fb, n_mb, B_FIELDS),
            part(6, torch.int16).view(nbb, 64), part(5, torch.int32))


def parse_vops(samples: Sequence[bytes], vol_fields: Sequence[int],
               n_mb: int, dev: torch.device):
    """The anchors' records of a batch (parse_batch's first four)."""
    return parse_batch(samples, vol_fields, n_mb, dev)[:4]


def write_vops(vop: np.ndarray, mb: torch.Tensor, levels: torch.Tensor,
               vol_fields: Sequence[int], n_mb: int) -> List[bytes]:
    """The C++ writer over a batch: records (from the card, copied to the
    host once) -> one sample a VOP."""
    lib = load()
    n = len(vop)
    vop = np.ascontiguousarray(vop, np.int32)
    mb_h = mb.to("cpu").contiguous()
    lv_h = levels.to("cpu").contiguous()
    vol = np.asarray(vol_fields, np.int32)
    total = ctypes.c_int64(0)
    handle = lib.mpeg4_write(vop.ctypes.data, mb_h.data_ptr(),
                             lv_h.data_ptr(), n, vol.ctypes.data, threads(),
                             ctypes.byref(total))
    if lib.mpeg4_error(handle):
        raise _host_error(lib, handle, "mp4v write")
    out = np.empty(total.value, np.uint8)
    sizes = np.empty(n, np.int64)
    status = lib.mpeg4_write_fetch(handle, out.ctypes.data, sizes.ctypes.data)
    lib.mpeg4_free(handle)
    if status:
        raise ValueError("mp4v write: fetch failed")
    ends = np.cumsum(sizes)
    raw = out.tobytes()
    return [raw[e - s: e] for s, e in zip(sizes.tolist(), ends.tolist())]
