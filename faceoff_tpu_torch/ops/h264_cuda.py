"""The device stages of the H.264 Constrained Baseline decoder
(`io/h264.py`) and its host macroblock parser (`csrc/h264.cu`), with the
plain torch version of each stage beside its kernel.

    H1 residual           dequantisation and the inverse 4x4 transform of
                          every coded block of a batch of pictures, with
                          the Intra16x16 luma DC Hadamard and the chroma DC
                          2x2 transform, into int16 residual planes
    H2 inter_predict      the inter macroblocks of one P picture: six-tap
                          quarter-pel luma and eighth-pel bilinear chroma
                          from each 4x4 block's vector and reference slot,
                          plus the residual, clipped
    H3 intra_reconstruct  the intra macroblocks of one picture (Intra4x4's
                          nine modes block by block, Intra16x16's four,
                          chroma's four, I_PCM copies) plus the residual,
                          clipped: a wavefront over macroblocks
    H4 deblock            the loop filter of one picture (8.7), a
                          wavefront over macroblocks

They replace the H.264 decode that the JAX package hands to cv2's FFmpeg
on the host; no TPU kernel and no PyTorch call computes them. All four
are integer arithmetic, so each kernel equals its plain version bit for
bit. H3 and H4 run macroblock (x, y) after (x - 1, y) and (x + 1, y - 1),
the order in which raster decoding gives each macroblock its neighbours.
The plain versions run that order by anti-diagonal waves x + 2y, and
inside a wave Intra4x4's blocks by sub-waves bx + 2by. The kernels run a
warp a macroblock row, `csrc/h264.cu`'s WAVE_ROWS rows a thread block
(rows claimed by ticket, so that no block waits on one that is not
running); a row hands its progress to the next through shared memory
inside a block and through an acquire/release counter in global memory
between blocks, past each run of macroblocks it has nothing to do for
in one store. What bounds them is their dependent chain: a macroblock's
steps in order (Intra4x4's 10 sub-waves, two blocks a step; H4's 8
edges) and a handoff where the chain crosses a row. So each step stays
in the warp: H3 builds its macroblock in shared memory (the row above,
the left column, the residual staged before the wait), H4 filters lines
held in registers, a row for the vertical edges and, after one transpose
through shared memory, a column for the horizontal ones; both store
whole rows of 16 and 8 bytes. The planes must be 16-byte aligned.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. `launches` counts the kernel launches of
each stage. The host parser (`parse_batch`) spreads the pictures of a
batch over threads in C++ and is called once a batch.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from faceoff_tpu_torch.ops import cuda_build
from faceoff_tpu_torch.ops.mpeg4_cuda import _cuda_check, _stream, threads

SOURCE = cuda_build.CSRC / "h264.cu"

# macroblock kinds
H_SKIP, H_INTER, H_I4, H_I16, H_PCM = 0, 1, 2, 3, 4
# fields of a macroblock record (int32)
MB_FIELDS = 16
(F_KIND, F_QP, F_QPC, F_I16, F_CMODE, F_SLICE, F_FILTER, F_ALPHA, F_BETA,
 F_CIP, F_MODES, F_MODES_HI, F_PCM) = range(13)
# per 4x4 luma block: mv x, mv y (quarter pels), reference slot, total_coeff
BLK_FIELDS = 4
# coded blocks a macroblock: 16 luma, the Intra16x16 DC, two chroma DC,
# 2 x 4 chroma AC
NBLK = 27

# the widest picture H3 and H4 take, in macroblocks (csrc/h264.cu's
# kMaxChunks words of 32 macroblocks a row)
MAX_MB_WIDTH = 2048

# kernel launches made through the wrappers in this process
launches: Dict[str, int] = {"residual": 0, "inter_predict": 0,
                            "intra_reconstruct": 0, "deblock": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

# 8.5.9: normAdjust4x4's three values for qP % 6 (positions with both
# indices even, both odd, else)
NORM_ADJUST = ((10, 16, 13), (11, 18, 14), (13, 20, 16), (14, 23, 18),
               (16, 25, 20), (18, 29, 23))
# Table 8-15: QPc for qPI 30..51 (equal below 30)
CHROMA_QP_TAIL = (29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
                  38, 38, 38, 39, 39, 39, 39)
CHROMA_QP = tuple(range(30)) + CHROMA_QP_TAIL
# Table 8-16: alpha', beta' by indexA / indexB; Table 8-17: tC0' by
# indexA and bS 1..3
ALPHA = (0,) * 16 + (4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
                     32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127,
                     144, 162, 182, 203, 226, 255, 255)
BETA = (0,) * 16 + (2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10,
                    10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                    17, 18, 18)
TC0 = ((0, 0, 0),) * 17 + ((0, 0, 1),) * 4 + ((0, 1, 1),) * 2 + (
    (1, 1, 1),) * 4 + ((1, 1, 2),) * 4 + ((1, 2, 3),) * 2 + (
    (2, 2, 3), (2, 2, 4), (2, 3, 4), (2, 3, 4), (3, 3, 5), (3, 4, 6),
    (3, 4, 6), (4, 5, 7), (4, 5, 8), (4, 6, 9), (5, 7, 10), (6, 8, 11),
    (6, 8, 13), (7, 10, 14), (8, 11, 16), (9, 12, 18), (10, 13, 20),
    (11, 15, 23), (13, 17, 25))


def level_scale() -> np.ndarray:
    """(6, 16) int32: normAdjust4x4 of qP % 6 at each raster position."""
    out = np.zeros((6, 16), np.int32)
    for m in range(6):
        for i in range(4):
            for j in range(4):
                k = 0 if i % 2 == 0 and j % 2 == 0 else (
                    1 if i % 2 and j % 2 else 2)
                out[m, 4 * i + j] = NORM_ADJUST[m][k]
    return out


LEVEL_SCALE = level_scale()


def _table(values, dev) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=dev)


_CACHE: Dict[Tuple[int, str], torch.Tensor] = {}


def _cached(values, dev) -> torch.Tensor:
    """_table(values) kept per device (the plain versions' lookups)."""
    key = (id(values), str(dev))
    if key not in _CACHE:
        _CACHE[key] = _table(values, dev)
    return _CACHE[key]


def chroma_qp(qp: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """QPc of each luma QP (Table 8-15) with chroma_qp_index_offset."""
    return _cached(CHROMA_QP, qp.device)[(qp + offset).clamp(0, 51).long()]


def _idct4(d: torch.Tensor) -> torch.Tensor:
    """8.5.12.2 on (..., 4, 4) int32: rows, then columns, (x + 32) >> 6."""
    def pass_(x):
        x0, x1, x2, x3 = x.unbind(-1)
        e, f = x0 + x2, x0 - x2
        g, h = (x1 >> 1) - x3, x1 + (x3 >> 1)
        return torch.stack([e + h, f + g, f - g, e - h], -1)
    rows = pass_(d)
    cols = pass_(rows.transpose(-1, -2)).transpose(-1, -2)
    return (cols + 32) >> 6


_HADAMARD = ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, -1, 1), (1, -1, 1, -1))


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for integer tensors (CUDA has no integer matmul)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def residual_plain(coef: torch.Tensor, bmap: torch.Tensor, mb: torch.Tensor,
                   mb_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """H1: the residual planes of a batch, res_y (F, 16 H, 16 W) and
    res_c (F, 2, 8 H, 8 W) int16 (H, W in macroblocks), from the levels
    `coef` (NB, 16) int16, `bmap` (F, M, 27) int32 and the macroblock
    records `mb` (F, M, MB_FIELDS). Levels are scaled by normAdjust4x4
    times 2^(qP / 6) (8.5.12.1 with flat scaling matrices, which is exact
    for every qP); the Intra16x16 DC by the Hadamard transform and
    (f * 16 v + 2^(5 - qP/6)) >> (6 - qP/6), or << (qP/6 - 6) from qP 36;
    the chroma DC by the 2x2 transform and ((f * 16 v) << qPc/6) >> 5.
    Arithmetic in int32 as the kernel's."""
    f_n, m, _ = bmap.shape
    dev = coef.device
    mb_h = m // mb_width
    dense = torch.zeros((f_n, m, NBLK, 16), dtype=torch.int32, device=dev)
    sel = bmap >= 0
    if sel.any():
        dense[sel] = coef[bmap[sel].long()].to(torch.int32)
    kind = mb[..., F_KIND]
    qp = mb[..., F_QP]
    qpc = chroma_qp(qp, mb[..., F_QPC])
    scale = torch.from_numpy(LEVEL_SCALE).to(dev)
    hada = _table(_HADAMARD, dev)

    def dequant(levels, q):  # levels (F, M, n, 16), q (F, M)
        s = scale[(q % 6).long()].unsqueeze(2)
        return (levels * s) << (q // 6).view(f_n, m, 1, 1)

    luma = dequant(dense[:, :, :16], qp)
    c = dense[:, :, 16].view(f_n, m, 4, 4)
    f = _imatmul(_imatmul(hada, c), hada)
    q6 = (qp // 6).view(f_n, m, 1, 1)
    v0 = 16 * scale[(qp % 6).long(), 0].view(f_n, m, 1, 1)
    dc = torch.where(q6 >= 6, (f * v0) << (q6 - 6).clamp(min=0),
                     (f * v0 + (1 << (5 - q6).clamp(min=0, max=5)))
                     >> (6 - q6).clamp(min=0))
    i16 = (kind == H_I16).view(f_n, m, 1)
    luma[:, :, :, 0] = torch.where(i16, dc.reshape(f_n, m, 16),
                                   luma[:, :, :, 0])
    chroma = dequant(dense[:, :, 19:27], qpc).view(f_n, m, 2, 4, 16)
    cdc = dense[:, :, 17:19, :4].view(f_n, m, 2, 2, 2)
    h2 = _table(((1, 1), (1, -1)), dev)
    fc = _imatmul(_imatmul(h2, cdc), h2).reshape(f_n, m, 2, 4)
    qc6 = (qpc // 6).view(f_n, m, 1, 1)
    vc = 16 * scale[(qpc % 6).long(), 0].view(f_n, m, 1, 1)
    chroma[..., 0] = ((fc * vc) << qc6) >> 5
    active = ((kind != H_SKIP) & (kind != H_PCM)).view(f_n, m, 1, 1, 1)
    ry = _idct4(luma.view(f_n, m, 16, 4, 4)) * active
    rc = _idct4(chroma.view(f_n, m, 2, 4, 4, 4)) * active.unsqueeze(-1)
    mb_w = mb_width
    res_y = ry.view(f_n, mb_h, mb_w, 4, 4, 4, 4).permute(
        0, 1, 3, 5, 2, 4, 6).reshape(f_n, 16 * mb_h, 16 * mb_w)
    res_c = rc.view(f_n, mb_h, mb_w, 2, 2, 2, 4, 4).permute(
        0, 3, 1, 4, 6, 2, 5, 7).reshape(f_n, 2, 8 * mb_h, 8 * mb_w)
    return res_y.to(torch.int16), res_c.to(torch.int16)


# --- H2: inter prediction --------------------------------------------------------

def _tap(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def _clip1(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255)


def luma_qpel(win: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
              ) -> torch.Tensor:
    """8.4.2.2.1: the prediction of each sample from its 6 x 6 window of
    full samples (rows and columns -2..3 around it, clamped) at quarter
    position (fx, fy), int32 (N,)."""
    w = win.to(torch.int32)
    G, Hs, Ms = w[:, 2, 2], w[:, 2, 3], w[:, 3, 2]
    b1 = _tap(*w[:, 2, :].unbind(-1))
    h1 = _tap(*w[:, :, 2].unbind(-1))
    m1 = _tap(*w[:, :, 3].unbind(-1))
    s1 = _tap(*w[:, 3, :].unbind(-1))
    rows = _tap(*w.unbind(-1))  # b1 of each row -2..3
    j1 = _tap(*rows.unbind(-1))
    b = _clip1((b1 + 16) >> 5)
    h = _clip1((h1 + 16) >> 5)
    m = _clip1((m1 + 16) >> 5)
    s = _clip1((s1 + 16) >> 5)
    j = _clip1((j1 + 512) >> 10)

    def avg(p, q):
        return (p + q + 1) >> 1

    table = torch.stack([
        G, avg(G, h), h, avg(Ms, h),            # fx 0: G d h n
        avg(G, b), avg(b, h), avg(h, j), avg(h, s),   # fx 1: a e i p
        b, avg(b, j), j, avg(j, s),            # fx 2: b f j q
        avg(Hs, b), avg(b, m), avg(j, m), avg(m, s)], -1)  # fx 3: c g k r
    return table.gather(-1, (fx * 4 + fy).long().unsqueeze(-1)).squeeze(-1)


def _gather(plane: torch.Tensor, slot: torch.Tensor, y: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """plane (S, h, w) at (slot, clamp(y), clamp(x)) as int32."""
    _, h, w = plane.shape
    y = y.clamp(0, h - 1)
    x = x.clamp(0, w - 1)
    flat = plane.reshape(-1)
    return flat[(slot * (h * w) + y * w + x).long()].to(torch.int32)


def inter_predict_plain(planes: Sequence[torch.Tensor], out: int,
                        mb: torch.Tensor, blk: torch.Tensor,
                        res_y: torch.Tensor, res_c: torch.Tensor,
                        mb_width: int) -> None:
    """H2 on one picture: `planes` Y (S, 16 H, 16 W), U, V (S, 8 H, 8 W)
    uint8; writes slot `out` at the samples of its inter macroblocks
    (records mb (M, MB_FIELDS), blk (M, 16, 4)): Clip1(prediction +
    residual), each 4x4 luma block and its 2x2 chroma blocks predicted
    with that block's vector from its reference slot, coordinates clamped
    to the coded picture."""
    y_pl, u_pl, v_pl = planes
    dev = y_pl.device
    kind = mb[:, F_KIND]
    mbs = torch.nonzero((kind == H_SKIP) | (kind == H_INTER)).squeeze(1)
    if mbs.numel() == 0:
        return
    mx = (mbs % mb_width).view(-1, 1)
    my = (mbs // mb_width).view(-1, 1)
    # luma: every sample of the inter macroblocks
    k = torch.arange(256, device=dev)
    xx, yy = k % 16, k // 16
    b = (yy // 4) * 4 + xx // 4
    rec = blk[mbs][:, b]  # (n, 256, 4)
    mvx, mvy, slot = rec[..., 0], rec[..., 1], rec[..., 2]
    X = 16 * mx + xx
    Y = 16 * my + yy
    xi, yi = X + (mvx >> 2), Y + (mvy >> 2)
    d = torch.arange(-2, 4, device=dev)
    win = _gather(y_pl, slot.reshape(-1, 1, 1),
                  (yi.reshape(-1, 1, 1) + d.view(1, 6, 1)),
                  (xi.reshape(-1, 1, 1) + d.view(1, 1, 6)))
    pred = luma_qpel(win, (mvx & 3).reshape(-1), (mvy & 3).reshape(-1))
    pred = pred + res_y[Y.reshape(-1), X.reshape(-1)].to(torch.int32)
    y_pl[out][Y.reshape(-1), X.reshape(-1)] = _clip1(pred).to(torch.uint8)
    # chroma: 8 x 8 a component, each sample with its luma block's vector
    k = torch.arange(64, device=dev)
    cx, cy = k % 8, k // 8
    b = (cy // 2) * 4 + cx // 2
    rec = blk[mbs][:, b]
    mvx, mvy, slot = rec[..., 0], rec[..., 1], rec[..., 2]
    X = 8 * mx + cx
    Y = 8 * my + cy
    xi, yi = X + (mvx >> 3), Y + (mvy >> 3)
    fx, fy = mvx & 7, mvy & 7
    for c, plane in enumerate((u_pl, v_pl)):
        a = _gather(plane, slot, yi, xi)
        bb = _gather(plane, slot, yi, xi + 1)
        cc = _gather(plane, slot, yi + 1, xi)
        dd = _gather(plane, slot, yi + 1, xi + 1)
        pred = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * bb
                + (8 - fx) * fy * cc + fx * fy * dd + 32) >> 6
        pred = pred + res_c[c][Y, X].to(torch.int32)
        plane[out][Y.reshape(-1), X.reshape(-1)] = _clip1(
            pred).reshape(-1).to(torch.uint8)


# --- H3: intra reconstruction ----------------------------------------------------

def _p_index(x: int, y: int) -> int:
    """Index of neighbour sample p[x, y] (x = -1..7 at y = -1, or x = -1 and
    y = -1..3) in a 4x4 block's edge E = (p[-1,3], p[-1,2], p[-1,1],
    p[-1,0], p[-1,-1], p[0,-1], ..., p[7,-1])."""
    return 5 + x if y == -1 else 3 - y


def intra4_taps() -> np.ndarray:
    """(9, 16, 8) int32: for each Intra4x4 mode and raster position, the
    sample as (w0 E[i0] + w1 E[i1] + w2 E[i2] + r) >> s, stored (i0, i1,
    i2, w0, w1, w2, r, s); mode 2 (DC) is all zero (8.3.1.2.1-9)."""
    P = _p_index
    out = np.zeros((9, 16, 8), np.int32)
    for mode in range(9):
        for y in range(4):
            for x in range(4):
                if mode == 0:
                    terms, r, s = [(1, P(x, -1))], 0, 0
                elif mode == 1:
                    terms, r, s = [(1, P(-1, y))], 0, 0
                elif mode == 2:
                    continue
                elif mode == 3:
                    if x == 3 and y == 3:
                        terms = [(1, P(6, -1)), (3, P(7, -1))]
                    else:
                        terms = [(1, P(x + y, -1)), (2, P(x + y + 1, -1)),
                                 (1, P(x + y + 2, -1))]
                    r, s = 2, 2
                elif mode == 4:
                    k = 4 + x - y
                    terms, r, s = [(1, k - 1), (2, k), (1, k + 1)], 2, 2
                elif mode == 5:
                    z, q = 2 * x - y, x - (y >> 1)
                    if z >= 0 and z % 2 == 0:
                        terms, r, s = [(1, P(q - 1, -1)), (1, P(q, -1))], 1, 1
                    elif z > 0:
                        terms, r, s = [(1, P(q - 2, -1)), (2, P(q - 1, -1)),
                                       (1, P(q, -1))], 2, 2
                    elif z == -1:
                        terms, r, s = [(1, P(-1, 0)), (2, P(-1, -1)),
                                       (1, P(0, -1))], 2, 2
                    else:
                        terms, r, s = [(1, P(-1, y - 1)), (2, P(-1, y - 2)),
                                       (1, P(-1, y - 3))], 2, 2
                elif mode == 6:
                    z, q = 2 * y - x, y - (x >> 1)
                    if z >= 0 and z % 2 == 0:
                        terms, r, s = [(1, P(-1, q - 1)), (1, P(-1, q))], 1, 1
                    elif z > 0:
                        terms, r, s = [(1, P(-1, q - 2)), (2, P(-1, q - 1)),
                                       (1, P(-1, q))], 2, 2
                    elif z == -1:
                        terms, r, s = [(1, P(-1, 0)), (2, P(-1, -1)),
                                       (1, P(0, -1))], 2, 2
                    else:
                        terms, r, s = [(1, P(x - 1, -1)), (2, P(x - 2, -1)),
                                       (1, P(x - 3, -1))], 2, 2
                elif mode == 7:
                    q = x + (y >> 1)
                    if y % 2 == 0:
                        terms, r, s = [(1, P(q, -1)), (1, P(q + 1, -1))], 1, 1
                    else:
                        terms, r, s = [(1, P(q, -1)), (2, P(q + 1, -1)),
                                       (1, P(q + 2, -1))], 2, 2
                else:
                    z, q = x + 2 * y, y + (x >> 1)
                    if z in (0, 2, 4):
                        terms, r, s = [(1, P(-1, q)), (1, P(-1, q + 1))], 1, 1
                    elif z in (1, 3):
                        terms, r, s = [(1, P(-1, q)), (2, P(-1, q + 1)),
                                       (1, P(-1, q + 2))], 2, 2
                    elif z == 5:
                        terms, r, s = [(1, P(-1, 2)), (3, P(-1, 3))], 2, 2
                    else:
                        terms, r, s = [(1, P(-1, 3))], 0, 0
                terms = terms + [(0, 0)] * (3 - len(terms))
                out[mode, 4 * y + x] = [t[1] for t in terms] + [
                    t[0] for t in terms] + [r, s]
    return out


INTRA4_TAPS = intra4_taps()
# the 4x4 blocks (raster) whose top-right neighbours inside the
# macroblock are decoded after them (6.4.11.4): (1,1), (3,1), (1,3),
# (3,2), (3,3); (3,0)'s lie in the macroblock above and to the right
_TR_INSIDE = tuple(int(by > 0 and bx != 3 and (bx, by) not in ((1, 1),
                                                                 (1, 3)))
                   for by in range(4) for bx in range(4))


def _available(mb: torch.Tensor, mbs: torch.Tensor, mb_width: int,
               mb_height: int):
    """(A, B, C, D) availability for intra prediction of macroblocks
    `mbs` (long): left, top, top-right, top-left in the picture and the
    same slice, and not inter where constrained_intra_pred_flag is set."""
    x, y = mbs % mb_width, mbs // mb_width
    sl = mb[mbs, F_SLICE]
    cip = mb[mbs, F_CIP] != 0
    out = []
    for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, -1)):
        nx, ny = x + dx, y + dy
        inside = (nx >= 0) & (nx < mb_width) & (ny >= 0)
        n = (ny.clamp(min=0) * mb_width + nx.clamp(0, mb_width - 1))
        k = mb[n, F_KIND]
        ok = inside & (mb[n, F_SLICE] == sl) & ~(
            cip & ((k == H_SKIP) | (k == H_INTER)))
        out.append(ok)
    return out


def _dc(top_sum, left_sum, top_av, left_av, n_log2):
    """DC prediction from sums of 2^n_log2 samples each side."""
    both = (top_sum + left_sum + (1 << n_log2)) >> (n_log2 + 1)
    one_l = (left_sum + (1 << (n_log2 - 1))) >> n_log2
    one_t = (top_sum + (1 << (n_log2 - 1))) >> n_log2
    return torch.where(top_av & left_av, both, torch.where(
        left_av, one_l, torch.where(top_av, one_t,
                                    torch.full_like(both, 128))))


def _plane_pred(top, left, tl, n, scale):
    """Intra16x16 (n 16, scale 5) or chroma (n 8, scale 34) plane
    prediction (N, n, n) from top (N, n), left (N, n), tl (N,)."""
    half = n // 2
    ext_t = torch.cat([tl.unsqueeze(1), top], 1)  # p[-1..n-1, -1]
    ext_l = torch.cat([tl.unsqueeze(1), left], 1)
    k = torch.arange(half, device=top.device)
    hh = ((k + 1) * (ext_t[:, half + 1 + k] - ext_t[:, half - 1 - k])).sum(1)
    vv = ((k + 1) * (ext_l[:, half + 1 + k] - ext_l[:, half - 1 - k])).sum(1)
    a = 16 * (left[:, n - 1] + top[:, n - 1])
    b = (scale * hh + 32) >> 6
    c = (scale * vv + 32) >> 6
    i = torch.arange(n, device=top.device)
    p = (a.view(-1, 1, 1) + b.view(-1, 1, 1) * (i.view(1, 1, n) - (half - 1))
         + c.view(-1, 1, 1) * (i.view(1, n, 1) - (half - 1)) + 16) >> 5
    return p.clamp(0, 255)


def _rows(plane, y0, x0, n, h, w):
    """plane (h, w) samples of rows y0 (N,) .. y0 + n - 1 at column x0
    (N,): (N, n) int32 (coordinates clamped; masked by the caller)."""
    i = torch.arange(n, device=plane.device)
    yy = (y0.view(-1, 1) + i).clamp(0, h - 1)
    xx = x0.view(-1, 1).clamp(0, w - 1).expand_as(yy)
    return plane[yy, xx].to(torch.int32)


def _cols(plane, y0, x0, n, h, w):
    i = torch.arange(n, device=plane.device)
    xx = (x0.view(-1, 1) + i).clamp(0, w - 1)
    yy = y0.view(-1, 1).clamp(0, h - 1).expand_as(xx)
    return plane[yy, xx].to(torch.int32)


def _write(plane, y0, x0, pred, res, n):
    """plane[y0 + i, x0 + j] = Clip1(pred + res[same]) for (N, n, n)."""
    i = torch.arange(n, device=plane.device)
    yy = (y0.view(-1, 1, 1) + i.view(1, n, 1)).expand(-1, n, n)
    xx = (x0.view(-1, 1, 1) + i.view(1, 1, n)).expand(-1, n, n)
    val = pred + res[yy, xx].to(torch.int32)
    plane[yy, xx] = val.clamp(0, 255).to(torch.uint8)


def intra_reconstruct_plain(planes: Sequence[torch.Tensor], out: int,
                            mb: torch.Tensor, pcm: torch.Tensor,
                            res_y: torch.Tensor, res_c: torch.Tensor,
                            mb_width: int) -> None:
    """H3 on one picture: the intra macroblocks of slot `out` of `planes`
    (8.3): I_PCM copies first, then by waves x + 2y: Intra16x16, Intra4x4
    by sub-waves bx + 2by, and chroma, each prediction plus its residual,
    clipped. Reads the unfiltered samples H2 and earlier waves wrote."""
    y_pl, u_pl, v_pl = (p[out] for p in planes)
    dev = y_pl.device
    m = mb.shape[0]
    mb_height = m // mb_width
    hl, wl = 16 * mb_height, 16 * mb_width
    kind = mb[:, F_KIND]
    idx = torch.arange(m, device=dev)
    x_all, y_all = idx % mb_width, idx // mb_width
    pcms = torch.nonzero(kind == H_PCM).squeeze(1)
    if pcms.numel():
        rows = pcm[mb[pcms, F_PCM].long()]
        k = torch.arange(16, device=dev)
        yy = (16 * y_all[pcms]).view(-1, 1, 1) + k.view(1, 16, 1)
        xx = (16 * x_all[pcms]).view(-1, 1, 1) + k.view(1, 1, 16)
        y_pl[yy, xx] = rows[:, :256].view(-1, 16, 16)
        k = torch.arange(8, device=dev)
        yy = (8 * y_all[pcms]).view(-1, 1, 1) + k.view(1, 8, 1)
        xx = (8 * x_all[pcms]).view(-1, 1, 1) + k.view(1, 1, 8)
        u_pl[yy, xx] = rows[:, 256:320].view(-1, 8, 8)
        v_pl[yy, xx] = rows[:, 320:].view(-1, 8, 8)
    intra = (kind == H_I4) | (kind == H_I16)
    if not bool(intra.any()):
        return
    wave = x_all + 2 * y_all
    taps = torch.from_numpy(INTRA4_TAPS).to(dev)
    tr_inside = torch.tensor(_TR_INSIDE, dtype=torch.bool, device=dev)
    for w in torch.unique(wave[intra]).tolist():
        mbs = torch.nonzero(intra & (wave == w)).squeeze(1)
        av_a, av_b, av_c, av_d = _available(mb, mbs, mb_width, mb_height)
        x0, y0 = 16 * x_all[mbs], 16 * y_all[mbs]
        # Intra16x16
        i16 = kind[mbs] == H_I16
        if bool(i16.any()):
            s = torch.nonzero(i16).squeeze(1)
            top = _cols(y_pl, y0[s] - 1, x0[s], 16, hl, wl)
            left = _rows(y_pl, y0[s], x0[s] - 1, 16, hl, wl)
            tl = y_pl[(y0[s] - 1).clamp(min=0), (x0[s] - 1).clamp(min=0)
                      ].to(torch.int32)
            mode = mb[mbs[s], F_I16].view(-1, 1, 1)
            dc = _dc(top.sum(1), left.sum(1), av_b[s], av_a[s], 4)
            pred = torch.where(mode == 0, top.view(-1, 1, 16).expand(
                -1, 16, 16), torch.where(mode == 1, left.view(-1, 16, 1)
                                         .expand(-1, 16, 16),
                                         torch.where(mode == 2, dc.view(
                                             -1, 1, 1).expand(-1, 16, 16),
                                             _plane_pred(top, left, tl, 16,
                                                         5))))
            _write(y_pl, y0[s], x0[s], pred, res_y, 16)
        # Intra4x4 by sub-waves
        i4 = kind[mbs] == H_I4
        if bool(i4.any()):
            s = torch.nonzero(i4).squeeze(1)
            modes = torch.stack([mb[mbs[s], F_MODES], mb[mbs[s], F_MODES_HI]],
                                1)
            for sw in range(10):
                blocks = [(bx, by) for by in range(4) for bx in range(4)
                          if bx + 2 * by == sw]
                for bx, by in blocks:
                    b = 4 * by + bx
                    bx0 = x0[s] + 4 * bx
                    by0 = y0[s] + 4 * by
                    left_av = torch.ones_like(av_a[s]) if bx else av_a[s]
                    top_av = torch.ones_like(av_b[s]) if by else av_b[s]
                    if by == 0:
                        tr_av = av_c[s] if bx == 3 else av_b[s]
                    else:
                        tr_av = torch.full_like(av_a[s], bool(tr_inside[b]))
                    top = _cols(y_pl, by0 - 1, bx0, 8, hl, wl)
                    left = _rows(y_pl, by0, bx0 - 1, 4, hl, wl)
                    tl = y_pl[(by0 - 1).clamp(min=0), (bx0 - 1).clamp(min=0)
                              ].to(torch.int32)
                    top[:, 4:] = torch.where(tr_av.view(-1, 1), top[:, 4:],
                                             top[:, 3:4])
                    edge = torch.cat([left.flip(1), tl.view(-1, 1), top], 1)
                    mode = ((modes[:, b // 8] >> (4 * (b % 8))) & 15).long()
                    t = taps[mode]  # (N, 16, 8)
                    e = edge.unsqueeze(1).expand(-1, 16, -1)
                    acc = sum(e.gather(2, t[..., i:i + 1].long()).squeeze(2)
                              * t[..., 3 + i] for i in range(3))
                    pred = (acc + t[..., 6]) >> t[..., 7]
                    dc = _dc(top[:, :4].sum(1), left.sum(1), top_av,
                             left_av, 2)
                    pred = torch.where((mode == 2).view(-1, 1),
                                       dc.view(-1, 1).expand(-1, 16), pred)
                    _write(y_pl, by0, bx0, pred.view(-1, 4, 4), res_y, 4)
        # chroma of every intra macroblock of the wave
        cx0, cy0 = x0 // 2, y0 // 2
        cmode = mb[mbs, F_CMODE].view(-1, 1, 1)
        for c, plane in enumerate((u_pl, v_pl)):
            top = _cols(plane, cy0 - 1, cx0, 8, hl // 2, wl // 2)
            left = _rows(plane, cy0, cx0 - 1, 8, hl // 2, wl // 2)
            tl = plane[(cy0 - 1).clamp(min=0), (cx0 - 1).clamp(min=0)
                       ].to(torch.int32)
            dc = torch.zeros((mbs.numel(), 8, 8), dtype=torch.int32,
                             device=dev)
            for cby in range(2):
                for cbx in range(2):
                    st = top[:, 4 * cbx: 4 * cbx + 4].sum(1)
                    sl_ = left[:, 4 * cby: 4 * cby + 4].sum(1)
                    if cbx == cby:
                        v = _dc(st, sl_, av_b, av_a, 2)
                    elif cby == 0:  # xO > 0, yO == 0: top first
                        v = torch.where(av_b, (st + 2) >> 2, torch.where(
                            av_a, (sl_ + 2) >> 2, torch.full_like(st, 128)))
                    else:  # xO == 0, yO > 0: left first
                        v = torch.where(av_a, (sl_ + 2) >> 2, torch.where(
                            av_b, (st + 2) >> 2, torch.full_like(st, 128)))
                    dc[:, 4 * cby: 4 * cby + 4, 4 * cbx: 4 * cbx + 4] = \
                        v.view(-1, 1, 1)
            pred = torch.where(cmode == 0, dc, torch.where(
                cmode == 1, left.view(-1, 8, 1).expand(-1, 8, 8), torch.where(
                    cmode == 2, top.view(-1, 1, 8).expand(-1, 8, 8),
                    _plane_pred(top, left, tl, 8, 34))))
            _write(plane, cy0, cx0, pred, res_c[c], 8)


# --- H4: the loop filter -----------------------------------------------------------

def boundary_strength(kp, kq, bp, bq, mb_edge) -> torch.Tensor:
    """bS (8.7.2.1) of edges between 4x4 luma blocks: kinds kp, kq and
    block records bp, bq (..., 4) of the p and q sides, mb_edge whether
    the edge is a macroblock's. References are compared as pictures
    (slots), vectors in quarter pels."""
    intra = (kp >= H_I4) | (kq >= H_I4)
    coef = (bp[..., 3] != 0) | (bq[..., 3] != 0)
    differ = ((bp[..., 2] != bq[..., 2])
              | ((bp[..., 0] - bq[..., 0]).abs() >= 4)
              | ((bp[..., 1] - bq[..., 1]).abs() >= 4))
    return torch.where(intra, 3 + mb_edge.int(), torch.where(
        coef, 2, differ.int())).to(torch.int32)


def filter_lines(v: torch.Tensor, bs: torch.Tensor, qpav: torch.Tensor,
                 off_a: torch.Tensor, off_b: torch.Tensor,
                 chroma) -> torch.Tensor:
    """8.7.2.3-4 on lines v (N, 8) int32 (p3 p2 p1 p0 q0 q1 q2 q3): the
    filtered lines. `chroma` is a bool or an (N,) bool tensor: chroma
    lines take tC0 + 1, change only p0 and q0, and at bS 4 the weak
    form."""
    dev = v.device
    chroma = torch.as_tensor(chroma, device=dev)
    p3, p2, p1, p0, q0, q1, q2, q3 = v.unbind(1)
    ia = (qpav + off_a).clamp(0, 51).long()
    ib = (qpav + off_b).clamp(0, 51).long()
    alpha = _cached(ALPHA, dev)[ia]
    beta = _cached(BETA, dev)[ib]
    tc0 = _cached(TC0, dev)[ia, (bs - 1).clamp(0, 2).long()]
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta))
    ap = ((p2 - p0).abs() < beta) & ~chroma
    aq = ((q2 - q0).abs() < beta) & ~chroma
    tc = torch.where(chroma, tc0 + 1, tc0 + ap.int() + aq.int())
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    mid = (p0 + q0 + 1) >> 1
    weak = [p2, torch.where(ap, p1 + torch.clamp(
        (p2 + mid - (p1 << 1)) >> 1, -tc0, tc0), p1), _clip1(p0 + delta),
        _clip1(q0 - delta), torch.where(aq, q1 + torch.clamp(
            (q2 + mid - (q1 << 1)) >> 1, -tc0, tc0), q1), q2]
    small = (p0 - q0).abs() < ((alpha >> 2) + 2)
    cp, cq = ap & small, aq & small
    strong = [
        torch.where(cp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2),
        torch.where(cp, (p2 + p1 + p0 + q0 + 2) >> 2, p1),
        torch.where(cp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                    (2 * p1 + p0 + q1 + 2) >> 2),
        torch.where(cq, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                    (2 * q1 + q0 + p1 + 2) >> 2),
        torch.where(cq, (p0 + q0 + q1 + q2 + 2) >> 2, q1),
        torch.where(cq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)]
    four = (bs == 4).unsqueeze(1)
    mid6 = torch.where(four, torch.stack(strong, 1), torch.stack(weak, 1))
    new = torch.cat([p3.unsqueeze(1), mid6, q3.unsqueeze(1)], 1)
    return torch.where(filt.unsqueeze(1), new, v)


def deblock_lines(mb: torch.Tensor, blk: torch.Tensor, mb_width: int):
    """Every line the loop filter of a picture may change, in its order:
    (step, the flat indices of its 8 samples in the concatenated Y, U, V
    planes, bS, qPav, FilterOffsetA, FilterOffsetB, chroma), lines with
    bS 0 or in slices that do not filter left out. A step is one edge
    (vertical 0-3 then horizontal 0-3) of the macroblocks of one wave
    x + 2y; steps run in order, the lines of a step at once."""
    dev = mb.device
    m = mb.shape[0]
    mb_h = m // mb_width
    hl, wl = 16 * mb_h, 16 * mb_width
    hc, wc = hl // 2, wl // 2
    kind = mb[:, F_KIND]
    q = torch.arange(m, device=dev)
    mx, my = q % mb_width, q // mb_width
    qp = torch.where(kind == H_PCM, torch.zeros_like(mb[:, F_QP]),
                     mb[:, F_QP])
    qpc = chroma_qp(qp, mb[:, F_QPC])
    on = mb[:, F_FILTER] == 0
    wave = mx + 2 * my
    e = torch.arange(4, device=dev).view(1, 4, 1)
    r = torch.arange(16, device=dev).view(1, 1, 16)
    k8 = torch.arange(-4, 4, device=dev)
    parts = []
    for vertical in (True, False):
        edge_ok = (e > 0) | ((mx if vertical else my).view(m, 1, 1) > 0)
        pm = torch.where(e > 0, q.view(m, 1, 1), q.view(m, 1, 1) - (
            1 if vertical else mb_width)).expand(m, 4, 16).clamp(min=0)
        if vertical:
            qb = (r // 4) * 4 + e
            pb = (r // 4) * 4 + (e - 1) % 4
        else:
            qb = e * 4 + r // 4
            pb = ((e - 1) % 4) * 4 + r // 4
        qb, pb = qb.expand(m, 4, 16), pb.expand(m, 4, 16)
        qm = q.view(m, 1, 1).expand(m, 4, 16)
        bs = boundary_strength(kind[pm], kind[qm], blk[pm, pb], blk[qm, qb],
                               (e == 0).expand(m, 4, 16))
        bs = torch.where(edge_ok & on.view(m, 1, 1), bs,
                         torch.zeros_like(bs))
        step = (wave.view(m, 1, 1) * 8 + (0 if vertical else 4) + e
                ).expand(m, 4, 16)
        off_a = mb[qm, F_ALPHA]
        off_b = mb[qm, F_BETA]
        # luma lines
        if vertical:
            ys = 16 * my.view(m, 1, 1) + r
            xs = 16 * mx.view(m, 1, 1) + 4 * e
            idx = (ys * wl + xs).unsqueeze(-1) + k8
        else:
            ys = 16 * my.view(m, 1, 1) + 4 * e
            xs = 16 * mx.view(m, 1, 1) + r
            idx = (ys * wl + xs).unsqueeze(-1) + k8 * wl
        qpav = (qp[pm] + qp[qm] + 1) >> 1
        parts.append((step, idx.expand(m, 4, 16, 8), bs, qpav, off_a, off_b,
                      torch.zeros_like(bs, dtype=torch.bool)))
        # chroma edges 0 and 4: the luma bS of edges 0 and 2, chroma line
        # c that of luma line 2c
        ce = torch.tensor([0, 2], device=dev)
        c8 = torch.arange(8, device=dev).view(1, 1, 8)
        sub = (slice(None), ce, slice(0, 16, 2))
        cbs, cstep = bs[sub], step[sub]
        cpm, cqm = pm[sub], qm[sub]
        cqpav = (qpc[cpm] + qpc[cqm] + 1) >> 1
        ec = (2 * ce).view(1, 2, 1)
        if vertical:
            cidx = ((8 * my.view(m, 1, 1) + c8) * wc
                    + 8 * mx.view(m, 1, 1) + ec).unsqueeze(-1) + k8
        else:
            cidx = ((8 * my.view(m, 1, 1) + ec) * wc
                    + 8 * mx.view(m, 1, 1) + c8).unsqueeze(-1) + k8 * wc
        for base in (hl * wl, hl * wl + hc * wc):
            parts.append((cstep, cidx + base, cbs, cqpav, off_a[sub],
                          off_b[sub], torch.ones_like(cbs, dtype=torch.bool)))
    cols = [torch.cat([p[i].reshape(-1, 8) if i == 1 else p[i].reshape(-1)
                       for p in parts]) for i in range(7)]
    keep = cols[2] > 0
    cols = [c[keep] for c in cols]
    order = torch.sort(cols[0], stable=True).indices
    return [c[order] for c in cols]


def deblock_plain(planes: Sequence[torch.Tensor], out: int, mb: torch.Tensor,
                  blk: torch.Tensor, mb_width: int) -> None:
    """H4 on slot `out` of `planes` in place (8.7): each macroblock's luma
    vertical edges left to right, then its horizontal edges top to bottom
    (the left and top macroblock edges where a neighbour lies there),
    chroma's edges 0 and 4 likewise, macroblock by macroblock in an order
    equal to raster order's (waves x + 2y, deblock_lines). QP is 0 on
    I_PCM sides, chroma's through each side's QPc; the offsets are the q
    macroblock's slice's."""
    y_pl, u_pl, v_pl = (p[out] for p in planes)
    step, idx, bs, qpav, off_a, off_b, chroma = deblock_lines(mb, blk,
                                                              mb_width)
    if step.numel() == 0:
        return
    flat = torch.cat([y_pl.reshape(-1), u_pl.reshape(-1), v_pl.reshape(-1)]
                     ).to(torch.int32)
    bounds = torch.unique_consecutive(step, return_counts=True)[1].tolist()
    lo = 0
    for n in bounds:
        sl = slice(lo, lo + n)
        lines = flat[idx[sl]]
        flat[idx[sl]] = filter_lines(lines, bs[sl], qpav[sl], off_a[sl],
                                     off_b[sl], chroma[sl])
        lo += n
    ny, nc = y_pl.numel(), u_pl.numel()
    y_pl.copy_(flat[:ny].view_as(y_pl))
    u_pl.copy_(flat[ny: ny + nc].view_as(u_pl))
    v_pl.copy_(flat[ny + nc:].view_as(v_pl))


# --- the library -------------------------------------------------------------------

def library_path() -> Path:
    return cuda_build.library_path(SOURCE, "faceoff_h264")


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    return cuda_build.build(SOURCE, "faceoff_h264")


_P, _I = ctypes.c_void_p, ctypes.c_int


def host_signatures(lib: ctypes.CDLL) -> None:
    """The argument types of the host parser's functions, and its CAVLC
    tables (io/h264.py's) handed over."""
    for name, args, res in (
            ("h264_set_vlc", [_I, _I, _P, _P], _I),
            ("h264_set_cbp", [_P, _P], _I),
            ("h264_parse", [_P, _P, _P, _I, _I, _I, _I,
                            ctypes.POINTER(ctypes.c_int64)], _P),
            ("h264_parse_fetch", [_P, _P, _P, _P, _P, _P], _I),
            ("h264_error", [_P], ctypes.c_char_p),
            ("h264_free", [_P], None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    from faceoff_tpu_torch.io import h264 as M
    tables = [(M.COEFF_TOKEN_LEN[i], M.COEFF_TOKEN_BITS[i]) for i in range(4)]
    tables.append((M.CHROMA_DC_TOKEN_LEN, M.CHROMA_DC_TOKEN_BITS))
    tables += list(zip(M.TOTAL_ZEROS_LEN, M.TOTAL_ZEROS_BITS))
    tables += list(zip(M.CHROMA_DC_ZEROS_LEN, M.CHROMA_DC_ZEROS_BITS))
    tables += list(zip(M.RUN_LEN, M.RUN_BITS))
    for i, (lens, bits) in enumerate(tables):
        n = np.asarray(lens, np.int32)
        b = np.asarray(bits, np.int32)
        if lib.h264_set_vlc(i, len(n), n.ctypes.data, b.ctypes.data):
            raise RuntimeError(f"h264_set_vlc({i}) failed")
    intra = np.asarray(M.CBP_INTRA, np.int32)
    inter = np.asarray(M.CBP_INTER, np.int32)
    lib.h264_set_cbp(intra.ctypes.data, inter.ctypes.data)


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        host_signatures(lib)
        for name, args in (
                ("h264_set_constants", [_P] * 6),
                ("h264_residual", [_P, _P, _P, _I, _I, _I, _P, _P, _P]),
                ("h264_inter_predict", [_P, _P, _P, _I, _I, _I, _P, _P, _I,
                                        _P, _P, _P]),
                ("h264_intra_reconstruct", [_P, _P, _P, _I, _I, _I, _P, _P,
                                            _I, _P, _P, _P, _P]),
                ("h264_deblock", [_P, _P, _P, _I, _I, _I, _P, _P, _I, _P,
                                  _P])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _I
        _lib = lib
        return lib


_sent: set = set()


def _load_for(dev: torch.device) -> ctypes.CDLL:
    """The library, with the constant tables in the memory of `dev` (sent
    once a device, before the first launch there)."""
    lib = load()
    with _lock:
        if dev.index not in _sent:
            arrays = [np.ascontiguousarray(a, np.int32).reshape(-1) for a in (
                INTRA4_TAPS, ALPHA, BETA, TC0, LEVEL_SCALE, CHROMA_QP)]
            with torch.cuda.device(dev):
                status = lib.h264_set_constants(*(a.ctypes.data
                                                  for a in arrays))
            if status:
                raise RuntimeError(f"h264_set_constants failed: cudaError "
                                   f"{status - 1000}")
            _sent.add(dev.index)
    return lib


def _count(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError "
                           f"{status - 1000}")
    with _lock:
        launches[name] += 1


def _planes_ok(planes: Sequence[torch.Tensor], what: str) -> None:
    for p in planes:
        _cuda_check(p, what)
        if not p.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous planes")


def _wave_ok(tensors: Sequence[torch.Tensor], mb_width: int) -> None:
    """H3 and H4 move 16- and 8-byte rows of the planes, residuals and
    block records, and keep a bit a macroblock of a row for at most
    MAX_MB_WIDTH."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel takes 16-byte aligned planes, "
                         "residuals and block records")
    if mb_width > MAX_MB_WIDTH:
        raise ValueError(f"the kernel takes pictures up to {MAX_MB_WIDTH} "
                         f"macroblocks wide, not {mb_width}")


# --- the kernels' wrappers ---------------------------------------------------------

def residual(coef: torch.Tensor, bmap: torch.Tensor, mb: torch.Tensor,
             mb_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """H1 (see residual_plain): the kernel on CUDA tensors, the plain
    version on CPU ones."""
    if coef.device.type == "cpu":
        return residual_plain(coef, bmap, mb, mb_width)
    for t, n in ((coef, "coef"), (bmap, "bmap"), (mb, "mb")):
        _cuda_check(t, n)
    f_n, m, _ = bmap.shape
    mb_h = m // mb_width
    dev = coef.device
    res_y = torch.empty((f_n, 16 * mb_h, 16 * mb_width), dtype=torch.int16,
                        device=dev)
    res_c = torch.empty((f_n, 2, 8 * mb_h, 8 * mb_width), dtype=torch.int16,
                        device=dev)
    if f_n == 0:
        return res_y, res_c
    lib = _load_for(dev)
    with torch.cuda.device(dev):
        status = lib.h264_residual(
            coef.contiguous().data_ptr(), bmap.contiguous().data_ptr(),
            mb.contiguous().data_ptr(), f_n, mb_width, mb_h,
            res_y.data_ptr(), res_c.data_ptr(), _stream(dev))
    _count("residual", status)
    return res_y, res_c


def inter_predict(planes: Sequence[torch.Tensor], out: int, mb: torch.Tensor,
                  blk: torch.Tensor, res_y: torch.Tensor,
                  res_c: torch.Tensor, mb_width: int) -> None:
    """H2 (see inter_predict_plain), in place on slot `out`."""
    if planes[0].device.type == "cpu":
        return inter_predict_plain(planes, out, mb, blk, res_y, res_c,
                                   mb_width)
    _planes_ok(planes, "planes")
    for t, n in ((mb, "mb"), (blk, "blk"), (res_y, "res_y"),
                 (res_c, "res_c")):
        _cuda_check(t, n)
    dev = planes[0].device
    lib = _load_for(dev)
    h, w = planes[0].shape[1:]
    with torch.cuda.device(dev):
        status = lib.h264_inter_predict(
            *(p.data_ptr() for p in planes), h, w, out,
            mb.contiguous().data_ptr(), blk.contiguous().data_ptr(),
            mb_width, res_y.contiguous().data_ptr(),
            res_c.contiguous().data_ptr(), _stream(dev))
    _count("inter_predict", status)
    return None


def intra_reconstruct(planes: Sequence[torch.Tensor], out: int,
                      mb: torch.Tensor, pcm: torch.Tensor,
                      res_y: torch.Tensor, res_c: torch.Tensor,
                      mb_width: int) -> None:
    """H3 (see intra_reconstruct_plain), in place on slot `out`."""
    if planes[0].device.type == "cpu":
        return intra_reconstruct_plain(planes, out, mb, pcm, res_y, res_c,
                                       mb_width)
    _planes_ok(planes, "planes")
    for t, n in ((mb, "mb"), (pcm, "pcm"), (res_y, "res_y"),
                 (res_c, "res_c")):
        _cuda_check(t, n)
    res_y, res_c = res_y.contiguous(), res_c.contiguous()
    _wave_ok([*planes, res_y, res_c], mb_width)
    dev = planes[0].device
    lib = _load_for(dev)
    h, w = planes[0].shape[1:]
    sync = torch.empty(1 + h // 16, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = lib.h264_intra_reconstruct(
            *(p.data_ptr() for p in planes), h, w, out,
            mb.contiguous().data_ptr(), pcm.contiguous().data_ptr(),
            mb_width, res_y.data_ptr(), res_c.data_ptr(), sync.data_ptr(),
            _stream(dev))
    _count("intra_reconstruct", status)
    return None


def deblock(planes: Sequence[torch.Tensor], out: int, mb: torch.Tensor,
            blk: torch.Tensor, mb_width: int) -> None:
    """H4 (see deblock_plain), in place on slot `out`."""
    if planes[0].device.type == "cpu":
        return deblock_plain(planes, out, mb, blk, mb_width)
    _planes_ok(planes, "planes")
    for t, n in ((mb, "mb"), (blk, "blk")):
        _cuda_check(t, n)
    blk = blk.contiguous()
    _wave_ok([*planes, blk], mb_width)
    dev = planes[0].device
    lib = _load_for(dev)
    h, w = planes[0].shape[1:]
    sync = torch.empty(1 + h // 16, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = lib.h264_deblock(
            *(p.data_ptr() for p in planes), h, w, out,
            mb.contiguous().data_ptr(), blk.data_ptr(), mb_width,
            sync.data_ptr(), _stream(dev))
    _count("deblock", status)
    return None


# --- the host parser -------------------------------------------------------------

SLICE_FIELDS = 12 + 32


def parse_batch(stream, lo: int, hi: int, slot: Dict[int, int],
                dev: torch.device):
    """The C++ parser over pictures [lo, hi) of a scanned stream
    (io/h264.scan) on host threads, its records packed into one pinned
    buffer and copied to `dev` in one transfer: io/h264.entropy_decode's
    ((mb, blk, bmap, coef, pcm), summary)."""
    from faceoff_tpu_torch.io import h264 as M
    lib = load()
    sps = stream.sps
    mbw, mbh = sps.mb_width, sps.mb_height
    m = mbw * mbh
    n = hi - lo
    rows, first, blobs = [], [0], []
    off = 0
    for f in range(lo, hi):
        for sl in stream.pictures[f].slices:
            refs = [slot[r] if r >= 0 else -1 for r in sl.refs]
            rows.append([off, len(sl.rbsp), sl.data_bit, sl.kind,
                         sl.first_mb, sl.qp, sl.num_ref, sl.disable_filter,
                         sl.alpha, sl.beta, sl.pps.chroma_qp_index_offset,
                         sl.pps.constrained_intra_pred]
                        + refs + [-1] * (32 - len(refs)))
            blobs.append(sl.rbsp)
            off += len(sl.rbsp)
        first.append(len(rows))
    data = b"".join(blobs) + b"\0" * 16
    slices = np.asarray(rows, np.int64).reshape(-1, SLICE_FIELDS)
    first_a = np.asarray(first, np.int32)
    counts = (ctypes.c_int64 * 2)()
    handle = lib.h264_parse(data, slices.ctypes.data, first_a.ctypes.data, n,
                            mbw, mbh, threads(), counts)
    err = lib.h264_error(handle)
    if err:
        lib.h264_free(handle)
        raise M.BitstreamError(f"H.264 parse: {err.decode()}")
    nb, npcm = counts[0], counts[1]
    parts = [n * m * MB_FIELDS * 4, n * m * 16 * BLK_FIELDS * 4,
             n * m * NBLK * 4, nb * 16 * 2, npcm * 384]
    starts = np.concatenate([[0], np.cumsum([(p + 15) & ~15
                                             for p in parts])])
    buf = torch.empty(int(starts[-1]), dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    at = [buf.data_ptr() + int(x) for x in starts[:-1]]
    status = lib.h264_parse_fetch(handle, *at)
    lib.h264_free(handle)
    if status:
        raise M.BitstreamError("H.264 parse: fetch failed")
    host_mb = buf[: parts[0]].view(torch.int32).numpy().reshape(n, m,
                                                                MB_FIELDS)
    info = M.summary(host_mb)
    dbuf = buf.to(dev, non_blocking=True)

    def part(i, dtype):
        return dbuf[int(starts[i]): int(starts[i]) + parts[i]].view(dtype)

    return ((part(0, torch.int32).view(n, m, MB_FIELDS),
             part(1, torch.int32).view(n, m, 16, BLK_FIELDS),
             part(2, torch.int32).view(n, m, NBLK),
             part(3, torch.int16).view(nb, 16),
             part(4, torch.uint8).view(npcm, 384)), info)
