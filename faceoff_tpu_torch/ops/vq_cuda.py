"""The VQ assignment and statistics kernels (`csrc/vq.cu`): build, load,
launch.

Built at first use by `ops/cuda_build.py` (plain `nvcc`, a C interface)
and loaded with ctypes; a failed build or launch raises. `vq_assign` is
the wrapper of the pair: it casts its inputs to float32 as the TPU
kernel's wrapper does (`faceoff_tpu/ops/vq_pallas.py:302-303`) and calls
`assign_rows` and `code_stats`, which check their inputs, allocate their
outputs and scratch, launch on PyTorch's current stream and each count
their own calls (`assign_launches`, `stats_launches`). The plain version
is `ops/vq.vq_assign_plain`.

The designs (the header of `csrc/vq.cu` has the details):

- Assignment: the scores x . e_k - 0.5 ||e_k||^2 on the tensor cores
  from split operands (hi = TF32 rounding, lo = the rest): x_hi e_hi as
  a TF32 product and the two cross terms x_hi e_lo + x_lo e_hi as one
  bf16 product of twice the depth, 0.14 ms of tensor-core work at
  (524288, 64, 512) against 0.51 ms for float32 FMA on the CUDA cores.
  A row whose two best split scores lie within 2 eps_row of each other
  (`split_score_eps`) is re-scored exactly in float32; every other row's
  pick is the exact argmax. Bound: operations.
- Statistics: a stable counting sort of the rows by code (per-segment
  counts, scans, placement of row ids), then one warp per chunk of at
  most 128 rows of one code sums them in registers, and the chunks of a
  code are added in order: x is read once at every K, and equal inputs
  give bitwise equal results in every run. Bound: bytes.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from faceoff_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "vq.cu"
MAX_DIM = 224  # the re-score holds rows of up to 224 floats; at D = 224 the
#                assignment block is 4 warps in 177 KB of shared memory

U32 = 2.0 ** -24  # float32 unit roundoff
# Units in the last place of its largest addend that one tensor-core
# accumulation may lose. Products of TF32 or bf16 operands are exact, but
# how the tensor core adds the products and the accumulator is not
# specified; with the addends aligned to the largest and truncated (< 1 ulp
# each) and the sum truncated (< 2^ceil(log2 m) ulps of the largest for m
# addends), an m16n8k8 TF32 step (m = 9) loses < 25 ulps and an m16n8k16
# bf16 step (m = 17) < 49; 32 and 64 are allowed.
MMA_ULPS_TF32 = 32
MMA_ULPS_BF16 = 64

# kernel launches made through the wrappers in this process
assign_launches = 0
stats_launches = 0

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return cuda_build.library_path(SOURCE, "faceoff_vq")


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    return cuda_build.build(SOURCE, "faceoff_vq")


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.faceoff_vq_assign_rows.argtypes = (
            [vp] * 7 + [i32] * 3 + [ctypes.c_float] * 2 + [vp])
        lib.faceoff_vq_stats.argtypes = [vp] * 5 + [i32] * 3 + [vp]
        for fn in (lib.faceoff_vq_assign_rows, lib.faceoff_vq_stats):
            fn.restype = i32
        lib.faceoff_vq_assign_scratch_floats.argtypes = [i32, i32]
        lib.faceoff_vq_stats_scratch_ints.argtypes = [i32, i32, i32]
        lib.faceoff_vq_assign_scratch_floats.restype = ctypes.c_longlong
        lib.faceoff_vq_stats_scratch_ints.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def split_score_eps(d: int) -> Tuple[float, float]:
    """(c1, c2) of the assignment's per-row bound on |split score - exact
    score|, eps_row = c1 ||x||_2 max_k ||e_k||_2 + c2 max_k ||e_k||^2, at
    width d.

    With v_hi the TF32 rounding of v (|v - v_hi| <= 2^-11 |v|), the kernel
    sums x_hi e_hi (TF32, exact products) and bf16(x_hi) bf16(e - e_hi) +
    bf16(x - x_hi) bf16(e_hi) (bf16, unit roundoff 2^-9). x . e minus that
    is (x - x_hi)(e - e_hi) (<= 2^-22 |x_d e_d|) plus the bf16 roundings
    of the two cross terms (each <= 2^-19 (1.0015) |x_d e_d|): at most
    17.1 2^-22 sum |x_d e_d|. Each 8-depth step accumulates once in TF32
    and once in bf16 (MMA_ULPS_TF32 + MMA_ULPS_BF16 ulps of the running
    sum of |products|, <= 1.01 sum |x_d e_d|); subtracting the float32 half
    norm rounds once more (u of |score| + 0.5 max ||e_k||^2).
    Cauchy-Schwarz bounds sum |x_d e_d| by ||x|| max ||e_k||; the factor
    1.25 covers the float32 rounding of the bound's own terms."""
    steps = -(-d // 8)
    c1 = 1.25 * (steps * (MMA_ULPS_TF32 + MMA_ULPS_BF16) * 2.0 ** -23 * 1.01
                 + 17.1 * 2.0 ** -22 + U32 * 1.01)
    c2 = 1.25 * U32 * 0.5
    return c1, c2


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a.data_ptr() if torch.is_tensor(a) else a for a in args],
                 stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def _sizes(flat: torch.Tensor, d: int, k: int) -> int:
    n = flat.shape[0]
    if flat.dim() != 2 or flat.shape[1] != d:
        raise ValueError(f"want flat (N, {d}), got {tuple(flat.shape)}")
    if not (1 <= d <= MAX_DIM) or k < 1 or n >= 2**31:
        raise ValueError(f"unsupported sizes N={n}, D={d}, K={k} "
                         f"(1 <= D <= {MAX_DIM}, K >= 1, N < 2^31)")
    return n


def assign_rows_flagged(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The assignment kernels: flat (N, D), embed (D, K), float32,
    contiguous, on one CUDA device -> (idx (N,) int32, quant (N, D), the
    number of rows re-scored in float32 as a 0-d int32 tensor on the
    device; reading it synchronises)."""
    global assign_launches
    _check("flat", flat, torch.float32, flat.device)
    _check("embed", embed, torch.float32, flat.device)
    if embed.dim() != 2:
        raise ValueError(f"want embed (D, K), got {tuple(embed.shape)}")
    d, k = embed.shape
    n = _sizes(flat, d, k)
    dev = flat.device
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    quant = torch.empty((n, d), dtype=torch.float32, device=dev)
    iwork = (torch.empty if n else torch.zeros)((n + 1,), dtype=torch.int32,
                                                device=dev)
    if n:
        lib = load()
        fwork = torch.empty((lib.faceoff_vq_assign_scratch_floats(d, k),),
                            dtype=torch.float32, device=dev)
        keys = torch.empty((n,), dtype=torch.int64, device=dev)
        _launch(lib.faceoff_vq_assign_rows, flat, embed, idx, quant, fwork,
                iwork, keys, n, d, k, *split_score_eps(d))
        assign_launches += 1
    return idx, quant, iwork[0]


def assign_rows(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The assignment kernels alone: flat (N, D), embed (D, K), float32,
    contiguous, on one CUDA device -> (idx (N,) int32, quant (N, D))."""
    idx, quant, _ = assign_rows_flagged(flat, embed)
    return idx, quant


def code_stats(
    flat: torch.Tensor, idx: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The statistics kernel alone: flat (N, D) float32 and idx (N,) int32
    in [0, k), contiguous, on one CUDA device -> (counts (k,), sums (D, k))
    float32."""
    global stats_launches
    _check("flat", flat, torch.float32, flat.device)
    _check("idx", idx, torch.int32, flat.device)
    d = flat.shape[1] if flat.dim() == 2 else -1
    n = _sizes(flat, d, k)
    if tuple(idx.shape) != (n,):
        raise ValueError(f"idx is {tuple(idx.shape)}, want ({n},)")
    if not n:
        return (torch.zeros((k,), device=flat.device),
                torch.zeros((d, k), device=flat.device))
    counts = torch.empty((k,), dtype=torch.float32, device=flat.device)
    sums = torch.empty((d, k), dtype=torch.float32, device=flat.device)
    lib = load()
    iwork = torch.empty((lib.faceoff_vq_stats_scratch_ints(n, d, k),),
                        dtype=torch.int32, device=flat.device)
    _launch(lib.faceoff_vq_stats, flat, idx, counts, sums, iwork, n, d, k)
    stats_launches += 1
    return counts, sums


def vq_assign(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest code, quantized rows and EMA statistics on the card: the
    assignment kernel, then the statistics kernel.

    flat (N, D), embed (D, K), on one CUDA device, any float dtype (cast
    to float32) -> (idx (N,) int32, quant (N, D) f32, counts (K,) f32,
    sums (D, K) f32). No gradient flows through any output.
    """
    for name, t in (("flat", flat), ("embed", embed)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    x32 = flat.detach().to(torch.float32).contiguous()
    e32 = embed.detach().to(torch.float32).contiguous()
    idx, quant = assign_rows(x32, e32)
    counts, sums = code_stats(x32, idx, e32.shape[1])
    return idx, quant, counts, sums
