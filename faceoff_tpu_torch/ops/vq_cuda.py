"""The VQ assignment and statistics kernels (`csrc/vq.cu`): build, load,
launch.

Built at first use by `ops/cuda_build.py` (plain `nvcc`, a C interface)
and loaded with ctypes; a failed build or launch raises. `vq_assign` is
the wrapper of the pair: it casts its inputs to float32 as the TPU
kernel's wrapper does (`faceoff_tpu/ops/vq_pallas.py:302-303`) and calls
`assign_rows` and `code_stats`, which check their inputs, allocate (and
zero) their outputs, launch on PyTorch's current stream and each count
their own kernel's launches (`assign_launches`, `stats_launches`). The
plain version is `ops/vq.vq_assign_plain`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from faceoff_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "vq.cu"
MAX_DIM = 224  # the assignment block's shared memory at D = 224 is 226 KB

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
        for name in ("faceoff_vq_assign_rows", "faceoff_vq_stats"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def assign_rows(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The assignment kernel alone: flat (N, D), embed (D, K), float32,
    contiguous, on one CUDA device -> (idx (N,) int32, quant (N, D))."""
    global assign_launches
    _check("flat", flat, torch.float32, flat.device)
    _check("embed", embed, torch.float32, flat.device)
    if embed.dim() != 2:
        raise ValueError(f"want embed (D, K), got {tuple(embed.shape)}")
    d, k = embed.shape
    n = _sizes(flat, d, k)
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    quant = torch.empty((n, d), dtype=torch.float32, device=flat.device)
    if n:
        _launch(load().faceoff_vq_assign_rows, flat, embed, idx, quant,
                n, d, k)
        assign_launches += 1
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
    counts = torch.zeros((k,), dtype=torch.float32, device=flat.device)
    sums = torch.zeros((d, k), dtype=torch.float32, device=flat.device)
    if n:
        _launch(load().faceoff_vq_stats, flat, idx, counts, sums, n, d, k)
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
