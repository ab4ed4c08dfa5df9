"""Build a kernel source of `csrc/` into a shared library with plain nvcc.

Each source has a plain C interface, so no PyTorch headers are involved
and a build takes seconds. The library lands in `faceoff_tpu_torch/_build/`
(git-ignored), named by a hash of the source and the flags, so an edited
`.cu` rebuilds. A failed build raises: there is no fallback to the plain
versions. Sources are independent, so callers may build them in parallel
threads (`nvcc` runs as a subprocess and releases the interpreter lock).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 300


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def link_flags(libs: Sequence[str]) -> List[str]:
    """Flags that link the CUDA toolkit's libraries `libs` (e.g. "nvjpeg")
    and find them again at load time."""
    if not libs:
        return []
    lib_dir = Path(nvcc()).resolve().parent.parent / "lib64"
    return [f"-L{lib_dir}", *(f"-l{name}" for name in libs),
            "-Xlinker", f"-rpath,{lib_dir}"]


def library_path(source: Path, stem: str, libs: Sequence[str] = ()) -> Path:
    """Where the build of `source` with the current flags lives."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join((*NVCC_FLAGS, *libs)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def build(source: Path, stem: str, libs: Sequence[str] = ()) -> Path:
    """Compile `source` unless this version is already built, linking the
    CUDA toolkit's libraries `libs`.

    Prints the build's seconds to stderr when it compiles."""
    out = library_path(source, stem, libs)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp{os.getpid()}_{out.name}"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source),
           *link_flags(libs)]
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    print(
        f"built {out.name} in {time.perf_counter() - t0:.2f} s",
        file=sys.stderr, flush=True,
    )
    return out
