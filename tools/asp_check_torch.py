"""Check and time the Advanced Simple Profile decode on one GPU.

    python3 tools/asp_check_torch.py

Builds `csrc/mpeg4.cu` with nvcc (with `-Xptxas -v`, whose register and
spill lines it prints for the kernels of the decode), then runs
chip_smoke.py's phase 18 ASP part alone (`chip_smoke.asp_phase`): the four
fixtures tests/data_torch/asp_* decoded on the card and held against
cv2's stored decode and the CPU plain decode, V1, V2 and V5 against their
plain versions at every call, each timed at the path's largest call, the
720p fixture's frames/s and host share, and preprocessing stage 1 on it.
About a minute on an H100; prints the card and one JSON line of results.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from faceoff_tpu_torch.ops import cuda_build, mpeg4_cuda  # noqa: E402


def ptxas_lines() -> list:
    """nvcc -Xptxas -v of csrc/mpeg4.cu: the lines of the decode's
    kernels (V1, V2, V5)."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(Path(tmp) / "probe.so"), str(mpeg4_cuda.SOURCE)],
            capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    keep, name = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and any(k in name for k in ("dequant_idct", "compensate")) \
                and ("registers" in line or "spill" in line):
            keep.append(f"{name}: {line.strip()}")
    return keep


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("asp_check_torch: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    for line in ptxas_lines():
        print(line)
    mpeg4_cuda.build()
    mpeg4_cuda.load()
    chip_smoke.say("build", t0, "csrc/mpeg4.cu built")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as work:
        result = chip_smoke.asp_phase(time.perf_counter(), Path(work))
    print(card)
    print(json.dumps({"card": card, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
