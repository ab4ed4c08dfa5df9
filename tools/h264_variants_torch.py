#!/usr/bin/env python3
"""Time forms of kernels H3 (intra reconstruction) and H4 (the loop
filter) of the H.264 decoder on one GPU beside the port's own
(`faceoff_tpu_torch/csrc/h264.cu`), to choose the macroblock rows a
thread block (`WAVE_ROWS`) and to set the port against its first forms.

    python3 tools/h264_variants_torch.py [SASS_DIR]

Builds `tools/h264_variants.cu` (its header lists the forms: the first
ones, `original`, one thread block of 64 threads a macroblock row with a
block barrier and reads through L2 between dependent steps; the port's
kernels at 1, 2, 4 and 8 rows a block) with the port's nvcc recipe.
Decodes the four H.264 fixtures on the card (`tests/data_torch/h264_*`,
as `chip_smoke.py`'s phase 21 does) and keeps four calls: H3 and H4 at
the picture with the most work (the 720p fixture's I picture) and at the
P picture with the most work. At each call it holds every form to the
plain version bit for bit, then times the forms and the port's wrapper
as CUDA-graph replays (`chip_smoke.device_ms`; H4 restores its planes
before each call and the restore's own time is taken off), twice: in
the order given, then reversed. Prints one JSON line a call, one with
the registers, shared memory and stack of each kernel (`cuobjdump
-res-usage`; with SASS_DIR, the SASS of the port's kernels written
there), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from faceoff_tpu_torch.io.video import read_video_frames  # noqa: E402
from faceoff_tpu_torch.ops import cuda_build  # noqa: E402
from faceoff_tpu_torch.ops import h264_cuda as K  # noqa: E402

PROBE = Path(__file__).resolve().parent / "h264_variants.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int


def load_forms():
    """The forms' library (rebuilt when it or the port's source changes)
    with the constant tables sent, and the forms' names."""
    digest = hashlib.sha256(K.SOURCE.read_bytes()).hexdigest()[:8]
    path = cuda_build.build(PROBE, f"h264_variants_{digest}")
    lib = ctypes.CDLL(str(path))
    lib.probe_h264_forms.argtypes = [_P, _I]
    lib.probe_h264_intra.argtypes = [_I, _P, _P, _P, _I, _I, _I, _P, _P, _I,
                                     _P, _P, _P, _P]
    lib.probe_h264_deblock.argtypes = [_I, _P, _P, _P, _I, _I, _I, _P, _P,
                                       _I, _P, _P]
    lib.h264_set_constants.argtypes = [_P] * 6
    arrays = [np.ascontiguousarray(a, np.int32).reshape(-1) for a in (
        K.INTRA4_TAPS, K.ALPHA, K.BETA, K.TC0, K.LEVEL_SCALE, K.CHROMA_QP)]
    if lib.h264_set_constants(*(a.ctypes.data for a in arrays)):
        raise RuntimeError("h264_set_constants failed")
    rows = (ctypes.c_int * 8)()
    n = lib.probe_h264_forms(rows, 8)
    names = ["original"] + [f"rows{rows[i]}" for i in range(n - 1)]
    return lib, path, names


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def form_call(lib, name, form, args):
    """A function launching form `form` of stage `name` on `args` (the
    wrapper's arguments), in place on its planes."""
    planes, out = args[0], args[1]
    h, w = planes[0].shape[1:]
    sync = torch.empty(1 + h // 16, dtype=torch.int32, device=cs.DEV)
    if name == "intra_reconstruct":
        mb, pcm, res_y, res_c, mbw = args[2:]

        def run():
            if lib.probe_h264_intra(form, *(p.data_ptr() for p in planes), h,
                                    w, out, mb.data_ptr(), pcm.data_ptr(),
                                    mbw, res_y.data_ptr(), res_c.data_ptr(),
                                    sync.data_ptr(), stream()):
                raise RuntimeError(f"intra form {form} failed")
    else:
        mb, blk, mbw = args[2:]

        def run():
            if lib.probe_h264_deblock(form, *(p.data_ptr() for p in planes),
                                      h, w, out, mb.data_ptr(),
                                      blk.data_ptr(), mbw, sync.data_ptr(),
                                      stream()):
                raise RuntimeError(f"deblock form {form} failed")
    return run


def with_restore(name, args, fn):
    """(timed, restore): H4 filters in place, so each timed call first
    restores the out-slot from the planes kept at the path's call."""
    if name != "deblock":
        return fn, None
    planes, out = args[0], args[1]
    kept = [p[out].clone() for p in planes]

    def restore():
        for p, k in zip(planes, kept):
            p[out].copy_(k)

    def timed():
        restore()
        fn()
    return timed, restore


def fresh(args):
    """The call's arguments with its planes copied."""
    return ([p.clone() for p in args[0]],) + tuple(args[1:])


def run_call(lib, names, name, call) -> dict:
    work, args = call
    want = cs.h264_run_plain(name, args)
    fns = {}
    for form, fname in enumerate(names):
        a = fresh(args)
        form_call(lib, name, form, a)()
        err = cs.h264_max_err(name, a[0], want)
        if err:
            raise AssertionError(f"{name} form {fname} differs from the "
                                 f"plain version by {err}")
        fns[fname] = with_restore(name, args,
                                  form_call(lib, name, form, args))
    a = fresh(args)
    getattr(K, name)(*a)
    if cs.h264_max_err(name, a[0], want):
        raise AssertionError(f"{name}: the port differs from the plain "
                             "version")
    fns["port"] = with_restore(name, args,
                               lambda: getattr(K, name)(*args))
    order = list(fns)
    times = {k: [] for k in order}
    for seq in (order, order[::-1]):
        for k in seq:
            timed, restore = fns[k]
            ms = cs.device_ms(timed, reps=10, inner=5)
            if restore is not None:
                ms -= cs.device_ms(restore, reps=10, inner=5)
            times[k].append(ms)
    return {"stage": name, "work": work, "held": len(names) + 1,
            "ms": times}


def resources(path, sass_dir):
    """Registers, shared memory and stack of each H3/H4 kernel in the
    forms' library."""
    tool = Path(cuda_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-res-usage", str(path)],
                          capture_output=True, text=True).stdout
    out = {}
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function (\S+):", line)
        if m and ("intra_kernel" in m.group(1)
                  or "deblock_kernel" in m.group(1)):
            demangled = subprocess.run(["c++filt", m.group(1)],
                                       capture_output=True,
                                       text=True).stdout.strip()
            out[demangled] = lines[i + 1].strip() if i + 1 < len(lines) \
                else ""
    if sass_dir:
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        sass = subprocess.run([str(tool), "-sass", str(K.build())],
                              capture_output=True, text=True).stdout
        (Path(sass_dir) / "h264.sass").write_text(sass)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("h264_variants_torch: no CUDA device", file=sys.stderr)
        return 1
    sass_dir = sys.argv[1] if len(sys.argv) > 1 else None
    K.load()
    lib, path, names = load_forms()
    with cs.H264Calls(hold=False) as calls:
        for fixture in cs.H264_FIXTURES:
            read_video_frames(str(cs.ASP_DATA / fixture), device=cs.DEV)
    torch.cuda.synchronize()
    for name in ("intra_reconstruct", "deblock"):
        for label, store in (("largest", calls.largest),
                             ("largest_p", calls.largest_p)):
            row = run_call(lib, names, name, store[name])
            row["call"] = label
            print(json.dumps(row), flush=True)
    print(json.dumps({"resources": resources(path, sass_dir)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
