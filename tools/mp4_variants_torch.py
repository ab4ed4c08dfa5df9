#!/usr/bin/env python3
"""Time variants of kernels V3 (motion search) and V4 (forward DCT and
quantisation) on one GPU beside the port's own (`faceoff_tpu_torch/csrc/
mpeg4.cu`), to find what bounds them and to choose their shapes.

    python3 tools/mp4_variants_torch.py [SASS_DIR]

Builds `tools/mpeg4_probe.cu` (its header lists the variants; it includes
the port's source) with the port's nvcc recipe. Encodes a 72-frame
1280x720 clip and a 48-frame 256-px clip through `io/mpeg4.encode` (the
frames `chip_smoke.py`'s phase 18 encodes: a face over a grey textured
background) and keeps each stage's largest call. At each call it holds
every variant that computes V3 or V4 to the plain version bit for bit
(the port's first forms of both, as `original`, among them),
then times the variants and the port's wrapper as CUDA-graph replays
(`chip_smoke.device_ms`), twice: in the order given, then reversed.
Also prints the instruction rates of `vabsdiff4`, `__byte_perm`, float32
FMA and integer multiply-add (8 independent chains a thread, one wave),
and what `cuobjdump` shows of the port's two kernels: their SASS
instruction counts by opcode and their registers (with SASS_DIR, their
SASS listings written there). One JSON line a
shape, one for the rates, one for the SASS, then the card's name and
power limit.
"""

from __future__ import annotations

import collections
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
from faceoff_tpu_torch.data.synthetic import draw_faces, face_landmarks  # noqa: E402
from faceoff_tpu_torch.io import mpeg4  # noqa: E402
from faceoff_tpu_torch.ops import cuda_build  # noqa: E402
from faceoff_tpu_torch.ops import mpeg4_cuda as K  # noqa: E402

PROBE = Path(__file__).resolve().parent / "mpeg4_probe.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SM_COUNT = 132  # H100 SXM
RATE_KINDS = ("vabsdiff4", "byte_perm", "ffma", "imad")


def load_probe() -> ctypes.CDLL:
    # the probe includes the port's source: rebuild when either changes
    digest = hashlib.sha256(K.SOURCE.read_bytes()).hexdigest()[:8]
    lib = ctypes.CDLL(str(cuda_build.build(PROBE, f"mpeg4_probe_{digest}")))
    lib.probe_motion_search.argtypes = [_I, _P, _I, _I, _P, _I, _I, _I, _P,
                                        _P]
    lib.probe_fdct_quant.argtypes = [_I] + [_P] * 6 + [_I, _I, _P, _P, _I,
                                                      _P, _P]
    lib.probe_rate.argtypes = [_I, _I, _I, _I, _P, _P]
    lib.probe_search_shapes.argtypes = [_P, _I]
    lib.probe_fdct_shapes.argtypes = [_P, _I]
    lib.mpeg4_set_recip.argtypes = [_P, _I, _P]
    if lib.mpeg4_set_recip(K.RECIP.ctypes.data, len(K.RECIP), stream()):
        raise RuntimeError("probe: mpeg4_set_recip failed")
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def shapes(lib):
    buf = (ctypes.c_int * 96)()
    n = lib.probe_search_shapes(buf, 32)
    search = [tuple(buf[3 * i: 3 * i + 3]) for i in range(n)]
    n = lib.probe_fdct_shapes(buf, 96)
    return search, [buf[i] for i in range(n)]


def in_turns(fns: dict) -> dict:
    """Each function's device ms, in the order given, then reversed."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(cs.device_ms(fns[k], reps=10, inner=5))
    return times


def clip(n: int, h: int, w: int, seed: int) -> torch.Tensor:
    """A face drifting over a grey textured background, as phase 18's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand((1, 1, h // 16, w // 16), generator=gen,
                       device="cuda") * 70 + 20
    bg = torch.nn.functional.interpolate(
        noise, size=(h, w), mode="bicubic", align_corners=False)[0, 0]
    bg = bg.clamp(0, 255).round().to(torch.uint8)[..., None].expand(h, w, 3)
    lms = np.stack([face_landmarks(
        (w * (0.4 + 0.05 * np.sin(0.05 * f)), h * (0.5 + 0.03 * np.cos(
            0.04 * f))), 0.15 * h, 4 * np.sin(0.03 * f)) for f in range(n)])
    return draw_faces(bg.expand(n, -1, -1, -1),
                      torch.from_numpy(lms.astype(np.float32)).cuda(),
                      (205, 165, 140))


def largest_calls(frames: torch.Tensor) -> dict:
    with cs.Mp4Calls(hold=False) as calls:
        mpeg4.encode(frames, cs.PRE_FPS)
    return {k: calls.largest[k][1] for k in ("motion_search", "fdct_quant")}


def search_row(lib, search_shapes, args) -> dict:
    y, items, width, height = args
    _, h16, w16 = y.shape
    want = K.motion_search_plain(y, items, width, height)
    out = torch.empty_like(want)

    def probe(v):
        def run():
            err = lib.probe_motion_search(
                v, y.data_ptr(), h16, w16, items.data_ptr(), items.shape[0],
                width, height, out.data_ptr(), stream())
            if err:
                raise RuntimeError(f"probe V3 variant {v}: cudaError {err}")
        return run

    names = ["original", "redesign1", "redesign2"] + [
        f"run{r}_dy{d}_mbs{m}" for r, d, m in search_shapes]
    fns = {name: probe(v) for v, name in enumerate(names)}
    for name, fn in fns.items():
        out.fill_(-1)
        fn()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"V3 {name} differs from the plain version")
    if not torch.equal(K.motion_search(*args), want):
        raise AssertionError("V3: the port differs from the plain version")
    fns["port"] = lambda: K.motion_search(*args)
    bound, by = cs.mp4_bound("motion_search", args)
    return {"kernel": "motion_search", "items": int(items.shape[0]),
            "size": [width, height], "bound_ms": bound, "bound_by": by,
            "sass_bound_ms": cs.mp4_sass_bound(args),
            "device_ms": in_turns(fns)}


def fdct_row(lib, fdct_shapes, args) -> dict:
    src, pred, mb, items = args
    h16, w16 = src[0].shape[1:]
    want = K.fdct_quant_plain(*args)
    out = torch.empty_like(want)

    def probe(v):
        def run():
            err = lib.probe_fdct_quant(
                v, *(p.data_ptr() for p in src), *(p.data_ptr() for p in pred),
                h16, w16, mb.data_ptr(), items.data_ptr(), items.shape[0],
                out.data_ptr(), stream())
            if err:
                raise RuntimeError(f"probe V4 variant {v}: cudaError {err}")
        return run

    names = ["original", "block", "copy"] + [f"rows_mbs{m}" for m in fdct_shapes]
    fns = {name: probe(v) for v, name in enumerate(names)}
    for name, fn in fns.items():
        if name == "copy":  # moves V4's bytes, computes something else
            continue
        out.fill_(-1)
        fn()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"V4 {name} differs from the plain version")
    if not torch.equal(K.fdct_quant(*args), want):
        raise AssertionError("V4: the port differs from the plain version")
    fns["port"] = lambda: K.fdct_quant(*args)
    bound, by = cs.mp4_bound("fdct_quant", args)
    return {"kernel": "fdct_quant", "items": int(items.shape[0]),
            "size": [w16, h16], "bound_ms": bound, "bound_by": by,
            "device_ms": in_turns(fns)}


def rates(lib) -> dict:
    """Each kind's instructions a second (8 blocks of 256 threads an SM,
    one wave) and a clock an SM taking float32 FMA at its 128."""
    blocks, threads, iters = SM_COUNT * 8, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    per_s = {}
    for kind, name in enumerate(RATE_KINDS):
        def run():
            if lib.probe_rate(kind, blocks, threads, iters, out.data_ptr(),
                              stream()):
                raise RuntimeError(f"probe_rate {name}")
        per_s[name] = blocks * threads * iters * 8 / cs.device_ms(
            run, reps=5, inner=3) * 1e3
    return {name: {"per_s": v, "per_clock_sm_if_ffma_128":
                   128 * v / per_s["ffma"]} for name, v in per_s.items()}


def sass(lib_path: Path, dump: Path = None) -> dict:
    """Instruction counts by opcode and registers of the port's V3 and V4
    kernels, from cuobjdump; with `dump`, each kernel's SASS into a file
    there."""
    tool = Path(cuda_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    res = subprocess.run([str(tool), "-res-usage", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    out = {}
    blocks = re.split(r"\n\s*Function : ", text)
    for name in ("motion_search_kernel", "fdct_quant_kernel"):
        body = next((b for b in blocks if name in b.split("\n", 1)[0]), "")
        if dump:
            (dump / f"{name}.sass").write_text(body)
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                body))
        after = res[res.find(name):] if name in res else ""
        usage = next((line.strip() for line in after.splitlines()
                      if "REG:" in line), "")
        regs = re.search(r"REG:(\d+)", usage)
        out[name] = {"instructions": sum(ops.values()),
                     "by_opcode": dict(ops.most_common(16)),
                     "registers": int(regs.group(1)) if regs else None,
                     "usage": usage[:200]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    lib = load_probe()
    search_shapes, fdct_shapes = shapes(lib)
    K.load()
    for n, h, w in ((72, cs.PRE_H, cs.PRE_W), (48, cs.TRAIN_SIZE,
                                               cs.TRAIN_SIZE)):
        calls = largest_calls(clip(n, h, w, seed=100))
        print(json.dumps(search_row(lib, search_shapes,
                                    calls["motion_search"])), flush=True)
        print(json.dumps(fdct_row(lib, fdct_shapes, calls["fdct_quant"])),
              flush=True)
        del calls
    print(json.dumps({"rates": rates(lib)}), flush=True)
    dump = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    if dump:
        dump.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"sass": sass(K.library_path(), dump)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
