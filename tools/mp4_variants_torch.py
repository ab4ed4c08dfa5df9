#!/usr/bin/env python3
"""Time variants of kernels V1 (dequantisation and IDCT), V2 (motion
compensation), V3 (motion search), V4 (forward DCT and quantisation) and
V5 (bidirectional prediction) on one GPU beside the port's own
(`faceoff_tpu_torch/csrc/mpeg4.cu`), to find what bounds them and to
choose their shapes.

    python3 tools/mp4_variants_torch.py [--kernels NAME,...] [SASS_DIR]

Builds `tools/mpeg4_probe.cu` (its header lists the variants; it includes
the port's source) with the port's nvcc recipe. Encodes a 72-frame
1280x720 clip and a 48-frame 256-px clip through `io/mpeg4.encode` (the
frames `chip_smoke.py`'s phase 18 encodes: a face over a grey textured
background), decodes them through `io/mpeg4.decode`, and keeps the calls
of each stage: V3's and V4's largest; V1's at the decoder (the coded
blocks of a batch) and at the encoder (every block of a GOP position);
V2's at a decoder P depth (with its residual), at the encoder's
prediction (no residual) and at the decoder's I-VOP depth (no
reference). For V5 and V2's quarter-pel form (`--kernels` names
`bidir_compensate` and `motion_compensate_qpel`) it decodes the four
Advanced Simple Profile fixtures (`tests/data_torch/asp_*`, as
`chip_smoke.asp_phase` does) and keeps the largest call of each form:
V5 at quarter-pel (the 720p fixture's B-VOPs) and half-pel, V2 at
quarter-pel (a 720p VOP); their rows also time the copy form's parts
(without the residual, without the references, the record and stores
alone, and those with each warp storing its own rows), the shapes at 64
registers, the port's shape under other register caps, and with its
block's rows staged for whole-sector stores and without. At each call it holds every variant that computes the
stage to the plain version bit for bit (the port's first forms, as
`original`, among them; the `copy` forms, which only move the stage's
bytes, are timed but not held), then times the variants and the port's
wrapper as CUDA-graph replays (`chip_smoke.device_ms`), twice: in the
order given, then reversed. V1's rows also give the share of blocks
(and columns) whose column pass needs 64 bits. `--kernels` picks the
stages (default all six). Also prints the instruction rates of
`vabsdiff4`, `__byte_perm`, float32 FMA and integer multiply-add (8
independent chains a thread, one wave), and what `cuobjdump` shows of
the port's kernels: their SASS instruction counts by opcode (V1's
64-bit multiplies and V2's byte loads and stores counted apart) and
their registers (with SASS_DIR, their SASS listings written there). One
JSON line a call, one for the rates, one for the SASS, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
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
from faceoff_tpu_torch.io.video import read_video_frames  # noqa: E402
from faceoff_tpu_torch.ops import cuda_build  # noqa: E402
from faceoff_tpu_torch.ops import mpeg4_cuda as K  # noqa: E402

PROBE = Path(__file__).resolve().parent / "mpeg4_probe.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SM_COUNT = 132  # H100 SXM
RATE_KINDS = ("vabsdiff4", "byte_perm", "ffma", "imad")
# the Advanced Simple Profile's rows: (--kernels name, stage, form)
ASP_KERNELS = (("bidir_compensate", "bidir_compensate", "qpel"),
               ("bidir_compensate", "bidir_compensate", "hpel"),
               ("motion_compensate_qpel", "motion_compensate", "qpel"))


def load_probe() -> ctypes.CDLL:
    # the probe includes the port's source: rebuild when either changes
    digest = hashlib.sha256(K.SOURCE.read_bytes()).hexdigest()[:8]
    lib = ctypes.CDLL(str(cuda_build.build(PROBE, f"mpeg4_probe_{digest}")))
    lib.probe_motion_search.argtypes = [_I, _P, _I, _I, _P, _I, _I, _I, _P,
                                        _P]
    lib.probe_fdct_quant.argtypes = [_I] + [_P] * 6 + [_I, _I, _P, _P, _I,
                                                      _P, _P]
    lib.probe_dequant_idct.argtypes = [_I, _P, _P, _I, _P, _P, _P]
    lib.probe_motion_compensate.argtypes = [_I, _P, _P, _P, _I, _I, _P, _I,
                                            _P, _P, _I, _I, _I, _P]
    lib.probe_rate.argtypes = [_I, _I, _I, _I, _P, _P]
    lib.probe_bidir_compensate.argtypes = [_I, _P, _P, _P, _I, _I, _P, _I,
                                           _P, _P, _I, _I, _I, _I, _I, _P]
    lib.probe_mc_qpel.argtypes = [_I, _P, _P, _P, _I, _I, _P, _I, _P, _P,
                                  _I, _I, _I, _I, _P]
    for name in ("probe_search_shapes", "probe_fdct_shapes",
                 "probe_idct_shapes", "probe_mc_shapes", "probe_gm_shapes",
                 "probe_gm_minb"):
        getattr(lib, name).argtypes = [_P, _I]
    lib.mpeg4_set_recip.argtypes = [_P, _I, _P]
    if lib.mpeg4_set_recip(K.RECIP.ctypes.data, len(K.RECIP), stream()):
        raise RuntimeError("probe: mpeg4_set_recip failed")
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def shapes(lib) -> dict:
    buf = (ctypes.c_int * 96)()
    n = lib.probe_search_shapes(buf, 32)
    out = {"motion_search": [tuple(buf[3 * i: 3 * i + 3]) for i in range(n)]}
    n = lib.probe_fdct_shapes(buf, 96)
    out["fdct_quant"] = [buf[i] for i in range(n)]
    n = lib.probe_idct_shapes(buf, 48)
    out["dequant_idct"] = [tuple(buf[2 * i: 2 * i + 2]) for i in range(n)]
    n = lib.probe_mc_shapes(buf, 48)
    out["motion_compensate"] = [tuple(buf[2 * i: 2 * i + 2])
                                for i in range(n)]
    n = lib.probe_gm_shapes(buf, 96)
    out["gm"] = [f"mbs{buf[i]}" for i in range(n)]
    n = lib.probe_gm_minb(buf, 96)
    out["gm"] += [f"minb{buf[i]}" for i in range(n)]
    return out


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


class Calls:
    """The four stage wrappers of ops/mpeg4_cuda recorded: V3's and V4's
    largest call, and V1's and V2's calls by the case they are."""

    def __init__(self):
        self.orig = {k: getattr(K, k) for k in cs.MP4_STAGES}
        self.calls = {}
        self.phase = None

    def __enter__(self):
        for name in cs.MP4_STAGES:
            setattr(K, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(K, name, fn)

    def _keep(self, key, size, args):
        if size >= self.calls.get(key, (-1, None))[0]:
            self.calls[key] = (size, args)

    def _wrap(self, name):
        fn = self.orig[name]

        def run(*args):
            if name == "dequant_idct":
                self._keep(f"dequant_idct_{self.phase}", args[0].shape[0],
                           args)
            elif name == "motion_compensate":
                items = args[3]
                if self.phase == "encode" and args[2] is None:
                    case = "encode_prediction"
                elif self.phase == "decode":
                    case = ("decode_i" if int(items[0, 1]) < 0
                            else "decode_p")
                else:
                    case = None
                if case:
                    self._keep(f"motion_compensate_{case}",
                               items.shape[0], args)
            else:
                self._keep(name, int(args[{"motion_search": 1,
                                           "fdct_quant": 3}[name]]
                                     .shape[0]), args)
            return fn(*args)
        return run


def record_calls(frames: torch.Tensor) -> dict:
    with Calls() as rec:
        rec.phase = "encode"
        samples, sync, dsi, _ = mpeg4.encode(frames, cs.PRE_FPS)
        rec.phase = "decode"
        mpeg4.decode(samples, mpeg4.parse_vol(dsi), frames.device,
                     sync=sync)
    return {k: v[1] for k, v in rec.calls.items()}


def idct_row(lib, idct_shapes, case, args) -> dict:
    blocks, bidx, mb, out0 = args[:4]  # the mp4v path's H.263 form
    want = K.dequant_idct_plain(blocks, bidx, mb, out0.clone())
    out = out0.clone()

    def probe(v):
        def run():
            err = lib.probe_dequant_idct(
                v, blocks.data_ptr(), bidx.data_ptr(), blocks.shape[0],
                mb.data_ptr(), out.data_ptr(), stream())
            if err:
                raise RuntimeError(f"probe V1 variant {v}: cudaError {err}")
        return run

    names = ["original", "block", "copy"] + [
        f"bpb{b}_rows{r}" for b, r in idct_shapes]
    fns = {name: probe(v) for v, name in enumerate(names)}
    for name, fn in fns.items():
        if name == "copy":  # moves V1's bytes, computes something else
            continue
        out.copy_(out0)
        fn()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"V1 {name} at {case} differs from the "
                                 f"plain version")
    mine = out0.clone()
    if not torch.equal(K.dequant_idct(blocks, bidx, mb, mine), want):
        raise AssertionError(f"V1 at {case}: the port differs from the "
                             f"plain version")
    fns["port"] = lambda: K.dequant_idct(blocks, bidx, mb, mine)
    bound, by = cs.mp4_bound("dequant_idct", args)
    return {"kernel": "dequant_idct", "case": case,
            "blocks": int(blocks.shape[0]), "bound_ms": bound,
            "bound_by": by, "wide_share": cs.mp4_wide_share(args),
            "device_ms": in_turns(fns)}


def mc_row(lib, mc_shapes, case, args) -> dict:
    planes0, mb, res, items, width, height = args[:6]  # half-pel
    h16, w16 = planes0[0].shape[1:]
    want = [p.clone() for p in planes0]
    K.motion_compensate_plain(want, mb, res, items, width, height)
    planes = [p.clone() for p in planes0]

    def probe(v):
        def run():
            err = lib.probe_motion_compensate(
                v, *(p.data_ptr() for p in planes), h16, w16, mb.data_ptr(),
                mb.shape[1], None if res is None else res.data_ptr(),
                items.data_ptr(), items.shape[0], width, height, stream())
            if err:
                raise RuntimeError(f"probe V2 variant {v}: cudaError {err}")
        return run

    names = ["original", "copy"] + [
        f"rows{r}_mbs{m}" for r, m in mc_shapes]
    fns = {name: probe(v) for v, name in enumerate(names)}
    for name, fn in fns.items():
        if name == "copy":  # moves V2's bytes, computes something else
            continue
        for p, p0 in zip(planes, planes0):
            p.copy_(p0)
        fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(planes, want)):
            raise AssertionError(f"V2 {name} at {case} differs from the "
                                 f"plain version")
    mine = [p.clone() for p in planes0]
    K.motion_compensate(mine, mb, res, items, width, height)
    if not all(torch.equal(a, b) for a, b in zip(mine, want)):
        raise AssertionError(f"V2 at {case}: the port differs from the "
                             f"plain version")
    fns["port"] = lambda: K.motion_compensate(mine, mb, res, items, width,
                                              height)
    bound, by = cs.mp4_bound("motion_compensate", args)
    return {"kernel": "motion_compensate", "case": case,
            "items": int(items.shape[0]),
            "macroblocks": int(items.shape[0] * mb.shape[1]),
            "size": [width, height], "bound_ms": bound, "bound_by": by,
            "device_ms": in_turns(fns)}


def record_asp_calls() -> dict:
    """The largest call of each (stage, form) of V5 and V2 in a decode of
    the four Advanced Simple Profile fixtures."""
    with cs.Mp4Calls(hold=False, stages=cs.ASP_STAGES) as rec:
        for name in cs.ASP_FIXTURES:
            read_video_frames(str(cs.ASP_DATA / name), device="cuda")
    return {k: v[1] for k, v in rec.largest_form.items()}


def gm_row(lib, gm_shapes, name, form, args) -> dict:
    """V5 (name "bidir_compensate") or V2 at quarter-pel at one recorded
    call: PR 21's form, the copy form and the port's shapes held to the
    plain version and timed in turns beside the port's wrapper."""
    planes0, rec, res, items, ew, eh = args[:6]
    qpel = bool(args[6]) if len(args) > 6 else False
    rule = int(args[7]) if len(args) > 7 else 0
    h16, w16 = planes0[0].shape[1:]
    rec, items = rec.contiguous(), items.contiguous()
    res = None if res is None else res.contiguous()
    bidir = name == "bidir_compensate"
    want = [p.clone() for p in planes0]
    cs.MP4_PLAIN[name](want, rec, res, items, ew, eh, qpel, rule)
    planes = [p.clone() for p in planes0]
    fn = lib.probe_bidir_compensate if bidir else lib.probe_mc_qpel
    tail = (int(qpel), rule) if bidir else (rule,)

    def probe(v):
        def run():
            err = fn(v, *(p.data_ptr() for p in planes), h16, w16,
                     rec.data_ptr(), rec.shape[1],
                     None if res is None else res.data_ptr(),
                     items.data_ptr(), items.shape[0], ew, eh, *tail,
                     stream())
            if err:
                raise RuntimeError(f"probe {name} variant {v}: cudaError "
                                   f"{err}")
        return run

    names = (["original", "copy", "copy_nores", "copy_noref", "copy_store",
              "copy_store_unstaged"] + gm_shapes + ["staged", "unstaged"])
    fns = {label: probe(v) for v, label in enumerate(names)}
    for label, fn_v in fns.items():
        if label.startswith("copy"):  # moves bytes, computes nothing
            continue
        for p, p0 in zip(planes, planes0):
            p.copy_(p0)
        fn_v()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(planes, want)):
            raise AssertionError(f"{name} ({form}) {label} differs from the "
                                 f"plain version")
    mine = [p.clone() for p in planes0]
    kernel = getattr(K, name)
    kernel(mine, rec, res, items, ew, eh, qpel, rule)
    if not all(torch.equal(a, b) for a, b in zip(mine, want)):
        raise AssertionError(f"{name} ({form}): the port differs from the "
                             f"plain version")
    fns["port"] = lambda: kernel(mine, rec, res, items, ew, eh, qpel, rule)
    bound, by = cs.mp4_bound(name, args)
    return {"kernel": name, "case": form, "items": int(items.shape[0]),
            "macroblocks": int(items.shape[0] * rec.shape[1]),
            "size": [int(w16), int(h16)], "edge": [int(ew), int(eh)],
            "bound_ms": bound, "bound_by": by, "device_ms": in_turns(fns)}


def search_row(lib, search_shapes, case, args) -> dict:
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
    return {"kernel": "motion_search", "case": case,
            "items": int(items.shape[0]),
            "size": [width, height], "bound_ms": bound, "bound_by": by,
            "sass_bound_ms": cs.mp4_sass_bound(args),
            "device_ms": in_turns(fns)}


def fdct_row(lib, fdct_shapes, case, args) -> dict:
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
    return {"kernel": "fdct_quant", "case": case,
            "items": int(items.shape[0]),
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


SASS_KERNELS = ("dequant_idct_kernel", "motion_compensate_kernel",
                "motion_search_kernel", "fdct_quant_kernel",
                "motion_compensate_qpel_kernel", "bidir_compensate_kernel")
# opcodes listed in full: memory accesses (V2's byte loads and stores are
# the .U8 ones), barriers, shuffles, and V1's 64-bit multiplies
SASS_WATCH = ("LDG", "STG", "LDS", "STS", "BAR", "SHFL", "IMAD.WIDE",
              "IMAD.HI")


def sass(lib_path: Path, dump: Path = None) -> dict:
    """Instruction counts by opcode and registers of each instance of the
    port's kernels, from cuobjdump; with `dump`, each instance's SASS
    into a file there."""
    tool = Path(cuda_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    res = subprocess.run([str(tool), "-res-usage", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        head = body.split("\n", 1)[0].strip()
        name = next((k for k in SASS_KERNELS if k in head), None)
        if name is None:
            continue
        if dump:
            (dump / f"{head[:120]}.sass").write_text(body)
        full = collections.Counter(
            m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                body))
        ops = collections.Counter()
        for op, n in full.items():
            ops[op.split(".")[0]] += n
        after = res[res.find(head):] if head in res else ""
        usage = next((line.strip() for line in after.splitlines()
                      if "REG:" in line), "")
        regs = re.search(r"REG:(\d+)", usage)
        watch = {op: n for op, n in sorted(full.items())
                 if op.split(".")[0] in SASS_WATCH
                 or op.startswith(SASS_WATCH[-2:])}
        out[head] = {"instructions": sum(ops.values()),
                     "by_opcode": dict(ops.most_common(16)),
                     "watch": watch,
                     "registers": int(regs.group(1)) if regs else None,
                     "usage": usage[:200]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sass_dir", nargs="?", type=Path)
    ap.add_argument("--kernels", default=",".join(
        cs.MP4_STAGES + ("bidir_compensate", "motion_compensate_qpel")))
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    lib = load_probe()
    probe_shapes = shapes(lib)
    K.load()
    rows = {"motion_search": search_row, "fdct_quant": fdct_row,
            "dequant_idct": idct_row, "motion_compensate": mc_row}
    asp = [k for k in ASP_KERNELS if k[0] in kernels]
    if asp:
        calls = record_asp_calls()
        for _, name, form in asp:
            row = gm_row(lib, probe_shapes["gm"], name, form,
                         calls[(name, form)])
            print(json.dumps(row), flush=True)
        del calls
    for n, h, w in ((72, cs.PRE_H, cs.PRE_W), (48, cs.TRAIN_SIZE,
                                               cs.TRAIN_SIZE)):
        if not kernels & set(cs.MP4_STAGES):
            break
        calls = record_calls(clip(n, h, w, seed=100))
        for key in sorted(calls):
            name = next(k for k in cs.MP4_STAGES if key.startswith(k))
            if name not in kernels:
                continue
            case = key[len(name):].lstrip("_") or "largest"
            row = rows[name](lib, probe_shapes[name], case, calls[key])
            row["clip"] = [n, w, h]
            print(json.dumps(row), flush=True)
        del calls
    if "motion_search" in kernels:
        print(json.dumps({"rates": rates(lib)}), flush=True)
    if args.sass_dir:
        args.sass_dir.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"sass": sass(K.library_path(), args.sass_dir)}),
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
