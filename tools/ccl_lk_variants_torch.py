#!/usr/bin/env python3
"""Time variants of kernels A (connected components, `csrc/ccl.cu`) and B
(pyramidal Lucas-Kanade, `csrc/lk.cu`) on one GPU beside the port's own,
to find what bounds them and to choose their shapes.

    python3 tools/ccl_lk_variants_torch.py [SASS_DIR]

Builds `tools/ccl_lk_probe.cu` (its header lists the variants; it includes
the port's two sources) with the port's nvcc recipe. Kernel A runs on:
  * detector  the skin detector's call: 16 closed skin masks of 1280x720
              frames drawn as `chip_smoke.py`'s preprocess phase draws its
              footage (video 0, frames 0-15);
  * detector_256  the detector on a clip at 256 px: 16 closed skin masks
              of 256 px face frames;
  * seed      the landmark seed's call: the skin mask of one 256 px face
              frame, cut to the detector's box;
  * full      every pixel of 16 x 720 x 1280 foreground: one component a
              frame, the worst case for per-pixel atomics;
  * random    16 x 720 x 1280 pixels foreground with probability 1/2: the
              most components;
  * serpentine  16 x 720 x 1280: every other row foreground, joined at
              alternate ends by one pixel, one component a frame: the
              longest union chains.
Every form (the port's first kernel as `original`, the tile shapes,
the port's wrapper, and the port on the masks at an odd address, which
takes the byte-wise loads) is first held to the plain version in every
`Components` field and in `largest`; on the serpentine, where the plain
version's label propagation would take minutes, to `original`. Kernel
B runs at 68 points (a synthetic face's landmarks) on two 256 px frames
of a face that moves; every form is held to the plain version (statuses
equal, points within chip_smoke.LK_TOL; bitwise reported). Then every
form is timed as CUDA-graph replays (`chip_smoke.device_ms`), twice: in
the order given, then reversed; the port's kernel A is also split by
launch (torch.profiler). Also prints the least time of one link of B's
chain (`probe_link_chain`), each point's links and B's latency bound,
and what `cuobjdump` shows of the port's kernels: instruction counts by
opcode and registers (with SASS_DIR, their SASS listings written
there). One JSON line a mask, one for B, one for the links, one for the
SASS, then the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
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
from faceoff_tpu_torch.ops import ccl_cuda as A  # noqa: E402
from faceoff_tpu_torch.ops import cuda_build  # noqa: E402
from faceoff_tpu_torch.ops import lk_cuda as B  # noqa: E402
from faceoff_tpu_torch.preprocess import imgproc  # noqa: E402
from faceoff_tpu_torch.preprocess.detectors import (DETECT_BATCH,  # noqa: E402
                                                    HeuristicDetector,
                                                    skin_mask)

_P, _I = ctypes.c_void_p, ctypes.c_int
SIZE = 256  # the clips' frames, which the seed and the tracker read


def load_probe() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cs.build_lk_probe()))
    lib.probe_ccl.argtypes = [_I] + [_P] * 8 + [_I] * 4 + [_P]
    lib.probe_ccl_shapes.argtypes = [_P, _I]
    lib.probe_lk.argtypes = ([_I] + [_P] * 5 + [_I] * 3
                             + [ctypes.c_float, ctypes.c_double] + [_P] * 6
                             + [_I, _P])
    lib.probe_lk_forms.argtypes = [_P, _I]
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def forms(lib):
    buf = (ctypes.c_int * 128)()
    n = lib.probe_ccl_shapes(buf, 32)
    shapes = [tuple(buf[2 * i: 2 * i + 2]) for i in range(n)]
    n = lib.probe_lk_forms(buf, 32)
    return shapes, [tuple(buf[2 * i: 2 * i + 2]) for i in range(n)]


def in_turns(fns: dict, reps: int = 10, inner: int = 5) -> dict:
    """Each function's device ms, in the order given, then reversed."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(cs.device_ms(fns[k], reps=reps, inner=inner))
    return times


def kernel_split(fn, n: int = 20) -> dict:
    """Device ms a call of each kernel `fn` launches (torch.profiler's
    CUDA events over n calls), by kernel name without its arguments."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us:
            name = re.sub(r"^void |\(.*$", "", e.key)
            out[name] = out.get(name, 0.0) + us / n / 1e3
    return out


def face_frames(n: int, seed: int):
    """n uint8 RGB frames (n, SIZE, SIZE, 3) on the card, a face drifting
    by about 2 px a frame over a grey textured background, and its
    landmarks (n, 68, 2) float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand((1, 1, SIZE // 16, SIZE // 16), generator=gen,
                       device="cuda") * 70 + 20
    bg = torch.nn.functional.interpolate(
        noise, size=(SIZE, SIZE), mode="bicubic", align_corners=False)[0, 0]
    bg = bg.clamp(0, 255).round().to(torch.uint8)[..., None].expand(
        SIZE, SIZE, 3)
    lms = np.stack([face_landmarks((SIZE * 0.5 + 2 * f, SIZE * 0.5 + f),
                                   SIZE * 0.27, 2 * f) for f in range(n)])
    return draw_faces(bg.expand(n, -1, -1, -1),
                      torch.from_numpy(lms.astype(np.float32)).cuda(),
                      (205, 165, 140)), lms.astype(np.float32)


def ccl_masks() -> dict:
    """The masks kernel A is timed on (see the module docstring)."""
    n, h, w = DETECT_BATCH, cs.PRE_H, cs.PRE_W
    frames = cs.pre_frames(cs.pre_scene(0), 0, n)
    out = {"detector": imgproc.morph_close(skin_mask(frames), 7)}
    del frames
    clip = face_frames(n, seed=5)[0]
    out["detector_256"] = imgproc.morph_close(skin_mask(clip), 7)
    frame = face_frames(1, seed=7)[0][0]
    box = HeuristicDetector(device="cuda").detect_batch(frame[None])[0]
    if box is None:
        raise AssertionError("seed: the detector found no face")
    x1, y1, x2, y2 = box
    out["seed"] = skin_mask(frame)[max(y1, 0):y2, max(x1, 0):x2][None]
    out["full"] = torch.full((n, h, w), 255, dtype=torch.uint8,
                             device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    out["random"] = (torch.rand((n, h, w), generator=gen, device="cuda")
                     < 0.5).to(torch.uint8) * 255
    serp = torch.zeros((n, h, w), dtype=torch.uint8, device="cuda")
    serp[:, 0::2, :] = 255
    odd = torch.arange(1, h, 2, device="cuda")
    serp[:, odd, torch.where((odd // 2) % 2 == 0, w - 1, 0)] = 255
    out["serpentine"] = serp
    return {k: v.contiguous() for k, v in out.items()}


def ccl_row(lib, shapes, name, masks) -> dict:
    b, h, w = masks.shape
    cap = b * ((h + 1) // 2) * ((w + 1) // 2)
    dev = masks.device
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    parent = torch.empty((cap,), dtype=torch.int32, device=dev)
    bits = torch.empty((cap,), dtype=torch.uint8, device=dev)
    stats = torch.empty((6, cap), dtype=torch.int32, device=dev)
    slot = torch.empty((b * h * w,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    table = torch.empty((7, cap), dtype=torch.int32, device=dev)

    def probe(v):
        def run():
            err = lib.probe_ccl(v, masks.data_ptr(), labels.data_ptr(),
                                parent.data_ptr(), bits.data_ptr(),
                                stats.data_ptr(), slot.data_ptr(),
                                count.data_ptr(), table.data_ptr(), cap, b,
                                h, w, stream())
            if err:
                raise RuntimeError(f"probe A variant {v}: cudaError {err}")
        return run

    names = ["original"] + [f"tile{th}x{tw}" for th, tw in shapes]
    fns = {nm: probe(v) for v, nm in enumerate(names)}
    held_to = "original" if name == "serpentine" else "plain"
    if held_to == "plain":
        want = A.connected_components_plain(masks)
    else:
        fns["original"]()
        want = A._table(labels.clone(), table[:, : int(count.item())].clone(),
                        b, h * w)
    for nm, fn in fns.items():
        labels.fill_(-2)
        fn()
        got = A._table(labels, table[:, : int(count.item())], b, h * w)
        wrong = [f for f, g, x in zip(got._fields, got, want)
                 if not torch.equal(g, x)]
        if wrong or not torch.equal(A.largest(got, b), A.largest(want, b)):
            raise AssertionError(f"A {nm} on {name} differs from the "
                                 f"{held_to} version in {wrong or 'largest'}")
    # the same masks at an odd address: the byte-wise mask loads and
    # label stores in place of the 16-bit and 8-byte ones
    odd = torch.empty(masks.numel() + 1, dtype=torch.uint8,
                      device=dev)[1:].view_as(masks)
    odd.copy_(masks)
    for form, m in (("port", masks), ("port_byte_loads", odd)):
        got = A.connected_components(m)
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            raise AssertionError(f"A: {form} on {name} differs from the "
                                 f"{held_to} version")
    fns["port"] = lambda: A.launch_kernel(masks)
    fns["port_byte_loads"] = lambda: A.launch_kernel(odd)
    n_bytes = masks.numel() * 5 + int(want.stats.shape[0]) * 7 * 8
    return {"kernel": "connected_components", "mask": name,
            "shape": [b, h, w], "components": int(want.stats.shape[0]),
            "held_to": held_to,
            "bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3,
            # the first form's serpentine takes long: fewer replays
            "device_ms": in_turns(fns, *((3, 2) if name == "serpentine"
                                         else ())),
            "port_split_ms": kernel_split(fns["port"])}


def lk_row(lib, lk_forms) -> dict:
    frames, lms = face_frames(2, seed=11)
    gray = imgproc.rgb_to_gray(frames)
    pa, pb = B.build_pyramid(gray[0]), B.build_pyramid(gray[1])
    pts = torch.from_numpy(lms[0]).cuda()
    want = B.pyr_lk_plain(pa, pb, pts)
    n = pts.shape[0]
    fwd, back = torch.empty_like(pts), torch.empty_like(pts)
    st = torch.empty((2, n), dtype=torch.uint8, device="cuda")
    fb = torch.empty((n,), dtype=torch.float32, device="cuda")

    def probe(v):
        def run():
            err = lib.probe_lk(
                v, pa.img.data_ptr(), pa.deriv.data_ptr(), pb.img.data_ptr(),
                pb.deriv.data_ptr(), pa.levels.data_ptr(), len(pa.sizes),
                pa.win, B.MAX_ITER, B.MIN_EIG, B.EPS ** 2, pts.data_ptr(),
                fwd.data_ptr(), st[0].data_ptr(), back.data_ptr(),
                st[1].data_ptr(), fb.data_ptr(), n, stream())
            if err:
                raise RuntimeError(f"probe B variant {v}: cudaError {err}")
        return run

    names = ["original"] + [f"kpl{k}_wpp{p}" for k, p in lk_forms]
    fns = {nm: probe(v) for v, nm in enumerate(names)}
    bitwise = {}
    for nm, fn in list(fns.items()) + [("port", None)]:
        if fn is None:
            got = B.pyr_lk(pa, pb, pts)
            g_st = (got.st_fwd, got.st_back)
            g_pts = (got.fwd, got.back, got.fb)
        else:
            fwd.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            g_st = (st[0].bool(), st[1].bool())
            g_pts = (fwd, back, fb)
        same = all(torch.equal(g, x) for g, x in zip(
            g_st, (want.st_fwd, want.st_back)))
        err = max((g - x).abs().max().item() for g, x in zip(
            g_pts, (want.fwd, want.back, want.fb)))
        if not same or not err <= cs.LK_TOL:
            raise AssertionError(f"B {nm}: statuses equal {same}, max "
                                 f"|diff| {err}")
        bitwise[nm] = all(torch.equal(g, x) for g, x in zip(
            g_pts, (want.fwd, want.back, want.fb)))
    fns["port"] = lambda: B.launch_kernel(pa, pb, pts)
    links = cs.lk_point_links(pa, pb, pts)
    return {"kernel": "pyr_lk", "points": n, "levels": len(pa.sizes),
            "bitwise": bitwise, "point_links": links,
            "device_ms": in_turns(fns)}


def sass(dump: Path = None) -> dict:
    """Instruction counts by opcode and registers of the port's kernels A
    and B, from cuobjdump; with `dump`, each kernel's SASS into a file
    there."""
    tool = Path(cuda_build.nvcc()).parent / "cuobjdump"
    out = {}
    for lib_path, names in (
            (A.library_path(), ("local_kernel", "border_kernel",
                                "roots_kernel", "label_kernel")),
            (B.library_path(), ("pyr_lk_kernel",))):
        text = subprocess.run([str(tool), "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        res = subprocess.run([str(tool), "-res-usage", str(lib_path)],
                             capture_output=True, text=True, check=True,
                             timeout=300).stdout
        blocks = re.split(r"\n\s*Function : ", text)
        for name in names:
            for i, body in enumerate(b for b in blocks
                                     if name in b.split("\n", 1)[0]):
                key = f"{name}#{i}"
                if dump:
                    (dump / f"{key}.sass").write_text(body)
                ops = collections.Counter(
                    m.group(1).split(".")[0] for m in re.finditer(
                        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]+)", body))
                head = body.split("\n", 1)[0].strip()
                after = res[res.find(head):] if head in res else ""
                usage = next((line.strip() for line in after.splitlines()
                              if "REG:" in line), "")
                regs = re.search(r"REG:(\d+)", usage)
                out[key] = {"function": head[:120],
                            "instructions": sum(ops.values()),
                            "by_opcode": dict(ops.most_common(14)),
                            "registers": int(regs.group(1)) if regs
                            else None, "usage": usage[:160]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    lib = load_probe()
    A.load()
    B.load()
    shapes, lk_forms = forms(lib)
    for name, masks in ccl_masks().items():
        print(json.dumps(ccl_row(lib, shapes, name, masks)), flush=True)
        del masks
        torch.cuda.empty_cache()
    row = lk_row(lib, lk_forms)
    print(json.dumps(row), flush=True)
    link = cs.lk_link_ms()
    print(json.dumps({"link_ms": link, "longest_point_links":
                      max(row["point_links"]),
                      "latency_bound_ms": max(row["point_links"]) * link}),
          flush=True)
    dump = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    if dump:
        dump.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"sass": sass(dump)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
