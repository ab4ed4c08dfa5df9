#!/usr/bin/env python3
"""Time variants of the bilinear warp on one GPU beside the port's own
warp kernels (`faceoff_tpu_torch/csrc/warp.cu`) and PyTorch's calls for
the same work, to find what bounds the warp.

    python3 tools/warp_variants_torch.py

Builds `tools/warp_probe.cu` (its header lists the variants) with the
port's nvcc recipe, then at each of `chip_smoke.py`'s warp shapes times,
as CUDA-graph replays (`chip_smoke.device_ms`), every probe variant, the
port's kernel and the library call, twice, in the order given and then
reversed; the backward also on `chip_smoke.minify_inputs`, where every
tile of the port's backward splats directly. The direct variants are held to the plain version (1e-5
forward, 1e-4 backward); the others compute something else and are
timed only. Prints one JSON line per shape, then the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from faceoff_tpu_torch.ops import cuda_build, warp_cuda  # noqa: E402
from faceoff_tpu_torch.ops import warp as W  # noqa: E402

PROBE = Path(__file__).resolve().parent / "warp_probe.cu"
FORWARD = {"direct": 0, "direct_c3": 1, "loads_c3": 2, "stores_c3": 3,
           "copy": 4, "vec4": 5, "staged": 6, "window": 7}
BACKWARD = {"direct": 0, "stores": 1, "no_atomics": 2, "red6": 3,
            "hybrid": 4, "hybrid_noflush": 5, "hybrid_scalar": 6}
# variants that compute the warp or its gradients, held to the plain ones
CHECKED_FORWARD = ("direct", "direct_c3", "vec4", "staged", "window")
CHECKED_BACKWARD = ("direct", "red6", "hybrid", "hybrid_scalar")


def load_probe() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(PROBE, "warp_probe")))
    lib.probe_warp.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                               + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.probe_warp_backward.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                        + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def in_turns(fns: dict) -> dict:
    """Each function's device ms, timed in the order given and then in
    the reverse order: {name: [first, second]}."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(cs.device_ms(fns[k]))
    return times


def forward_row(lib, grids, shape, imgs, xs, ys):
    n, h, w, c, oh, ow = shape
    out = torch.empty((n, oh, ow, c), device=imgs.device)
    ref = W._bilinear_sample(imgs, xs, ys)

    def probe(v):
        def run():
            err = lib.probe_warp(v, imgs.data_ptr(), xs.data_ptr(),
                                 ys.data_ptr(), out.data_ptr(), n, h, w, c,
                                 oh, ow, stream())
            if err != 0:
                raise RuntimeError(f"probe variant {v}: cudaError {err}")
        return run

    errs, outs = {}, {}
    for name in CHECKED_FORWARD:
        out.zero_()
        probe(FORWARD[name])()
        torch.cuda.synchronize()
        outs[name] = out.clone()
        errs[name] = float((out - ref).abs().max())
        if not errs[name] <= cs.KERNEL_TOL:
            raise AssertionError(f"{name} {shape}: max |diff| {errs[name]}")
    port = warp_cuda.bilinear_warp(imgs, xs, ys)
    errs["port"] = float((port - ref).abs().max())
    # 0.0 where the port's kernel gives the direct gather's bits
    errs["port_vs_direct_c3"] = float((port - outs["direct_c3"]).abs().max())
    del outs
    nchw = imgs.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], -1)
    fns = {k: probe(v) for k, v in FORWARD.items()}
    fns["port"] = lambda: warp_cuda.bilinear_warp(imgs, xs, ys)
    fns["grid_sample"] = lambda: torch.nn.functional.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    row = {"pass": "forward", "grids": grids, "shape": list(shape),
           "max_abs_err": errs, "bound_ms": cs.bound_ms(*shape)[0],
           "device_ms": in_turns(fns)}
    row["share_tiles_shared"] = cs.shared_tile_share(xs, ys, h, w, c)
    return row


def backward_row(lib, grids, shape, imgs, xs, ys, g):
    n, h, w, c, oh, ow = shape
    d_img = torch.zeros_like(imgs)
    d_xs, d_ys = torch.empty_like(xs), torch.empty_like(ys)

    def probe(v):
        def run():
            if v != BACKWARD["no_atomics"]:
                d_img.zero_()
            err = lib.probe_warp_backward(
                v, imgs.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                g.data_ptr(), d_img.data_ptr(), d_xs.data_ptr(),
                d_ys.data_ptr(), n, h, w, c, oh, ow, stream())
            if err != 0:
                raise RuntimeError(f"probe backward {v}: cudaError {err}")
        return run

    leaves = [t.clone().requires_grad_(True) for t in (imgs, xs, ys)]
    ref = torch.autograd.grad(W._bilinear_sample(*leaves), leaves, g)
    errs = {}
    for name in CHECKED_BACKWARD:
        probe(BACKWARD[name])()
        torch.cuda.synchronize()
        errs[name] = max(float((a - b).abs().max())
                         for a, b in zip((d_img, d_xs, d_ys), ref))
    got = warp_cuda.bilinear_warp_backward(g, imgs, xs, ys)
    errs["port"] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    for name, err in errs.items():
        if not err <= cs.WARP_BWD_TOL:
            raise AssertionError(f"backward {name} {shape}: {err}")
    nchw = imgs.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], -1)
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    fns = {k: probe(v) for k, v in BACKWARD.items()}
    fns["port"] = lambda: warp_cuda.bilinear_warp_backward(g, imgs, xs, ys)
    fns["port_img_only"] = lambda: warp_cuda.bilinear_warp_backward(
        g, imgs, xs, ys, need_coords=False)
    fns["port_coords_only"] = lambda: warp_cuda.bilinear_warp_backward(
        g, imgs, xs, ys, need_imgs=False)
    fns["zeroing"] = lambda: torch.zeros_like(imgs)
    fns["grid_sampler_2d_backward"] = (
        lambda: torch.ops.aten.grid_sampler_2d_backward(
            g_nchw, nchw, grid, 0, 0, True, [True, True]))
    row = {"pass": "backward", "grids": grids, "shape": list(shape),
           "max_abs_err": errs,
           "bound_ms": cs.warp_bwd_bound_ms(*shape)[0],
           "device_ms": in_turns(fns)}
    row["share_tiles_shared"] = cs.shared_tile_share(xs, ys, h, w, c)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    lib = load_probe()
    warp_cuda.load()
    gen = torch.Generator().manual_seed(1)
    dev = cs.DEV
    for shape in [(1, 256, 256, 3, 256, 256), (16, 256, 256, 3, 256, 256),
                  (4, 192, 320, 3, 256, 256)]:
        args = [t.to(dev) for t in cs.warp_inputs(*shape, gen)]
        print(json.dumps(forward_row(lib, "affine", shape, *args)), flush=True)
    step = (cs.TRAIN_B * cs.TRAIN_T, cs.TRAIN_SIZE, cs.TRAIN_SIZE, 3,
            cs.TRAIN_SIZE, cs.TRAIN_SIZE)
    perturb = [t.to(dev) for t in cs.perturb_inputs(gen)]
    print(json.dumps(forward_row(lib, "perturbation", step, *perturb)),
          flush=True)
    affine = [t.to(dev) for t in cs.warp_inputs(*step, gen)]
    g = torch.randn((step[0], step[4], step[5], 3), generator=gen).to(dev)
    for grids, args in (("affine", affine), ("perturbation", perturb)):
        print(json.dumps(backward_row(lib, grids, step, *args, g)), flush=True)
    del affine, perturb, g
    minify = [t.to(dev) for t in cs.minify_inputs(gen)]
    n, _, _, c, oh, ow = cs.MINIFY_SHAPE
    g = torch.randn((n, oh, ow, c), generator=gen).to(dev)
    print(json.dumps(backward_row(lib, "minify", cs.MINIFY_SHAPE, *minify, g)),
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
