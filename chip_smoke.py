#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`faceoff_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing lines with their seconds:

  1. build   — compile the kernel sources (csrc/warp.cu, csrc/vq.cu) and
               the nvJPEG shim (csrc/jpeg.cu), one nvcc each, started
               together, into faceoff_tpu_torch/_build/, and load them;
  2. kernel  — the kernel against its plain torch version on the card at
               (1,256,256,3), (16,256,256,3), one case whose output
               grid differs from the source, and the training step's own
               call: 128 frames (b16 x T8) of 256x256x3 at the grids of
               `perturbation_grids`; max |diff| <= 1e-5; kernel, plain,
               grid_sample and bound times, and the share of 16x16 tiles
               that the backward would splat through shared memory on the
               same grids (the forward gathers every pixel);
  3. slice   — a SwapSession at the flagship widths (random weights from a
               seed), 256x256, serves two 16-frame streams (push, then
               push_many) in float32 without TF32; every pushed frame comes
               back finite, the warp kernel ran once per push, and the
               frames match the port's offline forward of the same
               composites (atol 2e-4, rtol 1e-3). Then the bfloat16 path
               is timed: frames/s, per-push latency and a per-stage split.
  4. vq      — the VQ kernels against their plain version at the training
               step's shapes (N=524288 and 131072 rows, D=64, K=512) and at
               K=4096 (the regime of the TPU's K-tiled kernels): indices
               equal except within the float32 rounding margin of a tie,
               quant an exact copy of the picked codes, counts exact, sums
               within the rounding bound of their row counts, and a second
               launch of the statistics on the same inputs bitwise equal to
               the first. Each row also prints how many rows the assignment left to its
               float32 re-score, its bound in the units it executes (a TF32
               and a bf16 tensor-core product) beside the float32
               CUDA-core bound, and the
               bytes the statistics move (x once, and their tables).
  5. warp_bwd — the warp's backward kernel against autograd through the
               plain version (1e-4) and timed beside
               grid_sampler_2d_backward: at (128,256,256,3) on affine
               grids and on the training step's perturbation grids, and
               at (16,768,768,3)->256x256 on a grid that shrinks 2.6-2.8x,
               where every tile takes the direct path; each row with its
               share of tiles on the shared-memory path.
  6. train   — the perceptual training step at full width: flagship
               ModelConfig, b16, T8, 256 px, random VGG16 LPIPS in bf16
               (as the JAX trainer builds it on its accelerator), Adam at
               lr 3e-4 with the one-cycle schedule, a resident corpus of
               16 synthetic videos x 24 frames; 2 warm-up and 5 timed bf16
               steps: step ms, frames/s, peak memory, the losses (finite;
               the MSE of one held batch, prepared before the steps, not
               higher after them) and the launch counts (2 VQ and 1 warp
               per step; each VQ launch is one assignment and one
               statistics kernel). With --profile, one more step under
               torch.profiler (the device's busy share, device time by
               operator and by kernel), then LPIPS and the VQVAE forward
               and backward alone at the step's shapes.
  7. train_check — a small configuration (channel 32, b2, T4, 64 px) takes
               3 float32 steps without TF32 (LPIPS in float32) on CUDA and
               on the CPU from the same weights and prepared batches;
               losses, parameters and codebooks must agree within the
               stated tolerances.
  8. trainer — the command line's main() (cli/train_faceoff_perceptual)
               in this process on PNG datasets written to disk: the corpus
               decoded and staged (timed, and equal to the frames written),
               then --resident_data at b16/T8/256, flagship widths, the
               one-cycle schedule: an unbroken 8-step run (timed: the
               trainer's frames/s over steps 2-6 beside the train phase's),
               a run validating and checkpointing every 3 steps, and a
               resume of that run's step-6 checkpoint to step 8, which must
               equal that run's own step 8 bit for bit and agree with the
               unbroken run within train_check's tolerances; metrics,
               checkpoints, sample streams and launch counts checked; a
               checkpoint's save and restore timed.
  9. jpeg    — the committed JPEG fixtures (4:2:0, 4:4:4) decoded by nvJPEG
               against cv2's decodes (max and mean |diff| in levels, within
               the stated tolerance), and a JPEG dataset of the trainer
               phase's size (16 videos x 24 frames at 256 px) staged by
               build_resident_corpus with nvJPEG decoding into the tensor
               on the card, every frame equal to its own decode.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}. Any failure
raises and exits non-zero; so does a machine without CUDA. It imports
torch, numpy, the standard library and faceoff_tpu_torch only.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.cli import train_faceoff_perceptual as trainer_cli
from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset
from faceoff_tpu_torch.data.resident import (build_resident_corpus,
                                             corpus_from_arrays,
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import (draw_face, face_landmarks,
                                              generate_dataset,
                                              synthetic_corpus)
from faceoff_tpu_torch.io import image as image_io
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.io.video import read_video_frames
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models.lpips import init_lpips
from faceoff_tpu_torch.ops import vq as V
from faceoff_tpu_torch.ops import vq_cuda
from faceoff_tpu_torch.ops import warp as W
from faceoff_tpu_torch.ops import warp_cuda
from faceoff_tpu_torch.ops.swap import prepare_swap_batch
from faceoff_tpu_torch.serve import SwapSession
from faceoff_tpu_torch.serve.streaming import _postnet_stream
from faceoff_tpu_torch.train.state import create_train_state, make_optimizer
from faceoff_tpu_torch.train.train_step import make_eval_step, make_train_step

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
KERNEL_TOL = 1e-5
STREAM_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_streaming.py
SIZE, FRAMES = 256, 16
DEV = "cuda"
U32 = 2.0 ** -24  # float32 unit roundoff
# the training phase: b16, T8, 256 px at the flagship widths
TRAIN_B, TRAIN_T, TRAIN_SIZE = 16, 8, 256
CORPUS_VIDEOS, CORPUS_FRAMES = 16, 24
WARMUP_STEPS, TIMED_STEPS = 2, 5
# the one-cycle schedule spans the run (5% warmup rounds to no warmup)
TRAIN_LR, TRAIN_N_ITER = 3e-4, WARMUP_STEPS + TIMED_STEPS
VQ_SHAPES = [(524288, 64, 512), (131072, 64, 512), (65536, 64, 4096)]
WARP_BWD_SHAPE = (128, 256, 256, 3, 256, 256)
MINIFY_SHAPE = (16, 768, 768, 3, 256, 256)
# the backward sums g w_tap of the taps that land on a source value per
# output tile, then adds the tiles' sums with global atomics: another order
# than autograd's, varying from run to run; float32 rounding of those terms
WARP_BWD_TOL = 1e-4


def say(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f} s  {msg}", flush=True)


def cuda_ms(fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Eager calls: median over `reps` of the CUDA-event time of `inner`
    back-to-back calls, per call. Where the host cannot keep the card fed,
    this is the host's dispatch time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Device time: `inner` calls captured in one CUDA graph, replayed
    `reps` times; median per call. No host dispatch between kernels; the
    inputs stay in L2 where they fit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# -- phase 2: the kernel against its plain version ------------------------


def warp_inputs(n, h, w, c, oh, ow, gen):
    """Images and affine sampling grids that reach past every border, with
    a share of exact integer coordinates and the edge cases -1, -0.5, 0,
    w-1, w-0.5 and w."""
    imgs = torch.rand((n, h, w, c), generator=gen) * 2 - 1
    ang = (torch.rand(n, generator=gen) - 0.5) * 0.6
    scale = 0.8 + 0.5 * torch.rand(n, generator=gen)
    shift = (torch.rand((n, 2), generator=gen) - 0.5) * 0.4 * torch.tensor(
        [w, h], dtype=torch.float32)
    m = torch.zeros((n, 2, 3))
    m[:, 0, 0] = torch.cos(ang) * scale * w / ow
    m[:, 0, 1] = -torch.sin(ang) * scale * w / oh
    m[:, 1, 0] = torch.sin(ang) * scale * h / ow
    m[:, 1, 1] = torch.cos(ang) * scale * h / oh
    m[:, 0, 2] = shift[:, 0] + (1 - scale) * w / 2
    m[:, 1, 2] = shift[:, 1] + (1 - scale) * h / 2
    xs, ys = W.affine_grid(m, oh, ow)
    xs, ys = xs.contiguous(), ys.contiguous()
    xs[:, ::7, ::5] = torch.round(xs[:, ::7, ::5])
    ys[:, ::7, ::5] = torch.round(ys[:, ::7, ::5])
    edges = torch.tensor([-1.0, -0.5, 0.0, w - 1.0, w - 0.5, float(w)])
    xs[:, 0, : len(edges)] = edges
    ys[:, 1, : len(edges)] = edges * (h / w)
    return imgs, xs, ys


def bound_ms(n, h, w, c, oh, ow):
    """Least time for the warp: each input read once, the output written
    once, over device memory; or 10 float32 ops per output value."""
    nbytes = 4 * (n * h * w * c + 2 * n * oh * ow + n * oh * ow * c)
    ops = 10 * n * oh * ow * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def perturb_inputs(gen):
    """The warp's inputs on the training step: B x T = 128 frames of
    256x256x3 in [0, 1], sampled at the grids `perturb_clip` builds from
    a fresh draw (eye centres near the middle of the frame)."""
    t, size = TRAIN_B * TRAIN_T, TRAIN_SIZE
    imgs = torch.rand((t, size, size, 3), generator=gen)
    eyes = size * (0.4 + 0.2 * torch.rand((t, 2), generator=gen))
    xs, ys, _ = W.perturbation_grids(W.draw_perturbation(gen, t), size,
                                     size, eyes)
    return imgs, xs.contiguous(), ys.contiguous()


def shared_tile_share(xs, ys, h, w, c):
    """The share of the backward's 16x16 output tiles that splat through
    shared memory (`warp_cuda.tile_footprints`); the others add their
    taps into d_imgs directly."""
    return float(warp_cuda.tile_footprints(xs, ys, h, w, c)[1].float().mean())


def minify_inputs(gen):
    """Images of 768x768x3 sampled into 256x256 grids that shrink them
    2.6-2.8x, rotated up to 0.03 rad about the centre, so that the grid
    stays inside the image: every 16x16 output tile reaches at least
    43x43 source pixels, more than the backward splats through shared
    memory."""
    n, h, w, c, oh, ow = MINIFY_SHAPE
    imgs = torch.rand((n, h, w, c), generator=gen)
    ang = (torch.rand(n, generator=gen) - 0.5) * 0.06
    s = 2.6 + 0.2 * torch.rand(n, generator=gen)
    cos, sin = torch.cos(ang) * s, torch.sin(ang) * s
    m = torch.zeros((n, 2, 3))
    m[:, 0, 0], m[:, 0, 1] = cos, -sin
    m[:, 1, 0], m[:, 1, 1] = sin, cos
    m[:, 0, 2] = w / 2 - (cos * ow / 2 - sin * oh / 2)
    m[:, 1, 2] = h / 2 - (sin * ow / 2 + cos * oh / 2)
    xs, ys = W.affine_grid(m, oh, ow)
    return imgs, xs.contiguous(), ys.contiguous()


def kernel_phase(t0):
    gen = torch.Generator().manual_seed(1)
    cases = [("affine", shape, lambda shape=shape: warp_inputs(*shape, gen))
             for shape in [(1, 256, 256, 3, 256, 256),
                           (16, 256, 256, 3, 256, 256),
                           (4, 192, 320, 3, 256, 256)]]
    cases.append(("perturbation", (TRAIN_B * TRAIN_T, TRAIN_SIZE, TRAIN_SIZE,
                                   3, TRAIN_SIZE, TRAIN_SIZE),
                  lambda: perturb_inputs(gen)))
    rows = []
    for grids, shape, make in cases:
        n, h, w, c, oh, ow = shape
        imgs, xs, ys = (t.to(DEV) for t in make())
        out = warp_cuda.bilinear_warp(imgs, xs, ys)
        torch.cuda.synchronize()
        ref = W._bilinear_sample(imgs, xs, ys)
        err = (out - ref).abs().max().item()
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp kernel {shape}: max |diff| {err}")
        frac_out = ((xs < 0) | (xs > w - 1)).float().mean().item()
        nchw = imgs.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], -1)

        def library():
            return torch.nn.functional.grid_sample(
                nchw, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True)

        def kernel():
            return warp_cuda.bilinear_warp(imgs, xs, ys)

        def plain():
            return W._bilinear_sample(imgs, xs, ys)

        b_ms, b_by = bound_ms(*shape)
        row = {
            "shape": list(shape),
            "grids": grids,
            "max_abs_err": err,
            "kernel_ms": device_ms(kernel),
            "plain_ms": device_ms(plain),
            "library_ms": device_ms(library),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "eager_kernel_ms": cuda_ms(kernel),
            "eager_plain_ms": cuda_ms(plain),
            "eager_library_ms": cuda_ms(library),
            "share_x_outside": frac_out,
            # the forward gathers every pixel; the backward on these grids
            # would splat this share of its tiles through shared memory
            "backward_share_tiles_shared": shared_tile_share(xs, ys, h, w, c),
        }
        rows.append(row)
        say("kernel", t0, json.dumps(row))
    return rows


# -- phase 3: the serving slice at full width -----------------------------


def make_streams(gen):
    """Two (src, tgt) streams of FRAMES synthetic faces each: frames as
    (H, W, 3) uint8 tensors on the card and (68, 2) float32 landmarks."""
    streams = []
    for s in range(2):
        src_f, src_l, tgt_f, tgt_l = [], [], [], []
        for i in range(FRAMES):
            ph = 2 * np.pi * i / FRAMES + s
            for frames, lms_list, center, scale, ang, skin in (
                (src_f, src_l, (120 + 6 * np.sin(ph), 128 + 4 * np.cos(ph)),
                 60.0, 5 * np.sin(ph), (205, 165, 135)),
                (tgt_f, tgt_l, (136 + 5 * np.cos(ph), 124 + 3 * np.sin(ph)),
                 52.0 + 2 * s, -4 * np.sin(ph), (150, 120, 200)),
            ):
                lms = face_landmarks(center, scale, ang)
                bg = (torch.rand((SIZE, SIZE, 3), generator=gen) * 60 + 20)
                img = draw_face(bg.to(torch.uint8).to(DEV), lms, skin)
                frames.append(img)
                lms_list.append(lms)
        streams.append((src_f, src_l, tgt_f, tgt_l))
    return streams


def serve_f32(t0, streams):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=DEV,
                  generator=torch.Generator().manual_seed(0))
    (a_sf, a_sl, a_tf, a_tl), (b_sf, b_sl, b_tf, b_tl) = streams
    say("slice", t0, "flagship VQVAE built, float32")

    # the main path: counts from 0 just before, read just after
    warp_cuda.launches = 0
    sess_a = SwapSession(model, height=SIZE, width=SIZE, device=DEV)
    out_a = [o for o in (sess_a.push(a_sf[i], a_sl[i], a_tf[i], a_tl[i])
                         for i in range(FRAMES)) if o is not None]
    out_a += sess_a.flush()
    sess_b = SwapSession(model, height=SIZE, width=SIZE, device=DEV)
    out_b = sess_b.push_many(b_sf, b_sl, b_tf, b_tl) + sess_b.flush()
    torch.cuda.synchronize()
    launches = warp_cuda.launches
    say("slice", t0, f"served 2 streams x {FRAMES} frames; warp launches "
        f"{launches}")
    if launches != 2 * FRAMES:
        raise AssertionError(f"{launches} warp launches for {2 * FRAMES} pushes")

    for name, outs, (sf, sl, tf, tl) in (("push", out_a, streams[0]),
                                         ("push_many", out_b, streams[1])):
        if len(outs) != FRAMES:
            raise AssertionError(f"{name}: {len(outs)} frames for {FRAMES}")
        got = torch.stack(outs)
        if got.shape != (FRAMES, SIZE, SIZE, 3) or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: bad frames {tuple(got.shape)}")
        with torch.no_grad():
            batch = prepare_swap_batch(
                torch.stack(sf), torch.as_tensor(np.stack(sl), device=DEV),
                torch.stack(tf), torch.as_tensor(np.stack(tl), device=DEV))
            offline, _ = model(batch["input"][None])
        ref = offline[0, ..., :3]
        err = (got - ref).abs()
        bad = (err > STREAM_TOL["atol"] + STREAM_TOL["rtol"] * ref.abs())
        say("slice", t0, f"{name}: streamed vs offline max |diff| "
            f"{err.max().item():.3e}, {int(bad.sum())} values outside "
            f"atol {STREAM_TOL['atol']} rtol {STREAM_TOL['rtol']}")
        if bad.any():
            raise AssertionError(f"{name}: streamed frames differ from offline")
    return launches


def serve_bf16(t0, streams):
    model = VQVAE(ModelConfig(), dtype=torch.bfloat16, device=DEV,
                  generator=torch.Generator().manual_seed(0))
    sf, sl, tf, tl = streams[0]
    sess = SwapSession(model, height=SIZE, width=SIZE, device=DEV)
    for r in range(8):  # warm-up, and the pipeline fills
        i = r % FRAMES
        sess.push(sf[i], sl[i], tf[i], tl[i])
    torch.cuda.synchronize()
    lat = []
    for r in range(3 * FRAMES):
        i = r % FRAMES
        t = time.perf_counter()
        out = sess.push(sf[i], sl[i], tf[i], tl[i])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        if out is None or not torch.isfinite(out).all():
            raise AssertionError("bf16 push returned no finite frame")
    n = 4 * FRAMES
    t = time.perf_counter()
    for r in range(n):
        i = r % FRAMES
        sess.push(sf[i], sl[i], tf[i], tl[i])
    torch.cuda.synchronize()
    fps = n / (time.perf_counter() - t)
    result = {"frames_per_s": fps, "push_ms_p50": statistics.median(lat),
              "push_ms_max": max(lat)}
    say("slice", t0, "bf16 " + json.dumps(result))

    # per-stage device time of one push, batch 1
    lms = (torch.as_tensor(sl[0][None], device=DEV),
           torch.as_tensor(tl[0][None], device=DEV))
    src, tgt = sf[0][None], tf[0][None]
    x = prepare_swap_batch(src, lms[0], tgt, lms[1])["input"]
    frame = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        enc_b, enc_t = model._encode_frames(frame)
        bufs_b = [torch.zeros_like(enc_b[:, :, None]).expand(-1, -1, 2, -1, -1)
                  for _ in range(model.temporal_postnet_layers)]
        bufs_t = [torch.zeros_like(enc_t[:, :, None]).expand(-1, -1, 2, -1, -1)
                  for _ in range(model.temporal_postnet_layers)]
        _, pb = _postnet_stream(model.conv3d_encoded_b, bufs_b, enc_b, 5, 10**9)
        _, pt = _postnet_stream(model.conv3d_encoded_t, bufs_t, enc_t, 5, 10**9)
        quant_t, quant_b = model._encode_quantized(pb, pt)[:2]
        stages = {
            "geometry": lambda: prepare_swap_batch(src, lms[0], tgt, lms[1]),
            "encode": lambda: model._encode_frames(frame),
            "postnets": lambda: (
                _postnet_stream(model.conv3d_encoded_b, bufs_b, enc_b, 5, 10**9),
                _postnet_stream(model.conv3d_encoded_t, bufs_t, enc_t, 5, 10**9)),
            "quantize": lambda: model._encode_quantized(pb, pt),
            "decode": lambda: model._decode(quant_t, quant_b),
        }
        split = {k: device_ms(fn, reps=9, inner=5) for k, fn in stages.items()}
        eager = {k: cuda_ms(fn, reps=9, inner=5) for k, fn in stages.items()}
    say("slice", t0, "bf16 stage device ms " + json.dumps(split))
    say("slice", t0, "bf16 stage eager ms " + json.dumps(eager))
    return result, split


# -- phase 4: the VQ kernels against their plain version ---------------


def assign_ops_s(n, d, k, flagged):
    """Seconds of arithmetic of the assignment as the kernel does it on
    the tensor cores: x_hi e_hi, a TF32 product of 2 N D K operations, and
    the two cross terms, one bf16 product of depth 2 D (4 N D K); then the
    flagged rows' float32 re-score, 2 D K operations each, on the CUDA
    cores."""
    return (2 * n * d * k / TF32_FLOPS + 4 * n * d * k / BF16_FLOPS
            + flagged * 2 * d * k / F32_FLOPS)


def vq_bound_ms(n, d, k, flagged):
    """Least time for assignment + statistics: x, E read once; idx, quant,
    counts, sums written once; the assignment's operations
    (`assign_ops_s`) and N D float32 adds for the sums."""
    nbytes = 4 * (2 * n * d + 2 * d * k + n + k)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = assign_ops_s(n, d, k, flagged) + n * d / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def assign_bound_ms(n, d, k, flagged):
    nbytes = 4 * (2 * n * d + d * k + n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = assign_ops_s(n, d, k, flagged)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def assign_bound_f32_ms(n, d, k):
    """The same scores as float32 FMA on the CUDA cores: the bound of the
    earlier one-row-per-thread kernel's arithmetic."""
    return 2 * n * d * k / F32_FLOPS * 1e3


def stats_bound_ms(n, d, k):
    nbytes = 4 * (n * d + n + k + d * k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n * d / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def stats_bytes_read(n, d, k):
    """Bytes the statistics kernels move by their design: x once, idx
    twice (the count and the placement), the sorted row ids written and
    read, the sort segments' prefixes written and read, and the chunks'
    partial sums written and read; beside them, x alone. The segment
    count is `csrc/vq.cu` stats_segments'."""
    segments = max(1, min(-(-n // 512), 1024, (1 << 22) // k))
    chunks = -(-n // 128) + k
    return {"stats_bytes_read": 4 * (n * d + 2 * n + 2 * n + 2 * segments * k
                                     + 2 * chunks * d + 3 * k),
            "stats_x_bytes": 4 * n * d}


def check_vq(x, e, out):
    """Hold vq_assign's outputs against the plain version on the same
    inputs; returns a dict of what was compared.

    Indices: a float32 dot product of D terms is within D u sum|x_d e_d|
    of the exact value, so the kernel's and the plain version's scores of
    one code differ by at most margin = 2 (D + 1) u (|x| @ |E| + ||E||^2/2)
    (u = 2^-24; the +1 covers the half-norm's subtraction). A row may
    pick another code than the plain version only where the plain
    version's two best scores lie within that row's margin, and the
    kernel's pick must score within the margin of the best.
    Quant: an exact copy of E[:, idx]. Counts: exactly the rows per code
    of the kernel's own indices. Sums: against the plain sums of the same
    indices, within the rounding bound of two summations of c_k terms,
    2 c_k u sum|x| per entry."""
    idx, quant, counts, sums = out
    n, d = x.shape
    k = e.shape[1]
    ref_idx, _, _, _ = V.vq_assign_plain(x, e)
    hn = 0.5 * (e * e).sum(0)
    scores = x @ e - hn
    margin = 2 * (d + 1) * U32 * (x.abs() @ e.abs() + hn).amax(1)
    top2 = scores.topk(2, dim=1).values
    li = idx.long()
    picked = scores.gather(1, li[:, None])[:, 0]
    differ = idx != ref_idx
    near = (top2[:, 0] - top2[:, 1]) <= margin
    shortfall = top2[:, 0] - picked
    if bool((differ & ~near).any()) or bool((shortfall > margin).any()):
        raise AssertionError(
            f"vq {n}x{d}x{k}: {int(differ.sum())} rows differ, "
            f"{int((differ & ~near).sum())} outside the tie margin; worst "
            f"shortfall {float(shortfall.max()):.3e}")
    if not torch.equal(quant, e.t()[li]):
        raise AssertionError(f"vq {n}x{d}x{k}: quant is not E[:, idx]")
    own_counts, own_sums = V.vq_stats(x, idx, k)
    if not torch.equal(counts, own_counts) or counts.sum().item() != n:
        raise AssertionError(f"vq {n}x{d}x{k}: counts differ")
    _, abs_sums = V.vq_stats(x.abs(), idx, k)
    tol = 2 * counts[None, :] * U32 * abs_sums + 1e-30
    err = (sums - own_sums).abs()
    if bool((err > tol).any()):
        raise AssertionError(
            f"vq {n}x{d}x{k}: sums off by {float(err.max()):.3e} "
            f"(worst share of its bound {float((err / tol).max()):.3f})")
    return {"rows_differing_from_plain": int(differ.sum()),
            "rows_within_tie_margin": int(near.sum()),
            "max_score_shortfall": float(shortfall.max()),
            "max_sums_err_share_of_bound": float((err / tol).max()),
            # quant and counts are exact; the sums carry the error
            "max_abs_err": float(err.max())}


def vq_phase(t0):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(3)
    rows = []
    for n, d, k in VQ_SHAPES:
        x = torch.randn((n, d), generator=gen, device=DEV)
        e = torch.randn((d, k), generator=gen, device=DEV)
        out = vq_cuda.vq_assign(x, e)
        torch.cuda.synchronize()
        row = {"shape": [n, d, k], **check_vq(x, e, out)}
        idx = out[0]
        # the statistics add in a fixed order: a second launch on the same
        # inputs gives the same bits
        again = vq_cuda.code_stats(x, idx, k)
        if not (torch.equal(again[0], out[2]) and torch.equal(again[1], out[3])):
            raise AssertionError(f"vq {n}x{d}x{k}: two launches of the "
                                 f"statistics on the same inputs differ")
        # rows whose split-TF32 pick could not be certified (re-scored in
        # float32); the same inputs give the same count
        flagged = int(vq_cuda.assign_rows_flagged(x, e)[2])
        b_ms, b_by = vq_bound_ms(n, d, k, flagged)
        a_ms, a_by = assign_bound_ms(n, d, k, flagged)
        s_ms, s_by = stats_bound_ms(n, d, k)
        idx64 = idx.long()
        xt = x.t().contiguous()

        def index_add():
            return torch.zeros((d, k), device=DEV).index_add_(1, idx64, xt)

        # device times are CUDA-graph replays (no host dispatch: the step
        # is device-bound, so the host's share is not the kernels');
        # eager times beside them; the plain versions synchronise inside
        # and are timed eagerly
        reps = dict(reps=7, inner=3, warmup=2)
        graph = dict(reps=7, inner=3)
        row.update({
            "kernel_ms": device_ms(lambda: vq_cuda.vq_assign(x, e), **graph),
            "plain_ms": cuda_ms(lambda: V.vq_assign_plain(x, e), **reps),
            "library_ms": device_ms(lambda: x @ e, **graph),
            "bound_ms": b_ms, "bound_by": b_by,
            "assign_ms": device_ms(lambda: vq_cuda.assign_rows(x, e), **graph),
            "assign_plain_ms": cuda_ms(
                lambda: V.codebook_lookup(V.nearest_code(x, e), e), **reps),
            "assign_bound_ms": a_ms, "assign_bound_by": a_by,
            "assign_bound_f32_ms": assign_bound_f32_ms(n, d, k),
            "flagged_rows": flagged,
            "stats_ms": device_ms(lambda: vq_cuda.code_stats(x, idx, k),
                                  **graph),
            "stats_plain_ms": cuda_ms(lambda: V.vq_stats(x, idx, k), **reps),
            "stats_library_ms": device_ms(index_add, **graph),
            "stats_bound_ms": s_ms, "stats_bound_by": s_by,
            **stats_bytes_read(n, d, k),
            "eager_kernel_ms": cuda_ms(lambda: vq_cuda.vq_assign(x, e), **reps),
            "eager_library_ms": cuda_ms(lambda: x @ e, **reps),
            "eager_assign_ms": cuda_ms(lambda: vq_cuda.assign_rows(x, e),
                                       **reps),
            "eager_stats_ms": cuda_ms(lambda: vq_cuda.code_stats(x, idx, k),
                                      **reps),
            "eager_stats_library_ms": cuda_ms(index_add, **reps),
            "codes_used": int((out[2] > 0).sum()),
            "largest_code_share": float(out[2].max() / n),
        })
        rows.append(row)
        say("vq", t0, json.dumps(row))
        del x, e, out, idx, idx64, xt
        torch.cuda.empty_cache()
    return rows


# -- phase 5: the warp's backward kernel ----------------------------------


def warp_bwd_bound_ms(n, h, w, c, oh, ow):
    """g, imgs, xs, ys read once; d_imgs, d_xs, d_ys written once; about
    30 float32 operations per output value. The zeroing of d_imgs that
    the scatter with atomics needs is the design's cost, not the
    function's, and is not in the bound."""
    nbytes = 4 * (n * oh * ow * c + 2 * n * h * w * c + 4 * n * oh * ow)
    ops = 30 * n * oh * ow * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def warp_bwd_row(t0, grids, shape, imgs, xs, ys, g):
    n, h, w, c, oh, ow = shape
    got = warp_cuda.bilinear_warp_backward(g, imgs, xs, ys)
    torch.cuda.synchronize()
    leaves = [t.clone().requires_grad_(True) for t in (imgs, xs, ys)]
    out = W._bilinear_sample(*leaves)
    ref = torch.autograd.grad(out, leaves, g, retain_graph=True)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    say("warp_bwd", t0, "%s %s: max |kernel - autograd| d_imgs %.3e d_xs "
        "%.3e d_ys %.3e (limit %g)" % (grids, shape, *errs, WARP_BWD_TOL))
    if not max(errs) <= WARP_BWD_TOL:
        raise AssertionError(f"warp backward differs from autograd: {errs}")
    del got

    nchw = imgs.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], -1)
    g_nchw = g.permute(0, 3, 1, 2).contiguous()

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(
            g_nchw, nchw, grid, 0, 0, True, [True, True])

    b_ms, b_by = warp_bwd_bound_ms(*shape)
    row = {
        "shape": list(shape),
        "grids": grids,
        "max_abs_err": max(errs),
        "kernel_ms": device_ms(
            lambda: warp_cuda.bilinear_warp_backward(g, imgs, xs, ys)),
        "plain_ms": cuda_ms(lambda: torch.autograd.grad(
            out, leaves, g, retain_graph=True), reps=7, inner=3),
        "library_ms": device_ms(library),
        "bound_ms": b_ms, "bound_by": b_by,
        # the design's own cost beside the bound: zeroing d_imgs
        "zeroing_ms": device_ms(lambda: torch.zeros_like(imgs)),
        "zeroing_bound_ms": 4 * n * h * w * c / HBM_BYTES_PER_S * 1e3,
        "share_tiles_shared": shared_tile_share(xs, ys, h, w, c),
    }
    say("warp_bwd", t0, json.dumps(row))
    return row


def warp_bwd_phase(t0):
    gen = torch.Generator().manual_seed(4)
    step = (TRAIN_B * TRAIN_T, TRAIN_SIZE, TRAIN_SIZE, 3, TRAIN_SIZE,
            TRAIN_SIZE)
    cases = [("affine", WARP_BWD_SHAPE,
              lambda: warp_inputs(*WARP_BWD_SHAPE, gen)),
             ("perturbation", step, lambda: perturb_inputs(gen)),
             ("minify", MINIFY_SHAPE, lambda: minify_inputs(gen))]
    rows = []
    for grids, shape, make in cases:
        n, h, w, c, oh, ow = shape
        imgs, xs, ys = (t.to(DEV) for t in make())
        g = torch.randn((n, oh, ow, c), generator=gen).to(DEV)
        rows.append(warp_bwd_row(t0, grids, shape, imgs, xs, ys, g))
        del imgs, xs, ys, g
        torch.cuda.empty_cache()
    if rows[-1]["share_tiles_shared"] != 0.0:
        raise AssertionError("the minifying grid put tiles on the shared-"
                             f"memory path: {rows[-1]['share_tiles_shared']}")
    return rows


# -- phase 6: the training step at full width ----------------------------


def zero_counts():
    vq_cuda.assign_launches = vq_cuda.stats_launches = 0
    warp_cuda.launches = warp_cuda.backward_launches = 0


def read_counts():
    return {"vq_assign": vq_cuda.assign_launches,
            "vq_stats": vq_cuda.stats_launches,
            "warp": warp_cuda.launches,
            "warp_backward": warp_cuda.backward_launches}


def train_phase(t0, profile):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # the bf16 step; as PyTorch sets it
    frames, lms, n_frames = synthetic_corpus(
        CORPUS_VIDEOS, CORPUS_FRAMES, TRAIN_SIZE, seed=3, device=DEV)
    corpus = corpus_from_arrays(frames, lms, n_frames, device=DEV)
    del frames
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=DEV,
                  generator=torch.Generator().manual_seed(0))
    lpips = init_lpips(torch.Generator().manual_seed(1), device=DEV)
    opt = make_optimizer(model.parameters(), TRAIN_LR, "cycle",
                         n_iter=TRAIN_N_ITER)
    state = create_train_state(model, opt)
    prepare = make_resident_prepare(corpus, TRAIN_B, TRAIN_T)
    step = make_train_step(model, lpips=lpips, prepare_fn=prepare)
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}
    # a held batch: each step samples other clips, so the steps' own MSE
    # moves with the clips; the held batch's MSE shows what training did
    with torch.no_grad():
        held = prepare(torch.Generator(device=DEV).manual_seed(11),
                       corpus.frames, corpus.landmarks)
    evaluate = make_eval_step(model)
    held_before = evaluate(state, held)[1]["mse"].item()
    torch.cuda.synchronize()
    say("train", t0, f"corpus {corpus.n_videos} videos x "
        f"{corpus.frames.shape[1]} frames, {corpus.nbytes / 2**20:.1f} MiB "
        f"on the card; flagship VQVAE, LPIPS-VGG16 built")

    # the main path: counts from 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, raw, seed=0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
        say("train", t0, f"step {i}: {times[-1]:.2f} ms "
            + json.dumps(losses[-1]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_steps = WARMUP_STEPS + TIMED_STEPS
    step_ms = statistics.median(times[WARMUP_STEPS:])
    held_after = evaluate(state, held)[1]["mse"].item()
    result = {
        "step_ms_median": step_ms,
        "step_ms": times,
        "frames_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
        "max_memory_allocated_bytes": peak,
        "launches": counts,
        "held_batch_mse_before": held_before,
        "held_batch_mse_after": held_after,
    }
    say("train", t0, json.dumps(result))
    for m in losses:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite losses {m}")
    if not held_after <= held_before:
        raise AssertionError(
            f"the held batch's MSE rose over {n_steps} steps: "
            f"{held_before} -> {held_after}")
    if (counts["vq_assign"] != 2 * n_steps
            or counts["vq_stats"] != 2 * n_steps
            or counts["warp"] != n_steps):
        raise AssertionError(f"launches {counts} for {n_steps} steps")
    if profile:
        result["profile"] = profile_step(t0, step, state, raw)
        result["modules"] = module_split(t0, model, lpips, held)
    return result, counts


def profile_step(t0, step, state, raw):
    """One more step under torch.profiler: the device's busy share of the
    step's wall time, device time by operator (the time of the kernels
    each aten operator launched itself) and by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, raw, seed=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    averages = prof.key_averages()
    # kernels, copies and fills: the events that ran on the card
    kernels = sorted((e for e in averages if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in averages if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def rows(events, n, width):
        return [{"name": e.key[:width], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in events[:n]]

    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "ops": rows(ops, 25, 60), "kernels": rows(kernels, 15, 160)}
    say("profile", t0, json.dumps(out))
    return out


def module_split(t0, model, lpips, batch):
    """Forward + backward of the VQVAE and of LPIPS alone at the step's
    shapes, bf16 autocast as in the step (CUDA events, median of 5): which
    module the step's device time belongs to. The VQVAE runs in
    evaluation mode here, so the codebooks do not move."""
    gt = batch["gt"].reshape(-1, *batch["gt"].shape[2:])
    pred = gt.detach().clone().requires_grad_(True)

    def lpips_step():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = lpips(gt, pred)
        loss.backward()

    def model_step():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            dec, lat = model(batch["input"])
            loss = dec.to(torch.float32).square().mean() + lat
        loss.backward()

    out = {"lpips_fwd_bwd_ms": cuda_ms(lpips_step, reps=5, inner=1),
           "vqvae_fwd_bwd_ms": cuda_ms(model_step, reps=5, inner=1)}
    model.zero_grad(set_to_none=True)
    say("profile", t0, json.dumps(out))
    return out


# -- phase 7: a small step on CUDA against the same step on the CPU -------


CHECK_CFG = ModelConfig(channel=32)
CHECK_B, CHECK_T, CHECK_SIZE, CHECK_STEPS, CHECK_LR = 2, 4, 64, 3, 3e-4


def train_check_phase(t0):
    """Float32 without TF32 on both devices, the same weights (drawn on the
    CPU from one seed) and the same prepared batches (made once on the
    CPU). Tolerances: losses 1e-3 relative (float32 convolutions summed in
    another order by cuDNN and by the CPU); Adam moves an entry by about
    lr per step, and by up to 2 lr against the other device's where a
    gradient is at rounding level and its sign flips, so every parameter
    must agree within 2 lr per step, and 99% of entries within 1e-5;
    codebooks within 1e-3 (EMA statistics of the same assignments)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames, lms, n_frames = synthetic_corpus(3, 8, CHECK_SIZE, seed=6)
    corpus = corpus_from_arrays(frames, lms, n_frames, device="cpu")
    prepare = make_resident_prepare(corpus, CHECK_B, CHECK_T)
    gen = torch.Generator().manual_seed(7)
    batches = [prepare(gen, corpus.frames, corpus.landmarks)
               for _ in range(CHECK_STEPS)]
    runs = {}
    for dev in ("cpu", DEV):
        model = VQVAE(CHECK_CFG, dtype=torch.float32, device=dev,
                      generator=torch.Generator().manual_seed(8))
        lpips = init_lpips(torch.Generator().manual_seed(9), device=dev,
                           dtype=torch.float32)
        opt = make_optimizer(model.parameters(), CHECK_LR, "cycle",
                             n_iter=100)
        state = create_train_state(model, opt)
        step = make_train_step(model, lpips=lpips,
                               compute_dtype=torch.float32)
        before = (vq_cuda.assign_launches, vq_cuda.stats_launches)
        losses = []
        for batch in batches:
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            losses.append({k: float(v) for k, v in m.items()})
        after = (vq_cuda.assign_launches, vq_cuda.stats_launches)
        if dev != "cpu" and any(a - b != 2 * CHECK_STEPS
                                for a, b in zip(after, before)):
            raise AssertionError("the CUDA check step did not use the VQ kernels")
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                              model.state_dict().items()},
                     {n for n, _ in model.named_parameters()})
    (l_cpu, sd_cpu, names), (l_gpu, sd_gpu, _) = runs["cpu"], runs[DEV]
    loss_err = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                   for a, b in zip(l_gpu, l_cpu) for k in a)
    param_diffs = torch.cat([(sd_gpu[k] - sd_cpu[k]).abs().ravel()
                             for k in names])
    cb_err = max(float((sd_gpu[k] - sd_cpu[k]).abs().max())
                 for k in sd_cpu if k not in names)
    result = {"max_loss_rel_err": loss_err,
              "max_param_diff": float(param_diffs.max()),
              "share_params_within_1e-5": float((param_diffs <= 1e-5)
                                                .float().mean()),
              "max_codebook_diff": cb_err,
              "losses_cuda": l_gpu, "losses_cpu": l_cpu}
    say("train_check", t0, json.dumps(result))
    if not (loss_err <= 1e-3
            and result["max_param_diff"] <= 2 * CHECK_LR * CHECK_STEPS + 1e-6
            and result["share_params_within_1e-5"] >= 0.99
            and cb_err <= 1e-3):
        raise AssertionError("CUDA and CPU training steps disagree")
    return result


# -- phase 8: the trainer, through the command line, on a dataset on disk -


TRAINER_VIDEOS, TRAINER_FRAMES, VAL_VIDEOS, VAL_FRAMES = 16, 24, 4, 12
TRAINER_STEPS, TRAINER_RESUME_AT, TRAINER_VALIDATE_AT = 8, 6, 3
# steps whose records time the loop: (first, last)
TRAINER_TIMED = (2, 6)


def _records(path):
    with open(path) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def _run_dir(root: Path, stem: str) -> Path:
    """The directory the CLI made from `stem` and its random run suffix."""
    found = sorted(root.glob(f"{stem}_*"))
    if len(found) != 1:
        raise AssertionError(f"expected one {stem}_* directory, got {found}")
    return found[0]


def _compare(run_a, run_b, rec_a, rec_b, steps):
    """train_check's measures between two CLI runs: the largest relative
    difference of their losses over `steps`, of their parameters at the
    end (largest, and the share within 1e-5) and of their codebook
    buffers; and whether all of these are bitwise equal."""
    sd_a = {k: v.detach().cpu() for k, v in
            run_a.state.model.state_dict().items()}
    sd_b = {k: v.detach().cpu() for k, v in
            run_b.state.model.state_dict().items()}
    names = {n for n, _ in run_a.state.model.named_parameters()}
    diffs = torch.cat([(sd_a[k] - sd_b[k]).abs().ravel() for k in names])
    keys = ("loss", "mse", "latent", "perceptual", "lr")
    return {
        "bitwise_equal": all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
        and all(rec_a[s][k] == rec_b[s][k] for s in steps for k in keys),
        "max_loss_rel_err": max(
            abs(rec_a[s][k] - rec_b[s][k]) / max(abs(rec_b[s][k]), 1e-12)
            for s in steps for k in keys),
        "max_param_diff": float(diffs.max()),
        "share_params_within_1e-5": float((diffs <= 1e-5).float().mean()),
        "max_codebook_diff": max(float((sd_a[k] - sd_b[k]).abs().max())
                                 for k in sd_a if k not in names),
        # |a - b| / max(1, |b|): the EMA sums (embed_avg) reach 1e4 and
        # more at the flagship's 524288 rows a step, where one float32
        # step is already 2^-8; 1e-3 absolute below magnitude 1
        "max_codebook_scaled_diff": max(
            float(((sd_a[k] - sd_b[k]).abs() / sd_b[k].abs().clamp_min(1))
                  .max()) for k in sd_a if k not in names),
        "codebook_magnitude": max(float(sd_b[k].abs().max())
                                  for k in sd_b if k not in names),
    }


def trainer_phase(t0, work: Path):
    """The CLI twin's main() in this process on the card, on PNG datasets
    written by `generate_dataset`: --resident_data at b16, T8, 256 px,
    flagship widths, the one-cycle schedule over 8 steps (--epoch 8, one
    step an epoch). Three runs:

      U  8 steps, validation only at the end (never: 1000 steps), timed;
      V  8 steps validating and checkpointing every 3 steps (3, 6, 8);
      R  a copy of V's checkpoints up to step 6, resumed with --ckpt
         latest to step 8.

    Checks: a finite metrics line per step; at most `keep` checkpoints;
    V's sample streams read back with the frames and shape written; R
    reaches step 8; R equals V, the same run continued without a break,
    bit for bit at step 8 (parameters, codebook buffers, and the losses
    and learning rate of steps 7 and 8: every kernel of the step adds in
    a fixed order, so a resume that restores all of the state changes
    nothing); R agrees with U, a separate run without a break, within
    train_check's tolerances (losses within 1e-3 relative, parameters
    within 2 lr a step with 99 % within 1e-5, the codebook buffers within
    1e-3 of their magnitude where it exceeds 1, since the EMA sums are
    large at the flagship's size); the corpus decoded from disk equals the
    frames written. Reported beside it: U against V. Prints the trainer's
    frames/s over steps 2-6 from U's records: each record's time is taken
    after its step was launched, and the loop reads the metrics of every
    epoch (here one step) at the epoch's end, so the span from record 2
    to record 6 covers four steps that each end in a read of a metric."""
    data, val = work / "data", work / "val"
    t = time.perf_counter()
    generate_dataset(str(data), TRAINER_VIDEOS, TRAINER_FRAMES, TRAIN_SIZE,
                     seed=5, device=DEV)
    generate_dataset(str(val), VAL_VIDEOS, VAL_FRAMES, TRAIN_SIZE, seed=6,
                     device=DEV)
    write_s = time.perf_counter() - t
    ds = TemporalAlignmentDataset(str(data), "train", TRAIN_T,
                                  resolution=TRAIN_SIZE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    corpus = build_resident_corpus(ds, device=DEV)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t
    # the first two videos as generate_dataset drew them
    want, _, _ = synthetic_corpus(2, TRAINER_FRAMES, TRAIN_SIZE, seed=5,
                                  device=DEV)
    if not torch.equal(corpus.frames[:2], want):
        raise AssertionError("the corpus decoded from PNG differs from the "
                             "frames written")
    del corpus, want
    say("trainer", t0, f"datasets written in {write_s:.2f} s; corpus "
        f"decoded and staged in {stage_s:.2f} s")

    def argv(name, *extra):
        return ["--data_root", str(data), "--validation_folder", str(val),
                "--resident_data", "--batch_size", str(TRAIN_B),
                "--train_frames", str(TRAIN_T), "--val_frames", str(TRAIN_T),
                "--size", str(TRAIN_SIZE), "--sched", "cycle",
                "--epoch", str(TRAINER_STEPS),
                "--metrics_path", str(work / f"metrics_{name}.jsonl"),
                "--sample_folder", str(work / f"samples_{name}"), *extra]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    zero_counts()
    run_u = trainer_cli.main(argv("u", "--validate_at", "1000",
                                  "--checkpoint_dir", str(work / "ckpt_u")),
                             device=DEV)
    run_v = trainer_cli.main(argv("v", "--validate_at",
                                  str(TRAINER_VALIDATE_AT),
                                  "--checkpoint_dir", str(work / "ckpt_v")),
                             device=DEV)
    ckpt_v = _run_dir(work, "ckpt_v")
    ckpt_r = work / "ckpt_r"
    ckpt_r.mkdir()
    for step in CheckpointManager(str(ckpt_v)).all_steps():
        if step <= TRAINER_RESUME_AT:
            shutil.copy(ckpt_v / f"ckpt_{step:08d}.pt", ckpt_r)
    run_r = trainer_cli.main(argv("r", "--validate_at",
                                  str(TRAINER_VALIDATE_AT), "--ckpt",
                                  "latest", "--checkpoint_dir", str(ckpt_r)),
                             device=DEV)
    counts = read_counts()
    n_steps = 2 * TRAINER_STEPS + (TRAINER_STEPS - TRAINER_RESUME_AT)

    rec_u = _records(work / "metrics_u.jsonl")
    rec_r = _records(work / "metrics_r.jsonl")
    for name, rec, steps in (
            ("u", rec_u, range(1, TRAINER_STEPS + 1)),
            ("v", _records(work / "metrics_v.jsonl"),
             range(1, TRAINER_STEPS + 1)),
            ("r", rec_r, range(TRAINER_RESUME_AT + 1, TRAINER_STEPS + 1))):
        if sorted(rec) != list(steps):
            raise AssertionError(f"run {name}: metrics of steps "
                                 f"{sorted(rec)}, expected {list(steps)}")
        for r in rec.values():
            if not all(math.isfinite(r[k]) for k in
                       ("loss", "mse", "latent", "perceptual", "lr")):
                raise AssertionError(f"run {name}: non-finite record {r}")
    keep = run_v.ckpt.keep
    kept = {n: CheckpointManager(str(d)).all_steps() for n, d in
            (("u", _run_dir(work, "ckpt_u")), ("v", ckpt_v), ("r", ckpt_r))}
    if kept["v"] != [TRAINER_VALIDATE_AT, 2 * TRAINER_VALIDATE_AT,
                     TRAINER_STEPS] or any(len(v) > keep
                                           for v in kept.values()):
        raise AssertionError(f"checkpoints kept {kept} (keep {keep})")
    if run_r.global_step != TRAINER_STEPS or kept["r"][-1] != TRAINER_STEPS:
        raise AssertionError(f"the resumed run ended at step "
                             f"{run_r.global_step}, checkpoints {kept['r']}")
    streams = sorted(_run_dir(work, "samples_v").glob("*.avi"))
    n_expected = 2 * VAL_VIDEOS * 4  # validations x batches x streams
    if len(streams) != n_expected:
        raise AssertionError(f"{len(streams)} sample streams, expected "
                             f"{n_expected}")
    for path in streams:
        frames = read_video_frames(str(path))
        if len(frames) != TRAIN_T or any(
                f.shape != (TRAIN_SIZE, TRAIN_SIZE, 3) for f in frames):
            raise AssertionError(f"{path.name}: {len(frames)} frames of "
                                 f"{frames[0].shape if frames else None}")

    # the resumed run against the runs without a break, at step 8
    rec_v = _records(work / "metrics_v.jsonl")
    after = range(TRAINER_RESUME_AT + 1, TRAINER_STEPS + 1)
    first, last = TRAINER_TIMED
    span = rec_u[last]["time"] - rec_u[first]["time"]
    result = {
        "trainer_frames_per_s": (last - first) * TRAIN_B * TRAIN_T / span,
        "dataset_write_s": write_s,
        "corpus_stage_s": stage_s,
        # R against V: the same run continued with and without a resume
        "resumed_vs_continued": _compare(run_r, run_v, rec_r, rec_v, after),
        # R against U: against a separate run without a break
        "resumed_vs_unbroken": _compare(run_r, run_u, rec_r, rec_u, after),
        "unbroken_u_vs_v": _compare(run_u, run_v, rec_u, rec_v,
                                    range(1, TRAINER_STEPS + 1)),
        "checkpoints": kept,
        "sample_streams": len(streams),
        "launches": counts,
    }

    # a checkpoint's save and restore at the flagship widths
    manager = CheckpointManager(str(work / "ckpt_timing"), keep=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    manager.save(TRAINER_STEPS, run_u.state, seed=0)
    result["checkpoint_save_s"] = time.perf_counter() - t
    t = time.perf_counter()
    manager.restore(run_u.state, TRAINER_STEPS, seed=0)
    torch.cuda.synchronize()
    result["checkpoint_restore_s"] = time.perf_counter() - t
    result["checkpoint_bytes"] = Path(manager.path(TRAINER_STEPS)
                                      ).stat().st_size
    say("trainer", t0, json.dumps(result))
    if (counts["vq_assign"] != 2 * n_steps or counts["vq_stats"] != 2 * n_steps
            or counts["warp"] != n_steps or counts["warp_backward"] != 0):
        raise AssertionError(f"launches {counts} for {n_steps} steps")
    if not result["resumed_vs_continued"]["bitwise_equal"]:
        raise AssertionError("the resumed run differs from the same run "
                             "continued without a break")
    lr = trainer_cli.build_parser().get_default("lr")
    unbroken = result["resumed_vs_unbroken"]
    if not (unbroken["max_loss_rel_err"] <= 1e-3
            and unbroken["max_param_diff"] <= 2 * lr * TRAINER_STEPS + 1e-6
            and unbroken["share_params_within_1e-5"] >= 0.99
            and unbroken["max_codebook_scaled_diff"] <= 1e-3):
        raise AssertionError("the resumed run disagrees with the unbroken one")
    return result


# -- phase 9: JPEG frames through nvJPEG ----------------------------------


JPEG_FIXTURES = REPO / "tests" / "data_torch"


def jpeg_phase(t0, work: Path):
    """The committed JPEG fixtures (tools/make_jpeg_fixture.py), 4:2:0 and
    4:4:4, decoded by nvJPEG on the card against cv2's decodes; then a
    JPEG dataset of the trainer phase's size (16 videos x 24 frames at
    256 px, copies of six 256-pixel fixtures so that consecutive frames
    differ everywhere) staged by build_resident_corpus, whose frames
    nvJPEG decodes one after another straight into the tensor on the
    card: every staged frame must equal its own fixture's decode by
    decode_jpeg_batch."""
    image_io.build_jpeg()
    names = ("420", "444")
    paths = [JPEG_FIXTURES / f"face_{n}.jpg" for n in names]
    decoded = image_io.decode_jpeg_batch(paths, DEV)
    result = {}
    for n, img in zip(names, decoded):
        ref = np.load(JPEG_FIXTURES / f"face_{n}.npy").astype(np.int64)
        diff = np.abs(img.cpu().numpy().astype(np.int64) - ref)
        result[n] = {"max_abs_diff": int(diff.max()),
                     "mean_abs_diff": float(diff.mean()),
                     "p99_abs_diff": float(np.percentile(diff, 99)),
                     "shape": list(img.shape)}

    frames256 = sorted(JPEG_FIXTURES.glob("face256_*.jpg"))
    refs = image_io.decode_jpeg_batch(frames256, DEV)
    lms = face_landmarks((TRAIN_SIZE / 2, TRAIN_SIZE / 2), TRAIN_SIZE * 0.25)
    root = work / "jpeg_data"
    for v in range(TRAINER_VIDEOS):
        video = root / f"video_{v:03d}"
        video.mkdir(parents=True)
        for f in range(TRAINER_FRAMES):
            shutil.copy(frames256[(v + f) % len(frames256)],
                        video / f"{f:05d}.jpg")
            np.savez(video / f"{f:05d}_landmarks.npz", landmark=lms)
    before = image_io.jpeg_decodes
    ds = TemporalAlignmentDataset(str(root), "train", TRAIN_T,
                                  resolution=TRAIN_SIZE, device=DEV)
    torch.cuda.synchronize()
    t = time.perf_counter()
    corpus = build_resident_corpus(ds, device=DEV)
    torch.cuda.synchronize()
    result["jpeg_corpus_stage_s"] = time.perf_counter() - t
    staged = image_io.jpeg_decodes - before
    # ds.videos is sorted: video_000, video_001, ...
    wrong = [(v, f) for v in range(TRAINER_VIDEOS)
             for f in range(TRAINER_FRAMES)
             if not torch.equal(corpus.frames[v, f],
                                refs[(v + f) % len(frames256)])]
    result["jpeg_corpus_frames"] = TRAINER_VIDEOS * TRAINER_FRAMES
    result["jpeg_corpus_frames_decoded_on_card"] = staged
    result["jpeg_corpus_frames_wrong"] = len(wrong)
    say("jpeg", t0, json.dumps(result))
    if staged != TRAINER_VIDEOS * TRAINER_FRAMES or wrong:
        raise AssertionError(f"the JPEG corpus: {staged} frames decoded by "
                             f"nvJPEG into the card's tensor, wrong frames "
                             f"{wrong[:8]}")
    for n in names:
        max_tol, mean_tol = image_io.JPEG_TOL[n]
        if (result[n]["max_abs_diff"] > max_tol
                or result[n]["mean_abs_diff"] > mean_tol):
            raise AssertionError(f"nvJPEG's decode of face_{n}.jpg differs "
                                 f"from cv2's beyond the tolerance")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one more training step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        libs = [f.result() for f in [pool.submit(warp_cuda.build),
                                     pool.submit(vq_cuda.build),
                                     pool.submit(image_io.build_jpeg)]]
    warp_cuda.load()
    vq_cuda.load()
    image_io.load_jpeg()
    say("build", t0, ", ".join(str(p.relative_to(REPO)) for p in libs)
        + " loaded")

    t0 = time.perf_counter()
    rows = kernel_phase(t0)

    t0 = time.perf_counter()
    streams = make_streams(torch.Generator().manual_seed(2))
    launches = serve_f32(t0, streams)
    serve_bf16(t0, streams)

    t0 = time.perf_counter()
    vq_rows = vq_phase(t0)
    t0 = time.perf_counter()
    bwd = warp_bwd_phase(t0)[0]
    t0 = time.perf_counter()
    train_result, train_counts = train_phase(t0, args.profile)
    t0 = time.perf_counter()
    train_check_phase(t0)
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        trainer = trainer_phase(t0, Path(work))
        t0 = time.perf_counter()
        jpeg_phase(t0, Path(work))
    trainer_counts = trainer["launches"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    say("trainer", t_all, json.dumps({
        "card": card,
        "trainer_frames_per_s": trainer["trainer_frames_per_s"],
        "step_phase_frames_per_s": train_result["frames_per_s"],
        "corpus_stage_s": trainer["corpus_stage_s"],
        "checkpoint_save_s": trainer["checkpoint_save_s"],
        "checkpoint_restore_s": trainer["checkpoint_restore_s"],
        "launches": trainer_counts}))

    say("launches", t_all, json.dumps({"serving": {"warp": launches},
                                       "training": train_counts,
                                       "trainer": trainer_counts}))
    for k in train_counts:
        train_counts[k] += trainer_counts[k]
    main_row = rows[0]
    vq_main, vq_big = vq_rows[0], vq_rows[-1]
    kernels = [{
        "name": "bilinear_warp",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/warp.cu",
        "replaces": "faceoff_tpu/ops/warp_pallas.py:54",
        "launches": launches + train_counts["warp"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        "name": "vq_assign",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/vq.cu",
        "replaces": "faceoff_tpu/ops/vq_pallas.py:44",
        # the pair: each call launches both kernels once
        "launches": min(train_counts["vq_assign"], train_counts["vq_stats"]),
        "max_abs_err": max(r["max_abs_err"] for r in vq_rows[:-1]),
        "ms": vq_main["kernel_ms"],
        "plain_ms": vq_main["plain_ms"],
        "bound_ms": vq_main["bound_ms"],
        "bound_by": vq_main["bound_by"],
        "library_ms": vq_main["library_ms"],
    }, {
        "name": "vq_assign_rows",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/vq.cu",
        "replaces": "faceoff_tpu/ops/vq_pallas.py:90",
        "launches": train_counts["vq_assign"],
        # quant is an exact copy; the pick's score short of the best
        "max_abs_err": vq_big["max_score_shortfall"],
        "ms": vq_big["assign_ms"],
        "plain_ms": vq_big["assign_plain_ms"],
        "bound_ms": vq_big["assign_bound_ms"],
        "bound_by": vq_big["assign_bound_by"],
        "library_ms": vq_big["library_ms"],
    }, {
        "name": "vq_code_stats",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/vq.cu",
        "replaces": "faceoff_tpu/ops/vq_pallas.py:147",
        "launches": train_counts["vq_stats"],
        "max_abs_err": vq_big["max_abs_err"],
        "ms": vq_big["stats_ms"],
        "plain_ms": vq_big["stats_plain_ms"],
        "bound_ms": vq_big["stats_bound_ms"],
        "bound_by": vq_big["stats_bound_by"],
        "library_ms": vq_big["stats_library_ms"],
    }, {
        "name": "bilinear_warp_backward",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/warp.cu",
        "replaces": "faceoff_tpu/ops/warp_pallas.py:204",
        "launches": train_counts["warp_backward"],
        "max_abs_err": bwd["max_abs_err"],
        "ms": bwd["kernel_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
    }]
    print(f"[total] {time.perf_counter() - t_all:.2f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
