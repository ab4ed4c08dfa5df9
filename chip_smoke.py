#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`faceoff_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing lines with their seconds:

  1. build   — compile the kernel sources (csrc/warp.cu, csrc/vq.cu,
               csrc/ccl.cu, csrc/lk.cu, csrc/mpeg4.cu), the nvJPEG shim
               (csrc/jpeg.cu) and the kernel probe that times kernel B's
               link (tools/ccl_lk_probe.cu), one nvcc each, started
               together, into faceoff_tpu_torch/_build/, and load them;
  2. kernel  — the kernel against its plain torch version on the card at
               (1,256,256,3), (16,256,256,3), one case whose output
               grid differs from the source, the training step's own
               call: 128 frames (b16 x T8) of 256x256x3 at the grids of
               `perturbation_grids`, the 512 px step's (b4 x T8: 32
               frames of 512x512x3, as many pixels at twice the source
               stride), and the swap's chunk: 32 frames at
               the grids of Umeyama similarities between synthetic
               faces; max |diff| <= 1e-5; kernel, plain,
               grid_sample and bound times, and the share of 16x16 tiles
               that the backward would splat through shared memory on the
               same grids (the forward gathers every pixel);
  3. slice   — a SwapSession at the flagship widths (random weights from a
               seed), 256x256, serves two 16-frame streams (push, then
               push_many) in float32 without TF32, through the functional
               streaming steps (`make_stream_steps`); every pushed frame
               comes back finite, the warp kernel ran once per push, and
               the frames match the port's offline forward of the same
               composites (atol 2e-4, rtol 1e-3). Then the bfloat16 path
               is timed: frames/s, per-push latency and a per-stage split;
               and four `push_step`s on a prepared frame run under
               `torch.cuda.set_sync_debug_mode("error")`: no
               device-to-host sync.
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
               and backward alone at the step's shapes. The train
               phase's --no_pallas part is phase 19.
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
               checkpoints, sample streams (mp4v, read back on the card)
               and launch counts checked; a checkpoint's save and restore
               timed.
  9. jpeg    — the committed JPEG fixtures (4:2:0, 4:4:4) decoded by nvJPEG
               against cv2's decodes (max and mean |diff| in levels, within
               the stated tolerance), and a JPEG dataset of the trainer
               phase's size (16 videos x 24 frames at 256 px) staged by
               build_resident_corpus with nvJPEG decoding into the tensor
               on the card, every frame equal to its own decode.
 10. swap    — the swap command line's main() (cli/swap) on two 48-frame
               synthetic videos at 256 px with the trainer phase's step-8
               checkpoint, writing swapped .mp4 files (each read back
               equal to the encoder's reconstruction of the swapped
               frames): the host geometry; --device_pipeline (2 K4
               launches, its streams against the host path's);
               --streaming with 1 and 4 frames a call against the
               chunked frames; --blend poisson at 1024 iterations (the
               naive stream's non-finite share printed) and the device
               Poisson blend against the host twin; then cli/evaluate's
               main() on the trainer phase's validation set,
               self-supervised and --crossid --naive_baseline paste.
               Frames/s of each path, the push p50 and the Poisson
               chunk's seconds.
 11. export  — cli/export's main() on the trainer phase's step-8
               checkpoint (flagship widths, 256 px, bf16): each program's
               export seconds and the bundle's bytes; the bundle run from
               its files in a fresh interpreter that cannot import the
               port or JAX (offline on 8 composites, init/push/flush over
               the slice phase's first stream, prepared frame by frame),
               held within the slice's tolerance against the eager
               restored model and a SwapSession on the same stream; the
               exported and the eager push timed in turns (p50).
 12. gan     — the GAN fine-tuning stage: mocoganhd gen/disc pairs at
               bench.py's bench_gan point (B 1, T 16, a 16-frame window,
               256 px; the flagship VQVAE in bf16, MultiscaleDiscriminator
               2D/3D at ndf 64 in float32) on the train phase's corpus, 2
               warm-up and 6 timed pairs: pair ms, frames/s as bench.py
               counts them, peak memory, 4 assignment, 2 statistics and
               2 warp launches a pair, the codebooks bitwise unchanged by
               the disc steps; the pair's parts alone; the kernels at the
               path's own calls against their plain versions; a float32
               pair on CUDA against the CPU (with the card's gradient at
               the generator entries whose CPU gradient is exactly zero,
               beside float32 rounding of its tensor's norm); then the
               GAN CLI's main()
               warm-started from the trainer phase's step-8 checkpoint:
               mocoganhd for 8 steps and resumed at 4 (bitwise equal),
               then mocogan, vqgan and mocoganhd --perceptual, each with
               its steps/s and fd_vgg / fd_vgg_motion.
 13. b2f     — VQVAE_B2F at the flagship widths, three 16-frame streams
               at 256 px, bf16 under autocast: 2 warm-up and 5 timed
               training steps (step ms, peak memory, 6 assignment and 6
               statistics launches a step, finite losses and codebooks),
               a tower's bottom call (65536, 64, 512) held against the
               plain version and timed, and a float32 training forward at
               narrow widths on CUDA against the CPU.
 14. aux     — cli/train_faceoff (the vanilla trainer: no LPIPS built,
               2 + 2 VQ launches a step, frames/s) on a PNG dataset at
               flagship widths, 256 px, b2, T8, 4 steps; cli/encode on the
               trainer phase's step-8 checkpoint over 32 frames (the codes
               equal the restored model's encode_codes; the --decode .mp4
               read back equal to the encoder's reconstruction, its
               PSNR); cli/train_alignment for 20 steps at
               256 px, 8 frames (first and last loss, steps/s).
 15. dist    — in a child process with a one-rank NCCL group: the
               perceptual CLI with --multihost against the same run
               without it (3 steps at the trainer phase's setting), and
               make_shardmap_train_step on make_mesh(data=1, time=1)
               against make_train_step at the train phase's setting (5
               steps); both pairs bitwise equal; the two steps' ms beside
               the train phase's.
 16. preprocess — offline preprocessing from raw footage: 4 motion-JPEG
               AVIs of 300 frames at 1280x720 (a drifting face, its mouth
               opening and closing, a cut at frame 150) through
               cli/preprocess's main(["all", ...]) at 256 px (8 mp4v
               clips, none quarantined; stage 1 and 2 frames/s, kernel B's
               launches a frame, the re-detections); stage 1's parts on
               one video; kernel A (connected components, csrc/ccl.cu;
               its launches by caller: 720p and 256 px detector batches,
               seed crops) and kernel B (pyramidal LK, csrc/lk.cu; its
               latency bound: the longest point's links times one link's
               least time) against their plain versions on the phase's
               frames; the output read by
               TemporalAlignmentDataset on the card and staged by
               build_resident_corpus (batched nvJPEG windows), a window
               by decode_jpeg_window against the per-frame loop; one
               perceptual step at the train phase's setting on it.
 17. time    — both postnets of the flagship VQVAE at 256 px (128
               channels at 64x64 and 32x32) over a T=64 clip cut into 4
               blocks of 16 frames, each block through the shard-local
               layer with the halos the exchange would deliver
               (`models.vqvae.postnet_over_shards`), against the whole
               clip: output and input gradient, float32 without TF32
               (within 1e-4 of the largest |value|) and bf16 (within
               2^-6 of it); no kernel of the port launches. The exchange
               over NCCL needs several GPUs: tools/dist_check_torch.py
               --time.
 18. mp4     — mp4 in and out: the committed cv2 fixture
               (tests/data_torch/face_mp4v.mp4) decoded on the card equal
               to the plain decode and to cv2's stored decode; the
               preprocess phase's 4 x 300 frames at 1280x720 written as
               mp4v on the card and read back (the main path), each
               decode equal to the encoder's reconstruction (encode and
               decode frames/s, the host coder's share, bytes a frame,
               PSNR), and a 256-px clip likewise; kernels V1-V4
               (csrc/mpeg4.cu) against their plain versions at every call
               of the first GOP's round trip at 720p and 256 px, then
               each timed at the main path's largest call beside its
               bound (V1 with the share of its blocks whose column pass
               takes 64 bits); cli/preprocess's main(["all", ...]) on one 720p
               mp4v video (NNNNN.mp4 clips, none quarantined, stage 1 and
               2 frames/s beside the AVI run's).
 19. no_pallas — the train phase's step with --no_pallas (run after
               the trainer phase, whose dataset its CLI run reads): the
               same corpus, seeds and weights through a
               `use_pallas_vq=False` model and the kernel model, float32
               without TF32, 2 steps each: the plain route launches no
               VQ kernel and one warp a step; the share of rows whose
               code differs at the first step (on the same inputs; only
               float32 ties may differ), the losses, parameters and
               codebooks within the stated tolerances; two bf16 runs of
               the plain route from one seed bitwise equal, its step ms;
               then the perceptual CLI with --no_pallas for 2 steps at
               the trainer phase's point (finite records, no VQ launch).
 20. remat512 — 512 px training at the JAX package's operating point
               (b4, T8, flagship widths): one float32 step without TF32
               on a held batch with no remat, --remat, --remat
               --remat_scope decoder and --remat --remat_lpips, the
               losses, gradients and codebooks of each against no remat
               within the stated tolerances; the four in bf16 with the
               resident prepare function (2 warm-up and 3 timed steps):
               step ms, frames/s, peak memory, 2 VQ and 1 warp launches
               a step; then the perceptual CLI with --resident_data
               --size 512 --batch_size 4 --train_frames 8 --remat for 4
               steps on a 512 px PNG dataset (finite records, a
               checkpoint written).

Then it prints the card's name and power limit (nvidia-smi), one JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}. Any failure
raises and exits non-zero; so does a machine without CUDA. It imports
torch, numpy, the standard library and faceoff_tpu_torch only.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
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
from faceoff_tpu_torch.cli import common as cli_common
from faceoff_tpu_torch.cli import encode as encode_cli
from faceoff_tpu_torch.cli import evaluate as evaluate_cli
from faceoff_tpu_torch.cli import export as export_cli
from faceoff_tpu_torch.cli import swap as swap_cli
from faceoff_tpu_torch.cli import train_alignment as align_cli
from faceoff_tpu_torch.cli import train_faceoff as vanilla_cli
from faceoff_tpu_torch.cli import train_faceoff_gan as gan_cli
from faceoff_tpu_torch.cli import train_faceoff_perceptual as trainer_cli
from faceoff_tpu_torch.data import geometry
from faceoff_tpu_torch.data.dataset import (_landmark_paths, denormalize,
                                            load_frame)
from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset
from faceoff_tpu_torch.data.resident import (build_resident_corpus,
                                             corpus_from_arrays,
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import (draw_face, draw_faces,
                                              face_landmarks,
                                              generate_dataset,
                                              synthetic_corpus)
from faceoff_tpu_torch.io import image as image_io
from faceoff_tpu_torch.io import mp4, mpeg4
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.io.video import (read_video_frames, video_frame_chunks,
                                        write_avi)
from faceoff_tpu_torch.losses import mse_loss
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models.vqvae import postnet_over_shards
from faceoff_tpu_torch.models.vqvae_b2f import VQVAE_B2F
from faceoff_tpu_torch.models.discriminators import (MultiscaleDiscriminator2D,
                                                     MultiscaleDiscriminator3D)
from faceoff_tpu_torch.models.lpips import RematLPIPS, init_lpips
from faceoff_tpu_torch.ops import (ccl_cuda, cuda_build, lk_cuda,
                                   mpeg4_cuda)
from faceoff_tpu_torch.ops import vq as V
from faceoff_tpu_torch.ops import vq_cuda
from faceoff_tpu_torch.ops import warp as W
from faceoff_tpu_torch.ops import warp_cuda
from faceoff_tpu_torch.ops.swap import _STABLE, poisson_blend, prepare_swap_batch
from faceoff_tpu_torch.preprocess.detectors import HeuristicDetector
from faceoff_tpu_torch.serve import SwapSession
from faceoff_tpu_torch.serve.export import load_bundle
from faceoff_tpu_torch.serve.streaming import (_postnet_stream,
                                              make_stream_steps)
from faceoff_tpu_torch.train import gan
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
SWAP_CHUNK = 32  # cli/swap.py's default --chunk
DEV = "cuda"
U32 = 2.0 ** -24  # float32 unit roundoff
# the training phase: b16, T8, 256 px at the flagship widths
TRAIN_B, TRAIN_T, TRAIN_SIZE = 16, 8, 256
CORPUS_VIDEOS, CORPUS_FRAMES = 16, 24
WARMUP_STEPS, TIMED_STEPS = 2, 5
# the one-cycle schedule spans the run (5% warmup rounds to no warmup)
TRAIN_LR, TRAIN_N_ITER = 3e-4, WARMUP_STEPS + TIMED_STEPS
VQ_SHAPES = [(524288, 64, 512), (131072, 64, 512), (65536, 64, 4096)]
# the 512 px training point (the JAX package's: b4, T8, full remat), the
# same 32 frames a step as the train phase's b16 x T8 at 256 px
R512_B, R512_T, R512_SIZE = 4, 8, 512
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


def perturb_inputs(gen, t=TRAIN_B * TRAIN_T, size=TRAIN_SIZE):
    """The warp's inputs on the training step: B x T frames (128 at 256 px,
    32 at 512 px) of size x size x 3 in [0, 1], sampled at the grids
    `perturb_clip` builds from a fresh draw (eye centres near the middle
    of the frame)."""
    imgs = torch.rand((t, size, size, 3), generator=gen)
    eyes = size * (0.4 + 0.2 * torch.rand((t, 2), generator=gen))
    xs, ys, _ = W.perturbation_grids(W.draw_perturbation(gen, t), size,
                                     size, eyes)
    return imgs, xs.contiguous(), ys.contiguous()


def swap_inputs(gen):
    """The warp's inputs in a swap chunk (`cli/swap.py --device_pipeline`,
    `--chunk 32`): 32 segmented faces of 256x256x3 in [0, 1], sampled at
    the grids of the Umeyama similarities between two synthetic faces
    that drift, scale and turn apart (`prepare_swap_batch`)."""
    n, size = SWAP_CHUNK, SIZE
    imgs = torch.rand((n, size, size, 3), generator=gen)
    draw = torch.rand((n, 2, 4), generator=gen).numpy()
    lms = [[face_landmarks((size * (0.35 + 0.3 * d[0]),
                            size * (0.35 + 0.3 * d[1])),
                           size * (0.18 + 0.1 * d[2]), 20 * (d[3] - 0.5))
            for d in pair] for pair in draw]
    lms = torch.from_numpy(np.asarray(lms, np.float32))
    ms = W.umeyama_similarity(lms[:, 0, _STABLE], lms[:, 1, _STABLE])
    xs, ys = W.affine_grid(W.invert_affine(ms), size, size)
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
    # the 512 px step's call: as many pixels, twice the source stride
    cases.append(("perturbation", (R512_B * R512_T, R512_SIZE, R512_SIZE, 3,
                                   R512_SIZE, R512_SIZE),
                  lambda: perturb_inputs(gen, R512_B * R512_T, R512_SIZE)))
    cases.append(("swap", (SWAP_CHUNK, SIZE, SIZE, 3, SIZE, SIZE),
                  lambda: swap_inputs(gen)))
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
    s = torch.tensor(5, dtype=torch.int32, device=DEV)
    total = torch.tensor(2**31 - 1, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        enc_b, enc_t = model._encode_frames(frame)
        bufs_b = [torch.zeros_like(enc_b[:, :, None]).expand(-1, -1, 2, -1, -1)
                  for _ in range(model.temporal_postnet_layers)]
        bufs_t = [torch.zeros_like(enc_t[:, :, None]).expand(-1, -1, 2, -1, -1)
                  for _ in range(model.temporal_postnet_layers)]
        _, pb = _postnet_stream(model.conv3d_encoded_b, bufs_b, enc_b, s, total)
        _, pt = _postnet_stream(model.conv3d_encoded_t, bufs_t, enc_t, s, total)
        quant_t, quant_b = model._encode_quantized(pb, pt)[:2]
        stages = {
            "geometry": lambda: prepare_swap_batch(src, lms[0], tgt, lms[1]),
            "encode": lambda: model._encode_frames(frame),
            "postnets": lambda: (
                _postnet_stream(model.conv3d_encoded_b, bufs_b, enc_b, s, total),
                _postnet_stream(model.conv3d_encoded_t, bufs_t, enc_t, s, total)),
            "quantize": lambda: model._encode_quantized(pb, pt),
            "decode": lambda: model._decode(quant_t, quant_b),
        }
        split = {k: device_ms(fn, reps=9, inner=5) for k, fn in stages.items()}
        eager = {k: cuda_ms(fn, reps=9, inner=5) for k, fn in stages.items()}

    # the functional push on a prepared frame reads nothing back to the
    # host: CUDA's sync debug mode raises on any synchronizing call
    init, push, _, _, _ = make_stream_steps(model, device=DEV)
    state, _ = push(init(1, SIZE, SIZE), x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            state, out = push(state, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("push_step under sync debug mode: not finite")
    say("slice", t0, "push_step on a prepared frame: no device-to-host sync "
        "in 4 pushes under torch.cuda.set_sync_debug_mode('error')")
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
    streams = sorted(_run_dir(work, "samples_v").glob("*.mp4"))
    n_expected = 2 * VAL_VIDEOS * 4  # validations x batches x streams
    if len(streams) != n_expected:
        raise AssertionError(f"{len(streams)} sample streams, expected "
                             f"{n_expected}")
    for path in streams:  # mp4v, read back on the card
        frames = read_video_frames(str(path), device=DEV)
        if tuple(frames.shape) != (TRAIN_T, TRAIN_SIZE, TRAIN_SIZE, 3):
            raise AssertionError(f"{path.name}: {tuple(frames.shape)}")

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


# -- phase 10: the cross-identity swap and its evaluation, by the CLIs ----


SWAP_FRAMES, SWAP_POISSON_CHECK_ITERS = 48, 48
# tests/test_swap_device.py::test_streams_match_host_path
STREAM_MAD, STREAM_BIG, STREAM_BIG_SHARE = 0.04, 0.25, 0.03
# streaming against chunked, both bf16 (below, swap_phase)
BF16_MEAN_LEVELS, BF16_FAR_LEVELS, BF16_FAR_SHARE = 1.0, 8, 0.01


def _frame_diff(a, b):
    """(max, mean, share > BF16_FAR_LEVELS) of |a - b| in uint8 levels
    over two lists of frames."""
    d = np.abs(np.stack(a).astype(np.int64) - np.stack(b).astype(np.int64))
    return int(d.max()), float(d.mean()), float((d > BF16_FAR_LEVELS).mean())


def same_neighbours(n, chunk, reach):
    """The frames that `cli/swap.py` computes from the same inputs chunked
    (chunks of `chunk` frames, the tail padded with zero frames) and
    streamed: all of a frame's neighbours within the postnets' `reach`
    lie in its own chunk, or beyond the video's ends where both see zero
    features (the start; the end when the last chunk is full)."""
    keep = []
    for f in range(n):
        lo = f // chunk * chunk
        hi = min(lo + chunk, n) - 1
        start_ok = f - reach >= lo or lo == 0
        end_ok = f + reach <= hi or (hi == n - 1 and hi - lo + 1 == chunk)
        if start_ok and end_ok:
            keep.append(f)
    return keep


def swap_phase(t0, work: Path):
    """`cli/swap.main` in this process on the card, with the trainer
    phase's step-8 checkpoint (run V: flagship widths, 256 px) on two
    synthetic 48-frame videos at 256 px (one chunk of 32 and a padded
    tail of 16):

      host       the host geometry per frame pair, the model in chunks;
      device     --device_pipeline: the geometry in chunks on the card,
                 exactly one K4 launch a chunk (2), and its source and
                 background streams against the host path's, as the JAX
                 test holds its device path to the host (mean |diff| <
                 0.04, < 3 % of pixels over 0.25);
      streaming  --streaming, and with --frames_per_call 4: as many
                 frames as the chunked run, and within the bf16
                 tolerance of it on the frames both compute from the
                 same inputs: the chunked run sees each chunk as a clip
                 of its own (zero features before and after it, and zero
                 frames in the padded tail), so a frame within the
                 postnets' reach (3 frames) of a chunk's edge, or of the
                 padding, has other neighbours than in the stream; those
                 are reported, not held. On the others both run the same
                 bf16 weights on the same inputs, the convolutions
                 batched 32 frames or one at a time, so activations round
                 to bf16 (2^-8 relative) at other places; that moves a
                 frame by about a level, and where a latent lies within
                 that of a tie between two codes it takes the other code
                 and its patch moves further. So: mean |diff| <= 1 level,
                 and at most 1 % of the values more than 8 levels apart;
      poisson    --device_pipeline --blend poisson --save_streams at the
                 default 1024 iterations: the share of non-finite values
                 in the naive stream is printed (the iteration diverges,
                 as in the JAX package: ROADMAP.md, Queue 3), not
                 checked; one chunk's `prepare_swap_batch` on the card
                 timed with the Poisson blend and with the paste; then
                 the device poisson_blend against the host
                 float64 twin on one frame pair at 48 iterations, atol
                 2e-4, as the JAX test holds them;
      evaluate   `cli/evaluate.main` on the trainer phase's validation
                 set, self-supervised and --crossid --naive_baseline
                 paste: every value finite, the keys tagged _random_vgg.

    Frames/s of the geometry and of the whole swap are from the CLI's
    own clocks, which end in reads of the results on the host."""
    videos = work / "swap_videos"
    # drawn on the CPU: the frames the CPU tests measure (host and device
    # streams 2.83 % apart there, against the 3 % limit)
    generate_dataset(str(videos), 2, SWAP_FRAMES, SIZE, seed=7)
    ckpt = _run_dir(work, "ckpt_v")

    def run(name, *extra):
        argv = ["--source", str(videos / "video_000"),
                "--target", str(videos / "video_001"),
                "--checkpoint_dir", str(ckpt), "--ckpt", str(TRAINER_STEPS),
                "--out", str(work / f"swap_{name}.mp4"),
                "--size", str(SIZE), "--chunk", str(SWAP_CHUNK), *extra]
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = swap_cli.main(argv, device=DEV)
        res["wall_s"] = time.perf_counter() - t
        if len(res["frames"]) != SWAP_FRAMES or res["step"] != TRAINER_STEPS:
            raise AssertionError(f"swap {name}: {len(res['frames'])} frames "
                                 f"from step {res['step']}")
        # mp4v: the video read back is the encoder's reconstruction
        frames = read_video_frames(str(work / f"swap_{name}.mp4"), device=DEV)
        *_, recon = mpeg4.encode(torch.from_numpy(np.stack(res["frames"]))
                                 .to(DEV), 25, return_recon=True)
        if frames.shape[0] != SWAP_FRAMES or not torch.equal(frames, recon):
            raise AssertionError(f"swap {name}: the video written differs")
        return res

    def rate(res):
        sec = res["seconds"]
        return {"geometry_frames_per_s": SWAP_FRAMES / sec["prepare"],
                "frames_per_s": SWAP_FRAMES / (sec["prepare"] + sec["model"]),
                **{f"{k}_s": v for k, v in sec.items()},
                "wall_s": res["wall_s"]}

    n_chunks = -(-SWAP_FRAMES // SWAP_CHUNK)
    result = {}
    host = run("host")
    result["host"] = rate(host)
    zero_counts()
    device = run("device", "--device_pipeline")
    counts = read_counts()
    result["device_pipeline"] = {**rate(device), "launches": counts}
    if counts["warp"] != n_chunks or counts["warp_backward"] != 0:
        raise AssertionError(f"--device_pipeline launches {counts} for "
                             f"{n_chunks} chunks")
    for key in ("sources", "backgrounds"):
        d = np.abs(np.stack(device[key]) - np.stack(host[key]))
        mad, big = float(d.mean()), float((d.max(-1) > STREAM_BIG).mean())
        result["device_pipeline"][f"{key}_vs_host"] = {
            "mean_abs_diff": mad, "share_over_0.25": big}
        if not (mad < STREAM_MAD and big < STREAM_BIG_SHARE):
            raise AssertionError(f"--device_pipeline {key} differ from the "
                                 f"host path: {mad}, {big}")
    chunked = _frame_diff(device["frames"], host["frames"])
    result["device_pipeline"]["frames_vs_host"] = chunked
    say("swap", t0, json.dumps({"host": result["host"],
                                "device_pipeline": result["device_pipeline"]}))

    same = same_neighbours(SWAP_FRAMES, SWAP_CHUNK,
                           ModelConfig().temporal_postnet_layers
                           * (ModelConfig().temporal_kernel // 2))
    for name, extra in (("streaming", ()),
                        ("streaming_k4", ("--frames_per_call", "4"))):
        res = run(name, "--streaming", *extra)
        lat = res["latency_ms"][1:]
        diff = _frame_diff([res["frames"][f] for f in same],
                           [host["frames"][f] for f in same])
        edge = _frame_diff(res["frames"], host["frames"])
        result[name] = {**rate(res), "push_ms_p50": statistics.median(lat),
                        "push_ms_max": max(lat),
                        "frames_vs_chunked": {"frames": len(same),
                                              "max": diff[0], "mean": diff[1],
                                              "share_far": diff[2]},
                        "all_frames_vs_chunked": {"max": edge[0],
                                                  "mean": edge[1],
                                                  "share_far": edge[2]}}
        say("swap", t0, f"{name} " + json.dumps(result[name]))
        if not (diff[1] <= BF16_MEAN_LEVELS and diff[2] <= BF16_FAR_SHARE):
            raise AssertionError(f"{name}: frames differ from the chunked "
                                 f"run beyond the bf16 tolerance: {diff}")

    poisson = run("poisson", "--device_pipeline", "--blend", "poisson",
                  "--save_streams")
    streams = sorted(p.name for p in work.glob("swap_poisson_*.mp4"))
    if streams != ["swap_poisson_background.mp4", "swap_poisson_composite.mp4",
                   "swap_poisson_naive_poisson.mp4"]:
        raise AssertionError(f"--save_streams wrote {streams}")
    cli_counts = read_counts()
    # one chunk of the swap's geometry on the card, paste and Poisson,
    # frames and landmarks already there (median of 3, after the runs;
    # these launches are not the main path's)
    src_paths = _landmark_paths(str(videos / "video_000"))
    tgt_paths = _landmark_paths(str(videos / "video_001"))
    pairs = [load_frame(p, SIZE) for p in src_paths[:SWAP_CHUNK]]
    pairs_t = [load_frame(p, SIZE) for p in tgt_paths[:SWAP_CHUNK]]
    chunk = [torch.from_numpy(np.stack([f[i] for f in fs])).to(DEV)
             for fs in (pairs, pairs_t) for i in (0, 1)]

    def chunk_s(**kw):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prepare_swap_batch(*chunk, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return statistics.median(times)

    result["poisson"] = {
        **rate(poisson),
        "cli_prepare_s_per_chunk": poisson["seconds"]["prepare"] / n_chunks,
        "chunk_s": chunk_s(poisson=True),
        "paste_chunk_s": chunk_s(),
        "naive_nonfinite_share": poisson["naive_nonfinite_share"]}

    # the device blend against the host float64 twin on one frame pair
    s_img, s_lms = pairs[0]
    t_img, t_lms = pairs_t[0]
    face = geometry.generate_warped_image(
        s_lms, t_lms, s_img, t_img)["source_face_transformed"]
    t01, s01, m01 = t_img / 255.0, s_img / 255.0, face / 255.0
    want = geometry.poisson_blend(t01, s01, m01, SWAP_POISSON_CHECK_ITERS)
    got = poisson_blend(*(torch.from_numpy(a).to(DEV, torch.float32)
                          for a in (t01, s01, m01)),
                        iters=SWAP_POISSON_CHECK_ITERS).cpu().numpy()
    err = float(np.abs(got - want).max())
    result["poisson"]["device_vs_host_48_max_abs_err"] = err
    say("swap", t0, "poisson " + json.dumps(result["poisson"]))
    if not err <= 2e-4:
        raise AssertionError(f"poisson_blend on the card differs from the "
                             f"host twin: {err}")

    zero_counts()
    evals = {}
    for name, extra in (("self_supervised", ()),
                        ("crossid", ("--crossid", "--naive_baseline",
                                     "paste"))):
        t = time.perf_counter()
        rep = evaluate_cli.main(
            ["--data_root", str(work / "val"), "--checkpoint_dir", str(ckpt),
             "--ckpt", str(TRAINER_STEPS), "--frames", str(TRAIN_T),
             "--size", str(TRAIN_SIZE),
             *extra], device=DEV)
        metrics = {k: v for k, v in rep.items()
                   if k not in ("n_clips", "checkpoint_step")}
        if (rep["n_clips"] != VAL_VIDEOS or not metrics
                or not all(math.isfinite(v) for v in metrics.values())
                or not all(k.endswith("_random_vgg") for k in metrics
                           if k.startswith(("lpips", "fd_")))):
            raise AssertionError(f"evaluate {name}: {rep}")
        evals[name] = {"report": rep, "wall_s": time.perf_counter() - t}
    if not {"fd_vgg_random_vgg", "fd_vgg_motion_random_vgg",
            "fd_vgg_naive_paste_random_vgg"} <= set(evals["crossid"]["report"]):
        raise AssertionError(f"evaluate --crossid: {evals['crossid']}")
    result["evaluate"] = evals
    result["launches"] = {k: v + cli_counts[k]
                          for k, v in read_counts().items()}
    say("swap", t0, "evaluate " + json.dumps(evals))
    return result


# -- phase 11: the serving bundle -----------------------------------------


EXPORT_TIMED = 30  # pushes of each kind, in turns

# Runs a bundle from its files in an interpreter where importing the port,
# the JAX package or JAX raises: argv[1] the bundle, argv[2] the directory
# of its inputs (clip.npy, frames.npy) and outputs.
_BUNDLE_SCRIPT = """
import importlib.abc, json, os, sys
blocked = ("faceoff_tpu_torch", "faceoff_tpu", "jax", "jaxlib")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch

bundle, work = sys.argv[1], sys.argv[2]
meta = json.load(open(os.path.join(bundle, "meta.json")))
dev = torch.device(meta["platforms"][0])
sm = meta["streaming"]

def load(name):
    return torch.export.load(os.path.join(bundle, name)).module()

def arg(name):
    return torch.from_numpy(np.load(os.path.join(work, name))).to(dev)

with torch.no_grad():
    offline = load(meta["offline"]["file"])(arg("clip.npy"))
    np.save(os.path.join(work, "bundle_offline.npy"), offline.cpu().numpy())
    frames = arg("frames.npy")
    push, flush = load(sm["push_file"]), load(sm["flush_file"])
    state = load(sm["init_file"])()
    outs = []
    for t in range(frames.shape[0]):
        state, out = push(state, frames[t:t + 1])
        outs.append(out)
    total = torch.tensor(frames.shape[0], dtype=torch.int32, device=dev)
    for _ in range(sm["delay"]):
        state, out = flush(state, total)
        outs.append(out)
np.save(os.path.join(work, "bundle_stream.npy"),
        torch.stack(outs).cpu().numpy())
loaded = sorted(n for n in sys.modules if n.split(".")[0] in blocked)
assert not loaded, loaded
print("bundle ran on", dev, "torch", torch.__version__)
"""


def _held(name, got, want):
    """Max |diff| of got against want, raising outside STREAM_TOL."""
    err = (got - want).abs()
    bad = err > STREAM_TOL["atol"] + STREAM_TOL["rtol"] * want.abs()
    if got.shape != want.shape or bool(bad.any()):
        raise AssertionError(f"{name}: {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, {int(bad.sum())} values "
                             f"outside {STREAM_TOL}")
    return float(err.max())


def export_phase(t0, work: Path, streams):
    """`cli/export.main` on the card with the trainer phase's step-8
    checkpoint (flagship widths, 256 px, bf16): each program's export
    seconds and the bundle's bytes; then the bundle run from its files in
    a fresh interpreter that cannot import the port or JAX: offline on the
    first 8 composites of the slice phase's first stream, init, push and
    flush over its 16 frames, prepared one at a time by
    `prepare_swap_batch` as the session prepares them. Offline is held
    against the eager restored model, the streamed frames against a
    `SwapSession` on the same streams (16 K4 launches, counted with the
    serving path), both within STREAM_TOL; then the exported push and the
    eager `push_step` timed in turns, each push synchronized."""
    ckpt = _run_dir(work, "ckpt_v")
    out_dir = work / "bundle"
    argv = ["--checkpoint_dir", str(ckpt), "--ckpt", str(TRAINER_STEPS),
            "--out", str(out_dir), "--size", str(SIZE)]
    t = time.perf_counter()
    res = export_cli.main(argv, device=DEV)
    wall = time.perf_counter() - t
    meta = res["meta"]
    if (res["step"] != TRAINER_STEPS
            or meta["platforms"] != [torch.device(DEV).type]):
        raise AssertionError(f"export: step {res['step']}, {meta}")
    result = {"export_s": res["seconds"], "export_wall_s": wall,
              "bundle_bytes": res["bytes"],
              "torch_version": meta["torch_version"]}
    say("export", t0, json.dumps(result))

    model = cli_common.restore_for_inference(
        export_cli.build_parser().parse_args(argv), DEV).model
    sf, sl, tf, tl = streams[0]
    zero_counts()
    sess = SwapSession(model, height=SIZE, width=SIZE, device=DEV)
    swapped = [o for o in (sess.push(sf[i], sl[i], tf[i], tl[i])
                           for i in range(FRAMES)) if o is not None]
    swapped += sess.flush()
    torch.cuda.synchronize()
    result["launches"] = read_counts()
    if result["launches"]["warp"] != FRAMES or len(swapped) != FRAMES:
        raise AssertionError(f"export: {len(swapped)} session frames, "
                             f"launches {result['launches']}")

    def lms(a):
        return torch.as_tensor(np.stack([a]), dtype=torch.float32).to(DEV)

    with torch.no_grad():
        frames = torch.cat([prepare_swap_batch(
            sf[i][None], lms(sl[i]), tf[i][None], lms(tl[i]))["input"]
            for i in range(FRAMES)])
        clip = frames[None, :meta["offline"]["input_shape"][1]]
        offline = model(clip)[0][..., :3]
    np.save(work / "clip.npy", clip.cpu().numpy())
    np.save(work / "frames.npy", frames.cpu().numpy())
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _BUNDLE_SCRIPT, str(out_dir), str(work)],
        cwd=work, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError("the bundle did not run without the port:\n"
                             + proc.stdout + proc.stderr)
    result["fresh_interpreter_s"] = time.perf_counter() - t
    say("export", t0, proc.stdout.strip())
    got_off = torch.from_numpy(np.load(work / "bundle_offline.npy")).to(DEV)
    got_stream = torch.from_numpy(np.load(work / "bundle_stream.npy")).to(DEV)
    delay = meta["streaming"]["delay"]
    result["offline_vs_eager_max_abs_diff"] = _held(
        "bundle offline", got_off, offline)
    result["stream_vs_session_max_abs_diff"] = _held(
        "bundle push/flush", got_stream[delay:, 0, ..., :3],
        torch.stack(swapped))

    bundle = load_bundle(str(out_dir))
    init, push, _, _, _ = make_stream_steps(model, device=DEV)
    states = {"eager": init(1, SIZE, SIZE), "exported": bundle.init_state()}
    pushes = {"eager": push, "exported": bundle.push}
    lat = {"eager": [], "exported": []}
    for r in range(5 + EXPORT_TIMED):
        x = frames[r % FRAMES][None]
        for name in (("eager", "exported") if r % 2 == 0
                     else ("exported", "eager")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            states[name], _ = pushes[name](states[name], x)
            torch.cuda.synchronize()
            if r >= 5:
                lat[name].append((time.perf_counter() - t) * 1e3)
    result["push_ms_p50"] = {k: statistics.median(v) for k, v in lat.items()}
    result["push_ms_max"] = {k: max(v) for k, v in lat.items()}
    say("export", t0, json.dumps(result))
    if wall > 60:
        say("export", t0, f"the export took {wall:.1f} s, over a minute")
    return result


# -- phase 12: the GAN fine-tuning stage ----------------------------------


# bench.py's bench_gan point: B 1, T 16, a 16-frame window, 256 px
GAN_B, GAN_T, GAN_SF, GAN_NDF = 1, 16, 16, 64
GAN_WARMUP, GAN_TIMED = 2, 6
GAN_CHECK_SIZE, GAN_CHECK_T, GAN_CHECK_SF, GAN_CHECK_NDF = 64, 6, 4, 8
GAN_LR = 3e-4  # the GAN CLI's --lr and --disc_lr
GAN_CLI_STEPS, GAN_CLI_RESUME_AT, GAN_CLI_OTHER_STEPS = 8, 4, 4


def conv_gflop(module, x):
    """Multiply-adds x 2 of every convolution in one forward of `module`
    on x, counted from the shapes (GFLOP)."""
    total = [0]

    def hook(m, args, out):
        k = m.weight[0].numel()  # in_channels x kernel volume
        total[0] += 2 * out.numel() * k

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    with torch.no_grad():
        module(x)
    for h in hooks:
        h.remove()
    return total[0] / 1e9


def _codebook_state(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("quantize_")}


def _same_codebooks(model, before):
    return all(torch.equal(v, before[k])
               for k, v in _codebook_state(model).items())


def _recorded(module, name, calls):
    """Replace module.name by a wrapper that records its arguments."""
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(args)
        return original(*args, **kwargs)

    setattr(module, name, wrapper)
    return original


def gan_kernel_rows(t0, gen_step, state, raw):
    """The kernels at the GAN path's own calls: one more gen step records
    the VQ kernels' and the warp kernel's inputs, then each is held
    against its plain version (check_vq's rules; the warp within
    KERNEL_TOL) and timed beside it, its library call and its bound."""
    vq_calls, warp_calls = [], []
    originals = (_recorded(vq_cuda, "vq_assign", vq_calls),
                 _recorded(warp_cuda, "bilinear_warp", warp_calls))
    try:
        gen_step(state, raw, 0)
        torch.cuda.synchronize()
    finally:
        vq_cuda.vq_assign, warp_cuda.bilinear_warp = originals
    rows = []
    reps = dict(reps=7, inner=3, warmup=2)
    graph = dict(reps=7, inner=3)
    for flat, embed in vq_calls:
        x = flat.detach().to(torch.float32).contiguous()
        e = embed.detach().to(torch.float32).contiguous()
        n, d = x.shape
        k = e.shape[1]
        row = {"kernel": "vq_assign", "shape": [n, d, k],
               **check_vq(x, e, vq_cuda.vq_assign(x, e))}
        flagged = int(vq_cuda.assign_rows_flagged(x, e)[2])
        b_ms, b_by = vq_bound_ms(n, d, k, flagged)
        row.update({
            "flagged_rows": flagged,
            "kernel_ms": device_ms(lambda: vq_cuda.vq_assign(x, e), **graph),
            "plain_ms": cuda_ms(lambda: V.vq_assign_plain(x, e), **reps),
            "library_ms": device_ms(lambda: x @ e, **graph),
            "bound_ms": b_ms, "bound_by": b_by,
            "assign_ms": device_ms(lambda: vq_cuda.assign_rows(x, e), **graph),
            "stats_ms": device_ms(
                lambda: vq_cuda.code_stats(x, vq_cuda.assign_rows(x, e)[0], k),
                **graph)})
        rows.append(row)
        say("gan", t0, json.dumps(row))
    for imgs, xs, ys in warp_calls:
        n, h, w, c = imgs.shape
        oh, ow = xs.shape[1:]
        out = warp_cuda.bilinear_warp(imgs, xs, ys)
        err = (out - W._bilinear_sample(imgs, xs, ys)).abs().max().item()
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp kernel at the GAN path's call "
                                 f"{tuple(imgs.shape)}: max |diff| {err}")
        nchw = imgs.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], -1)
        b_ms, b_by = bound_ms(n, h, w, c, oh, ow)
        row = {"kernel": "bilinear_warp", "shape": [n, h, w, c, oh, ow],
               "max_abs_err": err,
               "kernel_ms": device_ms(lambda: warp_cuda.bilinear_warp(
                   imgs, xs, ys)),
               "plain_ms": device_ms(lambda: W._bilinear_sample(imgs, xs, ys)),
               "library_ms": device_ms(lambda: torch.nn.functional.grid_sample(
                   nchw, grid, mode="bilinear", padding_mode="zeros",
                   align_corners=True)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        say("gan", t0, json.dumps(row))
    if len(vq_calls) != 2 or len(warp_calls) != 1:
        raise AssertionError(f"a gen step made {len(vq_calls)} VQ and "
                             f"{len(warp_calls)} warp calls, expected 2, 1")
    return rows


def gan_split(t0, model, d_img, d_3d, batch):
    """The pair's parts alone at its shapes (CUDA events, median of 5):
    the generator's forward and backward in bf16, each discriminator's
    forward and backward in float32 on one real input; and each
    discriminator's convolution GFLOP a forward."""
    stack = gan._pair_stack(batch["gt"][:, :GAN_SF])
    pair = gan._frame_pair(batch["gt"][:, :GAN_SF], 1)
    gen_params = [p for p in model.parameters()]

    def generator():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            dec, lat = model(batch["input"], train=True,
                             update_codebooks=False)
            loss = dec.square().mean() + lat
        loss.backward(inputs=gen_params)

    def disc(module, x):
        def run():
            loss = sum(f[-1].mean() for f in module(x))
            loss.backward()
        return run

    out = {"generator_fwd_bwd_ms": cuda_ms(generator, reps=5, inner=1),
           "d_3d_fwd_bwd_ms": cuda_ms(disc(d_3d, stack), reps=5, inner=1),
           "d_3d_fwd_ms": cuda_ms(lambda: d_3d(stack), reps=5, inner=1),
           "d_img_fwd_bwd_ms": cuda_ms(disc(d_img, pair), reps=5, inner=1),
           "d_3d_gflop_per_forward": conv_gflop(d_3d, stack),
           "d_img_gflop_per_forward": conv_gflop(d_img, pair)}
    for m in (model, d_img, d_3d):
        m.zero_grad(set_to_none=True)
    say("gan", t0, json.dumps(out))
    return out


def gan_step_part(t0):
    """bench_gan's point at full width: the flagship VQVAE (bf16
    autocast), MultiscaleDiscriminator2D/3D at ndf 64, three layers, two
    scales (float32, cuDNN's default TF32), Adam at lr 3e-4 for all three;
    clips sampled and prepared on the card from the train phase's corpus.
    2 warm-up and 6 timed gen/disc pairs. Checks: finite losses; the
    codebooks bitwise unchanged by every disc step; 4 assignment, 2
    statistics and 2 warp launches a pair, no warp backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    frames, lms, n_frames = synthetic_corpus(
        CORPUS_VIDEOS, CORPUS_FRAMES, TRAIN_SIZE, seed=3, device=DEV)
    corpus = corpus_from_arrays(frames, lms, n_frames, device=DEV)
    del frames
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=DEV,
                  generator=torch.Generator().manual_seed(0))
    disc_gen = torch.Generator().manual_seed(2)
    d_img = MultiscaleDiscriminator2D(ndf=GAN_NDF, device=DEV,
                                      generator=disc_gen)
    d_3d = MultiscaleDiscriminator3D(ndf=GAN_NDF, n_frames=GAN_SF, device=DEV,
                                     generator=disc_gen)
    state = gan.create_gan_state(create_train_state(model, lr=GAN_LR), d_img,
                                 d_3d, disc_lr=GAN_LR)
    prepare = make_resident_prepare(corpus, GAN_B, GAN_T)
    gen_step, disc_step = gan.make_gan_steps(model, d_img, d_3d,
                                             sample_frames=GAN_SF,
                                             prepare_fn=prepare)
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses, unchanged = [], [], []
    for i in range(GAN_WARMUP + GAN_TIMED):
        t = time.perf_counter()
        state, gm = gen_step(state, raw, 0)
        # the warm-up pairs check the disc step's codebooks
        before = _codebook_state(model) if i < GAN_WARMUP else None
        state, dm = disc_step(state, raw, 0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if before is not None:
            unchanged.append(_same_codebooks(model, before))
        losses.append({k: float(v) for k, v in {**gm, **dm}.items()})
        say("gan", t0, f"pair {i}: {times[-1]:.2f} ms " + json.dumps(losses[-1]))
    counts = read_counts()
    pairs = GAN_WARMUP + GAN_TIMED
    timed_s = sum(times[GAN_WARMUP:]) / 1e3
    result = {
        "pair_ms_median": statistics.median(times[GAN_WARMUP:]),
        "pair_ms": times,
        # counted as bench.py counts: B T frames, two steps a pair
        "frames_per_s": GAN_B * GAN_T * 2 * GAN_TIMED / timed_s,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": counts,
        "launches_per_pair": {k: v / pairs for k, v in counts.items()},
        "disc_step_left_codebooks_unchanged": unchanged,
    }
    say("gan", t0, json.dumps(result))
    for m in losses:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite GAN losses {m}")
    if not all(unchanged):
        raise AssertionError("a disc step moved the codebooks")
    if (counts["vq_assign"] != 4 * pairs or counts["vq_stats"] != 2 * pairs
            or counts["warp"] != 2 * pairs or counts["warp_backward"] != 0):
        raise AssertionError(f"launches {counts} for {pairs} GAN pairs")
    with torch.no_grad():
        held = prepare(torch.Generator(device=DEV).manual_seed(11),
                       corpus.frames, corpus.landmarks)
    result["split"] = gan_split(t0, model, d_img, d_3d, held)

    def pair(state, raw, seed=0):
        state, _ = gen_step(state, raw, seed)
        return disc_step(state, raw, seed)

    # one more pair under torch.profiler: the device's busy share
    result["profile"] = profile_step(t0, pair, state, raw)
    result["kernels"] = gan_kernel_rows(t0, gen_step, state, raw)
    return result, counts


def _disc_state(disc):
    return {k: v.detach().cpu() for k, v in disc.state_dict().items()}


def _param_diffs(a, b):
    """|a - b| of every entry of two dicts of CPU tensors, flattened."""
    return torch.cat([(a[k] - b[k]).abs().ravel() for k in a])


def _named_params(module):
    return {k: v.detach().cpu().clone() for k, v in module.named_parameters()}


def gan_check_part(t0):
    """A float32 mocoganhd pair without TF32 on CUDA and on the CPU from the
    same weights (drawn on the CPU), batches (prepared once on the CPU)
    and random bits: channel 32, b1, T6, 64 px, a 4-frame window,
    discriminators at ndf 8. Each step is held on its own: the disc step
    starts on both devices from the CPU's generator after the gen step,
    so that a difference the gen step is allowed does not enter the disc
    step's inputs. Tolerances as train_check's: losses 1e-3 relative;
    parameters within 2 lr (one Adam step each) everywhere and 99 %
    within 1e-5, leaving out of that share the generator's entries whose
    CPU gradient was exactly zero (dead ReLUs of the narrow random
    model, about 5 % of its entries: the CPU's step leaves them as they
    were, while the card's convolution algorithms may leave a rounding
    residue that Adam moves by up to lr); codebooks within 1e-3. On CUDA
    the disc step must leave the codebooks bitwise as they were.

    A conv bias right before an InstanceNorm has no gradient but its
    rounding, so Adam moves it +-lr in a direction either device may
    flip: those entries count in the 1 %."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames, lms, n_frames = synthetic_corpus(3, 8, GAN_CHECK_SIZE, seed=6)
    corpus = corpus_from_arrays(frames, lms, n_frames, device="cpu")
    prepare = make_resident_prepare(corpus, 1, GAN_CHECK_T)
    g = torch.Generator().manual_seed(7)
    batches = [prepare(g, corpus.frames, corpus.landmarks) for _ in range(2)]
    bits = [(1, 2, True), (2, 1, False)]
    runs = {}
    gen_after = None  # the CPU's generator after its gen step
    for dev in ("cpu", DEV):
        model = VQVAE(CHECK_CFG, dtype=torch.float32, device=dev,
                      generator=torch.Generator().manual_seed(8))
        dg = torch.Generator().manual_seed(9)
        d_img = MultiscaleDiscriminator2D(ndf=GAN_CHECK_NDF, device=dev,
                                          generator=dg)
        d_3d = MultiscaleDiscriminator3D(ndf=GAN_CHECK_NDF,
                                         n_frames=GAN_CHECK_SF, device=dev,
                                         generator=dg)
        state = gan.create_gan_state(create_train_state(model, lr=GAN_LR),
                                     d_img, d_3d, disc_lr=GAN_LR)
        gen_step, disc_step = gan.make_gan_steps(
            model, d_img, d_3d, sample_frames=GAN_CHECK_SF,
            compute_dtype=torch.float32)
        start = _named_params(model)
        state, gm = gen_step(state, {k: v.to(dev) for k, v in
                                     batches[0].items()}, bits=bits[0])
        after_gen = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
        # the gen step's gradient from Adam's first moment: after one
        # step exp_avg = (1 - b1) g
        adam = state.gen.optimizer.optimizer
        b1 = adam.param_groups[0]["betas"][0]
        grads = {k: (adam.state[p]["exp_avg"] / (1 - b1)).detach().cpu()
                 for k, p in model.named_parameters()}
        # entries whose gradient was exactly zero (Adam left them as
        # they were): a dead ReLU's weights and biases
        unmoved = {k: after_gen[k] == v for k, v in start.items()}
        if gen_after is None:
            gen_after = after_gen
        else:
            model.load_state_dict(gen_after)
        before = _codebook_state(model)
        state, dm = disc_step(state, {k: v.to(dev) for k, v in
                                      batches[1].items()}, bits=bits[1])
        runs[dev] = {"losses": {k: float(v) for k, v in {**gm, **dm}.items()},
                     "gen": after_gen, "unmoved": unmoved, "grads": grads,
                     "names": {n for n, _ in model.named_parameters()},
                     "d_img": _named_params(d_img),
                     "d_3d": _named_params(d_3d),
                     "unchanged": _same_codebooks(model, before)}
    cpu, gpu = runs["cpu"], runs[DEV]
    names = cpu["names"]
    loss_err = max(abs(gpu["losses"][k] - cpu["losses"][k])
                   / max(abs(cpu["losses"][k]), 1e-12) for k in cpu["losses"])
    # the generator's entries that the CPU's step moved: where the CPU's
    # gradient is exactly zero the card's may be a rounding residue
    # (another convolution algorithm), which Adam moves by up to lr
    moved = torch.cat([~cpu["unmoved"][k].ravel() for k in sorted(names)])
    gen_diffs = _param_diffs({k: gpu["gen"][k] for k in sorted(names)},
                             {k: cpu["gen"][k] for k in sorted(names)})
    parts = {
        "gen": gen_diffs[moved],
        "d_img": _param_diffs(gpu["d_img"], cpu["d_img"]),
        "d_3d": _param_diffs(gpu["d_3d"], cpu["d_3d"])}
    diffs = torch.cat([gen_diffs] + list(parts.values())[1:])
    # the generator's tensors with the largest share of entries apart
    worst = sorted(((float(((gpu["gen"][k] - cpu["gen"][k]).abs() > 1e-5)
                            .float().mean()), k, gpu["gen"][k].numel())
                    for k in names), reverse=True)[:6]
    cb_err = max(float((gpu["gen"][k] - cpu["gen"][k]).abs().max())
                 for k in cpu["gen"] if k not in names)
    held = torch.cat(list(parts.values()))
    # the entries left out of the 99 % share: the card's gradient there
    # beside the float32 rounding of its tensor's gradient norm
    residue = []
    for k in sorted(names):
        left = cpu["unmoved"][k]
        if bool(left.any()):
            g = gpu["grads"][k]
            norm = float(g.norm())
            top = float(g[left].abs().max())
            residue.append({
                "tensor": k, "left_out": int(left.sum()), "numel": g.numel(),
                "card_max_abs_g": top, "cpu_max_abs_g": float(
                    cpu["grads"][k][left].abs().max()),
                "grad_norm": norm, "grad_norm_u32": norm * U32,
                "ratio": top / (norm * U32) if norm > 0 else None})
    residue.sort(key=lambda r: -(r["ratio"] or 0.0))
    left_out = {
        "card_max_abs_g": max(r["card_max_abs_g"] for r in residue),
        "cpu_max_abs_g": max(r["cpu_max_abs_g"] for r in residue),
        "max_ratio_to_norm_u32": max(r["ratio"] or 0.0 for r in residue),
        "tensors": len(residue), "worst": residue[:8]}
    say("gan", t0, "left-out residue " + json.dumps(left_out))
    result = {"left_out_residue": left_out,
              "max_loss_rel_err": loss_err,
              "max_param_diff": float(diffs.max()),
              "share_params_within_1e-5": float((held <= 1e-5).float()
                                                .mean()),
              "share_gen_unmoved_on_cpu": float((~moved).float().mean()),
              "share_within_1e-5_by_part": {
                  k: float((v <= 1e-5).float().mean())
                  for k, v in parts.items()},
              "gen_tensors_most_apart": worst,
              "max_codebook_diff": cb_err,
              "disc_step_left_codebooks_unchanged": gpu["unchanged"],
              "losses_cuda": gpu["losses"], "losses_cpu": cpu["losses"]}
    say("gan", t0, "check " + json.dumps(result))
    if not (loss_err <= 1e-3 and result["max_param_diff"] <= 2 * GAN_LR + 1e-6
            and result["share_params_within_1e-5"] >= 0.99
            and cb_err <= 1e-3 and gpu["unchanged"]):
        raise AssertionError("CUDA and CPU GAN pairs disagree")
    return result


def _flatten(tree, prefix=""):
    """(dotted path, leaf) of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix, tree


def _gan_states_equal(a, b):
    """Every parameter, buffer and optimizer moment of two GAN states,
    bit for bit."""
    def leaves(state):
        return dict(_flatten({"model": state.gen.model.state_dict(),
                              "opt": state.gen.optimizer.state_dict(),
                              "disc": gan_cli.disc_bundle(state)}))

    la, lb = leaves(a), leaves(b)
    return la.keys() == lb.keys() and all(
        torch.equal(la[k], lb[k]) if torch.is_tensor(la[k]) else la[k] == lb[k]
        for k in la)


def _gan_records(path):
    """({step: the step's record}, {step: a validation's fd record})."""
    steps, fds = {}, {}
    with open(path) as f:
        for r in map(json.loads, f):
            (fds if "fd_vgg" in r else steps)[r["step"]] = r
    return steps, fds


def gan_cli_part(t0, work: Path):
    """The GAN CLI's main() in this process on the trainer phase's PNG
    dataset (16 videos x 24 frames at 256 px), warm-started from the
    trainer phase's step-8 checkpoint (run V), --resident_data, flagship
    widths, --train_frames 16:

      V  mocoganhd, 8 steps, validating and checkpointing at 4 and 8;
      R  V's step-4 checkpoints (generator and discriminators) resumed
         with --resume latest to step 8: bitwise equal to V (every
         parameter, buffer and optimizer moment, and the metrics of steps
         5-8);
      then mocogan, vqgan and mocoganhd --perceptual for 4 steps each,
      validating at step 4.

    Each run's records are finite and its validation prints fd_vgg and
    fd_vgg_motion; steps/s from the records' times (each written after a
    read of its step's metrics) over the steps after the first
    validation, or after step 2."""
    data = work / "data"
    ckpt_gen = _run_dir(work, "ckpt_v")

    def run(name, gan_kind, steps, *extra):
        argv = ["--data_root", str(data), "--gan", gan_kind,
                "--resident_data", "--train_frames", str(GAN_T),
                "--val_frames", str(GAN_T), "--size", str(TRAIN_SIZE),
                "--epoch", "1000", "--steps", str(steps), "--log_every", "1",
                "--ckpt", "latest", "--gen_checkpoint_dir", str(ckpt_gen),
                "--checkpoint_dir", str(work / f"gan_ckpt_{name}"),
                "--sample_folder", str(work / f"gan_samples_{name}"),
                "--metrics_path", str(work / f"gan_metrics_{name}.jsonl"),
                *extra]
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = gan_cli.main(argv, device=DEV)
        res["wall_s"] = time.perf_counter() - t
        steps_rec, fds = _gan_records(work / f"gan_metrics_{name}.jsonl")
        for r in list(steps_rec.values()) + list(fds.values()):
            vals = [v for k, v in r.items() if k not in ("step", "epoch")]
            if not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"GAN {name}: non-finite record {r}")
        if res["step"] != steps or res["fd"] is None or not all(
                math.isfinite(v) for v in res["fd"].values()):
            raise AssertionError(f"GAN {name}: step {res['step']}, "
                                 f"fd {res['fd']}")
        return res, steps_rec

    def rate(steps_rec, first):
        last = max(steps_rec)
        return (last - first) / (steps_rec[last]["time"]
                                 - steps_rec[first]["time"])

    result = {}
    zero_counts()
    v, steps_v = run("v", "mocoganhd", GAN_CLI_STEPS, "--validate_at",
                            str(GAN_CLI_RESUME_AT))
    ckpt_r = work / "gan_ckpt_r"
    (ckpt_r / "disc").mkdir(parents=True)
    for sub in ("", "disc"):
        shutil.copy(work / "gan_ckpt_v" / sub /
                    f"ckpt_{GAN_CLI_RESUME_AT:08d}.pt", ckpt_r / sub)
    r, steps_r = run("r", "mocoganhd", GAN_CLI_STEPS, "--validate_at",
                            str(GAN_CLI_RESUME_AT), "--resume", "latest")
    # the metrics of steps 5-8 (not their clock times, nor the epoch
    # index: a resumed run counts its first epoch from the restored step)
    records_equal = all(
        {k: x for k, x in steps_r[s].items() if k not in ("time", "epoch")}
        == {k: x for k, x in steps_v[s].items() if k not in ("time", "epoch")}
        for s in range(GAN_CLI_RESUME_AT + 1, GAN_CLI_STEPS + 1))
    result["mocoganhd"] = {
        "steps_per_s": rate(steps_v, GAN_CLI_RESUME_AT + 1),
        "wall_s": v["wall_s"], "fd": v["fd"],
        "resumed_wall_s": r["wall_s"],
        "resumed_records_steps": sorted(steps_r),
        "resume_bitwise_equal": _gan_states_equal(r["state"], v["state"])
        and records_equal and sorted(steps_r) == list(
            range(GAN_CLI_RESUME_AT + 1, GAN_CLI_STEPS + 1)),
        "resumed_fd_equal": r["fd"] == v["fd"]}
    say("gan", t0, "cli " + json.dumps(result["mocoganhd"]))
    for name, extra in (("mocogan", ("--gan", "mocogan")),
                        ("vqgan", ("--gan", "vqgan")),
                        ("perceptual", ("--gan", "mocoganhd",
                                        "--perceptual"))):
        res, steps_rec = run(name, extra[1], GAN_CLI_OTHER_STEPS,
                                "--validate_at", str(GAN_CLI_OTHER_STEPS),
                                *extra[2:])
        result[name] = {"steps_per_s": rate(steps_rec, 2),
                        "wall_s": res["wall_s"], "fd": res["fd"]}
        say("gan", t0, f"cli {name} " + json.dumps(result[name]))
    result["launches"] = read_counts()
    if not result["mocoganhd"]["resume_bitwise_equal"]:
        raise AssertionError("the resumed GAN run differs from the same run "
                             "continued without a break")
    return result


def gan_phase(t0, work: Path):
    step, step_counts = gan_step_part(t0)
    check = gan_check_part(t0)
    cli = gan_cli_part(t0, work)
    launches = {k: step_counts[k] + cli["launches"][k] for k in step_counts}
    return {"step": step, "check": check, "cli": cli, "launches": launches}


# -- phase 13: the three-stream b2f model ---------------------------------

B2F_FRAMES = 16  # frames a stream, at TRAIN_SIZE
B2F_CHECK = dict(channel=32, n_res_block=1, n_res_channel=8, embed_dim=16,
                 n_embed=64)
B2F_CHECK_TOL = 1e-4  # of the largest magnitude; float32, TF32 off


def _b2f_codebooks(model):
    return {k: v for k, v in model.state_dict().items()
            if k.split(".")[-1] in ("embed", "cluster_size", "embed_avg")}


def b2f_phase(t0):
    """VQVAE_B2F at the flagship widths (channel 128, 2 res blocks of 32,
    six 512x64 codebooks), three streams of 16 frames at 256 px (three
    synthetic videos as the face and hand streams, the face stream the
    target), computing in bf16 under autocast with float32 parameters and
    Adam at lr 3e-4: 2 warm-up and 5 timed training steps (forward,
    backward, Adam): step ms, peak memory, exactly 6 assignment and 6
    statistics launches a step, finite losses and codebooks. Then the
    face tower's bottom quantizer call, (65536, 64, 512), captured from
    one more forward, held against the plain version and timed; and a
    float32 training forward at narrow widths on CUDA against the CPU
    from the same weights (reconstruction and latent loss within
    B2F_CHECK_TOL of their largest magnitude, codebooks rtol 1e-4 atol
    1e-5)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    frames, _, _ = synthetic_corpus(3, B2F_FRAMES, TRAIN_SIZE, seed=9,
                                    device=DEV)
    xs = tuple(frames[i].to(torch.float32) / 127.5 - 1.0 for i in range(3))
    del frames
    model = VQVAE_B2F(dtype=torch.float32, device=DEV,
                      generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR)

    dev_type = torch.device(DEV).type

    def step():
        with torch.autocast(dev_type, dtype=torch.bfloat16):
            dec, diff = model(xs, train=True)
            loss = mse_loss(dec, xs[0]) + diff
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), diff.detach()

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, diff = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append([float(loss), float(diff)])
    counts = read_counts()
    n_steps = WARMUP_STEPS + TIMED_STEPS
    step_ms = statistics.median(times[WARMUP_STEPS:])
    result = {"step_ms_median": step_ms, "step_ms": times,
              "frames_per_s": 3 * B2F_FRAMES / (step_ms / 1e3),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "losses": losses, "launches": counts}
    if (counts["vq_assign"] != 6 * n_steps or counts["vq_stats"] != 6 * n_steps
            or counts["warp"] or counts["warp_backward"]):
        raise AssertionError(f"b2f launches {counts} for {n_steps} steps")
    if not all(math.isfinite(v) for pair in losses for v in pair) or not all(
            bool(torch.isfinite(v).all()) for v in
            _b2f_codebooks(model).values()):
        raise AssertionError("b2f: non-finite losses or codebooks")

    # the face tower's bottom call, as the step makes it
    calls = []
    plain_assign = V.vq_assign

    def capture(flat, embed):
        calls.append((flat.detach().to(torch.float32).contiguous(),
                      embed.detach().clone()))
        return plain_assign(flat, embed)

    V.vq_assign = capture
    try:
        with torch.no_grad(), torch.autocast(dev_type, dtype=torch.bfloat16):
            model(xs, train=True, update_codebooks=True)
    finally:
        V.vq_assign = plain_assign
    x, e = calls[1]
    out = vq_cuda.vq_assign(x, e)
    torch.cuda.synchronize()
    n, d = x.shape
    k = e.shape[1]
    flagged = int(vq_cuda.assign_rows_flagged(x, e)[2])
    b_ms, b_by = vq_bound_ms(n, d, k, flagged)
    graph = dict(reps=7, inner=3)
    result["bottom_call"] = {
        "shape": [n, d, k], **check_vq(x, e, out),
        "kernel_ms": device_ms(lambda: vq_cuda.vq_assign(x, e), **graph),
        "plain_ms": cuda_ms(lambda: V.vq_assign_plain(x, e), reps=7,
                            inner=3, warmup=2),
        "library_ms": device_ms(lambda: x @ e, **graph),
        "bound_ms": b_ms, "bound_by": b_by, "flagged_rows": flagged}
    del x, e, out, calls, model, opt, xs
    torch.cuda.empty_cache()

    # float32 at narrow widths: the card against the CPU
    torch.backends.cudnn.allow_tf32 = False
    cpu = VQVAE_B2F(dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(1), **B2F_CHECK)
    card = VQVAE_B2F(dtype=torch.float32, device=DEV, **B2F_CHECK)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(5)
    small = tuple(torch.rand((4, 64, 64, 3), generator=g) * 2 - 1
                  for _ in range(3))
    with torch.no_grad():
        dec, diff = card(tuple(s.to(DEV) for s in small), train=True)
        ref_dec, ref_diff = cpu(small, train=True)
    scale = float(ref_dec.abs().max())
    check = {"dec_max_abs_err": float((dec.cpu() - ref_dec).abs().max()),
             "dec_scale": scale,
             "latent_rel_err": abs(float(diff) - float(ref_diff))
             / abs(float(ref_diff)),
             "codebook_max_abs_err": max(
                 float((v.cpu() - _b2f_codebooks(cpu)[kk]).abs().max())
                 for kk, v in _b2f_codebooks(card).items())}
    result["float32_check"] = check
    torch.backends.cudnn.allow_tf32 = True
    say("b2f", t0, json.dumps(result))
    if not (check["dec_max_abs_err"] <= B2F_CHECK_TOL * scale
            and check["latent_rel_err"] <= B2F_CHECK_TOL):
        raise AssertionError(f"b2f float32 forward on the card against the "
                             f"CPU: {check}")
    for kk, v in _b2f_codebooks(card).items():
        ref = _b2f_codebooks(cpu)[kk]
        if not torch.allclose(v.cpu(), ref, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"b2f codebook {kk} on the card differs "
                                 f"from the CPU's")
    return result, counts


# -- phase 14: the tokenizer, the vanilla and the alignment trainers ------

AUX_VIDEOS, AUX_FRAMES, AUX_B = 8, 10, 2  # 4 steps an epoch at b2
AUX_ENCODE_FRAMES, AUX_ALIGN_STEPS = 32, 20


def aux_phase(t0, work: Path):
    """Three command lines' main() in this process on the card:

      cli/train_faceoff   the vanilla trainer (MSE + latent) on a PNG
                          dataset of 8 videos x 10 frames written by
                          generate_dataset: flagship widths, 256 px, b2,
                          T8, one epoch of 4 steps through the host
                          loader; no LPIPS may be built (init_lpips is
                          replaced by a function that raises), every
                          record's perceptual term is 0, and each step
                          launches 2 assignment and 2 statistics kernels
                          and no warp; frames/s over records 2-4 (the
                          step is wrapped to end in a read of its loss,
                          so each record follows its step's end);
      cli/encode          the trainer phase's step-8 checkpoint on a
                          32-frame video: the written codes equal
                          `encode_codes` of the model restored apart
                          (cli.common.restore_for_inference); --decode's
                          AVI reads back as the decoded frames, and its
                          PSNR against the input frames is printed;
      cli/train_alignment 20 steps at 256 px, 8 frames a clip, on the
                          vanilla run's dataset: first and last loss,
                          steps/s from the CLI's clock."""
    data = work / "aux_data"
    generate_dataset(str(data), AUX_VIDEOS, AUX_FRAMES, TRAIN_SIZE, seed=8,
                     device=DEV)

    def no_lpips(*args, **kwargs):
        raise AssertionError("the vanilla trainer built an LPIPS")

    make_step = vanilla_cli.make_train_step

    def read_each_step(*args, **kwargs):
        # each step ends in a read of its loss, so that the next record's
        # clock time follows the step's end
        step = make_step(*args, **kwargs)

        def run_step(state, batch, seed=0):
            state, m = step(state, batch, seed)
            float(m["loss"])
            return state, m

        return run_step

    built = trainer_cli.init_lpips
    trainer_cli.init_lpips = no_lpips
    vanilla_cli.make_train_step = read_each_step
    zero_counts()
    try:
        run = vanilla_cli.main(
            ["--data_root", str(data), "--batch_size", str(AUX_B),
             "--train_frames", str(TRAIN_T), "--val_frames", str(TRAIN_T),
             "--size", str(TRAIN_SIZE), "--epoch", "1", "--validate_at",
             "1000", "--metrics_path", str(work / "metrics_vanilla.jsonl"),
             "--checkpoint_dir", str(work / "ckpt_vanilla"),
             "--sample_folder", str(work / "samples_vanilla")], device=DEV)
    finally:
        trainer_cli.init_lpips = built
        vanilla_cli.make_train_step = make_step
    counts = read_counts()
    n_steps = AUX_VIDEOS // AUX_B
    rec = _records(work / "metrics_vanilla.jsonl")
    if run.global_step != n_steps or sorted(rec) != list(
            range(1, n_steps + 1)):
        raise AssertionError(f"vanilla trainer: {run.global_step} steps, "
                             f"records {sorted(rec)}")
    if any(r["perceptual"] != 0.0 or not math.isfinite(r["loss"])
           for r in rec.values()):
        raise AssertionError(f"vanilla trainer records {rec}")
    if (counts["vq_assign"] != 2 * n_steps or counts["vq_stats"] != 2 * n_steps
            or counts["warp"] or counts["warp_backward"]):
        raise AssertionError(f"vanilla launches {counts} for {n_steps} steps")
    span = rec[n_steps]["time"] - rec[2]["time"]
    result = {"vanilla": {
        "steps": n_steps, "frames_per_s": (n_steps - 2) * AUX_B * TRAIN_T
        / span, "losses": [rec[s]["loss"] for s in sorted(rec)],
        "launches": counts}}
    say("aux", t0, "vanilla " + json.dumps(result["vanilla"]))

    # the tokenizer on the trainer phase's step-8 checkpoint
    enc_root = work / "aux_encode"
    generate_dataset(str(enc_root), 1, AUX_ENCODE_FRAMES, TRAIN_SIZE, seed=12,
                     device=DEV)
    video_dir = enc_root / "video_000"
    argv = ["--video_dir", str(video_dir), "--checkpoint_dir",
            str(_run_dir(work, "ckpt_v")), "--ckpt", str(TRAINER_STEPS),
            "--out", str(work / "codes.npz"), "--decode",
            str(work / "recon.mp4"), "--size", str(TRAIN_SIZE),
            "--max_frames", str(AUX_ENCODE_FRAMES)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = encode_cli.main(argv, device=DEV)
    enc_s = time.perf_counter() - t
    saved = np.load(work / "codes.npz")
    restored = cli_common.restore_for_inference(
        encode_cli.build_parser().parse_args(argv), DEV).model
    with torch.no_grad():
        ref_t, ref_b = restored.encode_codes(res["video6"])
    codes_equal = (np.array_equal(saved["codes_top"], ref_t.cpu().numpy())
                   and np.array_equal(saved["codes_bottom"],
                                      ref_b.cpu().numpy()))
    # mp4v: the video read back is the encoder's reconstruction of the
    # decoded frames
    recon = read_video_frames(str(work / "recon.mp4"), device=DEV)
    decoded = torch.from_numpy(np.stack([denormalize(b) for b in
                                         res["recon"]])).to(DEV)
    *_, want = mpeg4.encode(decoded, 25, return_recon=True)
    mp4_equal = recon.shape[0] == AUX_ENCODE_FRAMES and torch.equal(recon,
                                                                    want)
    src = np.stack([load_frame(p, TRAIN_SIZE)[0]
                    for p in _landmark_paths(str(video_dir))])
    mse = float(np.mean((recon.cpu().numpy().astype(np.float64)
                         - src.astype(np.float64)) ** 2))
    result["encode"] = {
        "codes_top": list(saved["codes_top"].shape),
        "codes_bottom": list(saved["codes_bottom"].shape),
        "codes_equal_encode_codes": codes_equal,
        "mp4_equal_encoder_recon": mp4_equal, "wall_s": enc_s,
        "decode_psnr_db": 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))}
    say("aux", t0, "encode " + json.dumps(result["encode"]))
    if not (codes_equal and mp4_equal):
        raise AssertionError(f"encode: {result['encode']}")

    # the alignment trainer
    out = align_cli.main(["--data_root", str(data), "--size", str(TRAIN_SIZE),
                          "--frames", str(TRAIN_T), "--steps",
                          str(AUX_ALIGN_STEPS), "--log_every", "10",
                          "--checkpoint_dir", str(work / "ckpt_align")],
                         device=DEV)
    result["alignment"] = {"steps": out["steps"],
                           "first_loss": out["first"]["loss"],
                           "last_loss": out["last"]["loss"],
                           "steps_per_s": out["steps"] / out["seconds"]}
    say("aux", t0, "alignment " + json.dumps(result["alignment"]))
    if out["steps"] != AUX_ALIGN_STEPS or not all(
            math.isfinite(v) for v in out["last"].values()):
        raise AssertionError(f"alignment trainer: {out['steps']} steps, "
                             f"{out['last']}")
    return result, counts


# -- phase 15: one NCCL rank -----------------------------------------------

DIST_CLI_STEPS = 3
DIST_STEPS, DIST_COMPARED = 5, 2  # steps a variant; bitwise after 2 and 5


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_child(work: Path) -> int:
    """The dist phase's body, in a process of its own (`--dist-child
    WORK`), so that its NCCL group ends with it. Writes WORK/dist.json."""
    from faceoff_tpu_torch.parallel import collectives
    from faceoff_tpu_torch.parallel.mesh import make_mesh
    from faceoff_tpu_torch.train.shardmap_step import make_shardmap_train_step

    warp_cuda.build()
    vq_cuda.build()
    warp_cuda.load()
    vq_cuda.load()
    t0 = time.perf_counter()
    out = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True

    # the CLI: without --multihost, then with it (the group from its flags)
    def argv(name, *extra):
        return ["--data_root", str(work / "data"), "--validation_folder",
                str(work / "val"), "--resident_data", "--batch_size",
                str(TRAIN_B), "--train_frames", str(TRAIN_T), "--val_frames",
                str(TRAIN_T), "--size", str(TRAIN_SIZE), "--sched", "cycle",
                "--epoch", str(DIST_CLI_STEPS), "--validate_at", "1000",
                "--metrics_path", str(work / f"metrics_{name}.jsonl"),
                "--checkpoint_dir", str(work / f"ckpt_{name}"),
                "--sample_folder", str(work / f"samples_{name}"), *extra]

    zero_counts()
    single = trainer_cli.main(argv("dist_single"), device=DEV)
    counts_single = read_counts()
    zero_counts()
    multi = trainer_cli.main(argv(
        "dist_multihost", "--multihost", "--num_processes", "1",
        "--process_id", "0", "--coordinator_address",
        f"127.0.0.1:{_free_port()}"), device=DEV)
    counts_multi = read_counts()
    steps = range(1, DIST_CLI_STEPS + 1)
    out["cli"] = {
        "backend": torch.distributed.get_backend(),
        "world_size": collectives.get_world_size(),
        "multihost_reduces": multi.model.quantize_t.process_group is not None,
        "checkpoint_dir": Path(multi.ckpt.directory).name,
        "vs_single": _compare(multi, single, _records(
            work / "metrics_dist_multihost.jsonl"), _records(
            work / "metrics_dist_single.jsonl"), steps),
        "launches_single": counts_single, "launches_multihost": counts_multi}
    say("dist", t0, "cli " + json.dumps(out["cli"]))
    del single, multi
    torch.cuda.empty_cache()

    # the shardmap step against the plain step, the train phase's setting
    frames, lms, n_frames = synthetic_corpus(
        CORPUS_VIDEOS, CORPUS_FRAMES, TRAIN_SIZE, seed=3, device=DEV)
    corpus = corpus_from_arrays(frames, lms, n_frames, device=DEV)
    del frames
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}
    prepare = make_resident_prepare(corpus, TRAIN_B, TRAIN_T)
    runs = {}
    zero_counts()
    for name in ("plain", "shardmap"):
        model = VQVAE(ModelConfig(), dtype=torch.float32, device=DEV,
                      generator=torch.Generator().manual_seed(0))
        lpips = init_lpips(torch.Generator().manual_seed(1), device=DEV)
        state = create_train_state(model, make_optimizer(
            model.parameters(), TRAIN_LR, "cycle", n_iter=TRAIN_N_ITER))
        if name == "plain":
            step = make_train_step(model, lpips=lpips, prepare_fn=prepare)
        else:
            step = make_shardmap_train_step(model, make_mesh(data=1, time=1),
                                            lpips=lpips, prepare_fn=prepare)
        times, metrics, snaps = [], [], []
        for i in range(DIST_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, raw, seed=0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if i + 1 in (DIST_COMPARED, DIST_STEPS):
                snaps.append({k: v.detach().clone()
                              for k, v in model.state_dict().items()})
        runs[name] = (times, metrics, snaps)
        del model, lpips, state, step
        torch.cuda.empty_cache()
    counts = read_counts()
    (pt, pm, ps), (st, sm, ss) = runs["plain"], runs["shardmap"]
    out["step"] = {
        "plain_step_ms": statistics.median(pt[DIST_COMPARED:]),
        "shardmap_step_ms": statistics.median(st[DIST_COMPARED:]),
        "plain_step_ms_all": pt, "shardmap_step_ms_all": st,
        "bitwise_equal": pm == sm and all(
            all(torch.equal(a[k], b[k]) for k in a) for a, b in zip(ps, ss)),
        "launches": counts}
    say("dist", t0, "step " + json.dumps(out["step"]))
    out["launches"] = {k: counts_single[k] + counts_multi[k] + counts[k]
                       for k in counts}
    with open(work / "dist.json", "w") as f:
        json.dump(out, f)
    collectives.destroy()
    return 0


def dist_phase(t0, work: Path):
    """One NCCL rank, in a child process (`--dist-child`):

      cli   cli/train_faceoff_perceptual.main() at the trainer phase's
            setting (flagship, b16, T8, 256 px, --resident_data, the
            one-cycle schedule), 3 steps without --multihost, then with
            --multihost --num_processes 1 --process_id 0
            --coordinator_address 127.0.0.1:<free port> (the CLI joins an
            NCCL group and trains through the shardmap step): the two
            runs bitwise equal (parameters, codebooks, every record's
            losses and lr);
      step  make_shardmap_train_step on make_mesh(data=1, time=1) (the
            data x time step's code with one process) against
            make_train_step from the same weights, the train phase's
            setting (LPIPS in bf16,
            resident prepared batches), 5 steps each: bitwise equal after
            2 and after 5 steps, metrics too; step ms (median of steps
            3-5) of both, printed beside the train phase's.

    A one-rank all-reduce is the identity and the card's step repeats bit
    for bit (its kernels add in a fixed order), so any difference is a
    fault. NCCL refuses two ranks on one GPU: two ranks are tested on the
    CPU over gloo (tests/test_torch_parallel.py), several GPUs by
    tools/dist_check_torch.py."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--dist-child",
         str(work)], capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("[dist]"):
            print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"dist child exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    with open(work / "dist.json") as f:
        res = json.load(f)
    cli = res["cli"]
    if not (cli["backend"] == "nccl" and cli["world_size"] == 1
            and cli["multihost_reduces"]
            and cli["checkpoint_dir"].startswith("ckpt_dist_multihost_mh")):
        raise AssertionError(f"dist: the --multihost run {cli}")
    if not cli["vs_single"]["bitwise_equal"]:
        raise AssertionError("dist: the --multihost run differs from the run "
                             "without it")
    if not res["step"]["bitwise_equal"]:
        raise AssertionError("dist: the shardmap step differs from the plain "
                             "step")
    n = 2 * DIST_CLI_STEPS + 2 * DIST_STEPS
    got = res["launches"]
    if (got["vq_assign"] != 2 * n or got["vq_stats"] != 2 * n
            or got["warp"] != n or got["warp_backward"]):
        raise AssertionError(f"dist launches {got} for {n} steps")
    say("dist", t0, json.dumps({k: res["step"][k] for k in (
        "plain_step_ms", "shardmap_step_ms", "bitwise_equal")}))
    return res, got


# -- phase 16: offline preprocessing, raw footage to a training step ------


PRE_VIDEOS, PRE_FRAMES, PRE_CUT, PRE_FPS = 4, 300, 150, 25
PRE_H, PRE_W = 720, 1280
PRE_DRAW_CHUNK = 25
PRE_MIN_FRAMES = 30  # cli/preprocess's default
# the window decoder against the per-frame loop: a training window
PRE_WINDOW = 8
# kernel B against its plain version: both do the same IEEE float32 steps
# on the same integer sums (lk_cuda.py), so they should agree bit for bit
LK_TOL = 1e-3
# Kernel B's integer operations a window pixel, counted from lk.cu's
# track(). Setting up a level: three bilinear interpolations (the image,
# d/dx, d/dy), each 4 multiplies, 3 adds and a rounding shift (an add and
# a shift): 27; the three products of the 2 x 2 system: 3; their block
# sum, one add a pixel for each of the three: 3. In all 33. An iteration:
# one interpolation of the other image (9) less the window's value (1),
# the two products of the right-hand side (2) and their block sum (2): 14.
# Address arithmetic and the per-point float steps are left out, so the
# bound is a floor.
LK_OPS_SETUP, LK_OPS_ITER = 33, 14
# Kernel B is bound by latency: a point's links (window setups and
# iterations) run one after another. tools/ccl_lk_probe.cu times a chain of
# LK_CHAIN_LINKS links of the iteration without its loads (its shuffles and
# float steps) on one warp: the least time of a link.
LK_PROBE = REPO / "tools" / "ccl_lk_probe.cu"
LK_CHAIN_LINKS = 20000


def build_lk_probe() -> Path:
    """Build tools/ccl_lk_probe.cu; it includes csrc/ccl.cu and csrc/lk.cu,
    so their digest names the library."""
    digest = hashlib.sha256(ccl_cuda.SOURCE.read_bytes()
                            + lk_cuda.SOURCE.read_bytes()).hexdigest()[:8]
    return cuda_build.build(LK_PROBE, f"ccl_lk_probe_{digest}")


def lk_link_ms(links: int = LK_CHAIN_LINKS) -> float:
    """Device ms of one link of kernel B's chain (probe_link_chain on one
    warp, in a CUDA graph)."""
    lib = ctypes.CDLL(str(build_lk_probe()))
    lib.probe_link_chain.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    out = torch.empty(1, device=DEV)

    def run():
        if lib.probe_link_chain(links, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("probe_link_chain failed")
    return device_ms(run, reps=5, inner=3) / links


def lk_point_links(pa, pb, pts: torch.Tensor) -> list:
    """Each point's dependent links in kernel B (window setups and
    iterations, both directions), counted by the plain version run on that
    point alone (points are tracked independently), on CPU copies."""
    cpu = [lk_cuda.Pyramid(p.img.cpu(), p.deriv.cpu(), p.levels.cpu(),
                           p.sizes, p.win) for p in (pa, pb)]
    links = []
    for i in range(pts.shape[0]):
        work = {}
        lk_cuda.pyr_lk_plain(*cpu, pts[i: i + 1].cpu(), work=work)
        links.append(work["setups"] + work["iters"])
    return links


def pre_scene(v: int):
    """Video v of the preprocess phase's footage: its grey textured
    background (PRE_H, PRE_W, 3) uint8 on DEV and its PRE_FRAMES faces'
    landmarks (PRE_FRAMES, 68, 2) float32, as `pre_frames` draws them."""
    gen = torch.Generator(device=DEV).manual_seed(100 + v)
    noise = torch.rand((1, 1, PRE_H // 16, PRE_W // 16), generator=gen,
                       device=DEV) * 70 + 20
    grey = torch.nn.functional.interpolate(
        noise, size=(PRE_H, PRE_W), mode="bicubic", align_corners=False)
    bg = grey[0, 0].clamp(0, 255).round().to(torch.uint8)[..., None]
    bg = bg.expand(PRE_H, PRE_W, 3)
    lms = np.zeros((PRE_FRAMES, 68, 2), np.float32)
    scale = PRE_H * (0.15 + 0.008 * v)  # about 110 px at 720p
    for f in range(PRE_FRAMES):
        side = 0.33 if f < PRE_CUT else 0.67
        cx = PRE_W * (side + 0.03 * np.sin(0.05 * f + v))
        cy = PRE_H * (0.5 + 0.03 * np.cos(0.04 * f + v))
        pts = face_landmarks((cx, cy), scale, 4 * np.sin(0.03 * f))
        mouth = pts[48:68]
        lower = mouth[:, 1] > mouth[:, 1].mean()
        mouth[lower, 1] += 0.25 * scale * 0.5 * (
            1 - np.cos(2 * np.pi * f / 50))
        lms[f] = pts
    return bg, lms


def pre_frames(scene, lo: int, hi: int) -> torch.Tensor:
    """Frames lo..hi-1 (uint8 RGB on DEV) of a `pre_scene`."""
    bg, lms = scene
    return draw_faces(bg.expand(hi - lo, -1, -1, -1),
                      torch.from_numpy(lms[lo:hi]).to(DEV), (205, 165, 140))


def preprocess_footage(root: Path) -> dict:
    """PRE_VIDEOS raw motion-JPEG AVIs of PRE_W x PRE_H at PRE_FPS, each
    PRE_FRAMES frames: a face drifting over a grey textured background
    (never in the skin cluster) with its mouth opening and closing, cut
    at frame PRE_CUT to another place (two stable segments a video).
    Drawn on the card, encoded by nvJPEG. Returns seconds and bytes."""
    t = time.perf_counter()
    n_bytes = 0
    for v in range(PRE_VIDEOS):
        scene = pre_scene(v)
        bodies = []
        for lo in range(0, PRE_FRAMES, PRE_DRAW_CHUNK):
            hi = min(PRE_FRAMES, lo + PRE_DRAW_CHUNK)
            bodies += [image_io.encode_jpeg(fr)
                       for fr in pre_frames(scene, lo, hi)]
        write_avi(str(root / f"raw_{v}.avi"), bodies, PRE_W, PRE_H, PRE_FPS,
                  "mjpg")
        n_bytes += sum(len(b) for b in bodies)
    torch.cuda.synchronize()
    return {"s": time.perf_counter() - t, "bytes": n_bytes}


def zero_pre_counts():
    ccl_cuda.launches = lk_cuda.launches = 0
    ccl_cuda.launch_shapes.clear()
    image_io.jpeg_decodes = image_io.jpeg_encodes = 0


def ccl_launches_by_shape() -> dict:
    """Kernel A's launches since the counts were zeroed, by caller: the
    skin detector's batches of 720p frames and of 256 px clip frames, and
    the landmark seeds' single-frame face crops (any other size)."""
    out = {"detector_720p": 0, "detector_256px": 0, "seed_crops": 0}
    for (_, h, w), n in ccl_cuda.launch_shapes.items():
        key = ("detector_720p" if (h, w) == (PRE_H, PRE_W) else
               "detector_256px" if (h, w) == (TRAIN_SIZE, TRAIN_SIZE) else
               "seed_crops")
        out[key] += n
    return out


def read_pre_counts():
    return {"connected_components": ccl_cuda.launches,
            "connected_components_by_shape": ccl_launches_by_shape(),
            "pyr_lk": lk_cuda.launches,
            "jpeg_decodes": image_io.jpeg_decodes,
            "jpeg_encodes": image_io.jpeg_encodes}


def _timed(module, name, store):
    """module.name wrapped to add its seconds (synchronised) to store."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        store[name] = store.get(name, 0.0) + time.perf_counter() - t
        return out
    return fn, wrapper


def stage1_split(raw: Path) -> dict:
    """Stage 1's parts on one raw video, each synchronised: decode (nvJPEG
    batched, or mp4v), detect (colour, morphology, kernel A, the table),
    crop and resize, encode the clips (mp4v, as the stage writes them);
    frames/s of each."""
    from faceoff_tpu_torch.preprocess.face_crop import (segment_stable_boxes,
                                                        square_crop_box)
    from faceoff_tpu_torch.data.geometry import resize_tensor

    out = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = next(video_frame_chunks(str(raw), PRE_FRAMES, DEV))
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t
    det = HeuristicDetector(device=DEV)
    t = time.perf_counter()
    boxes = det.detect_batch(frames)
    torch.cuda.synchronize()
    out["detect_s"] = time.perf_counter() - t
    t = time.perf_counter()
    clips = []
    for start, end, box in segment_stable_boxes(boxes):
        x1, y1, x2, y2 = square_crop_box(box, frames.shape[1:3])
        clips.append(resize_tensor(frames[start:end, y1:y2, x1:x2],
                                   (TRAIN_SIZE, TRAIN_SIZE)))
    torch.cuda.synchronize()
    out["crop_resize_s"] = time.perf_counter() - t
    t = time.perf_counter()
    n_enc = 0
    for clip in clips:
        mpeg4.encode(clip, PRE_FPS)
        n_enc += len(clip)
    torch.cuda.synchronize()
    out["encode_s"] = time.perf_counter() - t
    n = frames.shape[0]
    for k in ("decode", "detect", "crop_resize"):
        out[f"{k}_frames_per_s"] = n / out[f"{k}_s"]
    out["encode_frames_per_s"] = n_enc / out["encode_s"]
    return out, frames, boxes


def ccl_row(t0, frames) -> dict:
    """Kernel A at the detector's own call (DETECT_BATCH frames of the
    phase's footage, their closed skin masks) against its plain version
    on the card: the labels and the table equal; the kernel alone (four
    launches, in a CUDA graph), the wrapper with its table and the plain
    version timed;
    the bound: the mask read once, the labels and the table written
    once."""
    from faceoff_tpu_torch.preprocess import imgproc
    from faceoff_tpu_torch.preprocess.detectors import DETECT_BATCH, skin_mask

    masks = imgproc.morph_close(skin_mask(frames[:DETECT_BATCH]), 7)
    want = ccl_cuda.connected_components_plain(masks)
    got = ccl_cuda.connected_components(masks)
    torch.cuda.synchronize()
    wrong = [name for name, g, w in zip(got._fields, got, want)
             if not torch.equal(g, w)]
    k = int(got.stats.shape[0])
    n = masks.numel()
    n_bytes = n + 4 * n + k * 7 * 8
    row = {"shape": list(masks.shape), "components": k,
           "max_abs_err": 0 if not wrong else None,
           "kernel_ms": device_ms(lambda: ccl_cuda.launch_kernel(masks)),
           "wrapper_ms": cuda_ms(lambda: ccl_cuda.connected_components(
               masks), reps=5, inner=2),
           "plain_ms": cuda_ms(lambda: ccl_cuda.connected_components_plain(
               masks), reps=3, inner=1, warmup=1),
           "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": None}
    say("preprocess", t0, "kernel A " + json.dumps(row))
    if wrong:
        raise AssertionError(f"kernel A differs from its plain version in "
                             f"{wrong}")
    return row


def lk_row(t0, clip_dir: Path) -> dict:
    """Kernel B at the tracker's own call (two consecutive 256-pixel frames
    of a written clip, the first frame's 68 landmarks) against its plain
    version on the card: statuses equal, points within LK_TOL; the
    kernel alone (one launch, in a CUDA graph), the wrapper and the plain
    version timed; the bound: the integer operations these inputs need (window setups
    and iterations counted by the plain version) over the card's float32
    CUDA-core rate (its integer units are no faster); beside it the
    latency bound: the longest point's links (`lk_point_links`) times the
    least time of a link (`lk_link_ms`)."""
    from faceoff_tpu_torch.preprocess.imgproc import rgb_to_gray

    lm_paths = _landmark_paths(str(clip_dir))[:2]
    frames = torch.stack([torch.from_numpy(load_frame(p, TRAIN_SIZE, DEV)[0])
                          for p in lm_paths]).to(DEV)
    pts = torch.from_numpy(np.load(lm_paths[0])["landmark"].astype(
        np.float32)).to(DEV)
    gray = rgb_to_gray(frames)
    pa, pb = lk_cuda.build_pyramid(gray[0]), lk_cuda.build_pyramid(gray[1])
    work = {}
    want = lk_cuda.pyr_lk_plain(pa, pb, pts, work=work)
    got = lk_cuda.pyr_lk(pa, pb, pts)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in (
        (got.fwd, want.fwd), (got.back, want.back)))
    same = bool(torch.equal(got.st_fwd, want.st_fwd)
                and torch.equal(got.st_back, want.st_back))
    win = lk_cuda.WIN * lk_cuda.WIN
    ops = win * (work["setups"] * LK_OPS_SETUP + work["iters"] * LK_OPS_ITER)
    links = lk_point_links(pa, pb, pts)
    if sum(links) != work["setups"] + work["iters"]:
        raise AssertionError(f"kernel B: the points' links {sum(links)} "
                             f"differ from the batch's {work}")
    link_ms = lk_link_ms()
    row = {"points": int(pts.shape[0]), "levels": len(pa.sizes),
           "work": work, "max_abs_err": err, "status_equal": same,
           "kernel_ms": device_ms(lambda: lk_cuda.launch_kernel(pa, pb,
                                                                pts)),
           "wrapper_ms": cuda_ms(lambda: lk_cuda.pyr_lk(pa, pb, pts)),
           "plain_ms": cuda_ms(lambda: lk_cuda.pyr_lk_plain(pa, pb, pts),
                               reps=3, inner=1, warmup=1),
           "bound_ms": ops / F32_FLOPS * 1e3, "bound_by": "operations",
           "longest_point_links": max(links), "link_ms": link_ms,
           "latency_bound_ms": max(links) * link_ms,
           "library_ms": None}
    say("preprocess", t0, "kernel B " + json.dumps(row))
    if not same or err > LK_TOL:
        raise AssertionError(f"kernel B against its plain version: statuses "
                             f"equal {same}, max |diff| {err}")
    return row


def preprocess_phase(t0, work: Path):
    """Offline preprocessing from raw 1280x720 motion-JPEG footage to one
    training step, on the card:

      footage  PRE_VIDEOS raw MJPEG AVIs of PRE_FRAMES frames (a drifting
               face, its mouth opening and closing, a cut at PRE_CUT):
               2 clips each, 8 in all;
      cli      cli/preprocess's main(["all", ...]) at 256 px (the main
               path; launch counts from 0 just before, read just after):
               8 clips, none quarantined, every clip frame with its
               landmark file; stage 1 and stage 2 seconds, kernel B's
               launches a frame and the re-detections;
      split    stage 1's parts on one video (decode, detect, crop+resize,
               encode), frames/s each;
      kernels  kernel A and kernel B against their plain versions on the
               phase's own frames, timed beside their bounds;
      read     TemporalAlignmentDataset(device=cuda) over the output, a
               window by decode_jpeg_window against the per-frame
               decode_jpeg_batch loop (ms a window), build_resident_corpus
               (each video one batched decode);
      step     one perceptual training step at the train phase's setting
               on that corpus: 2 VQ and 1 warp launches, finite losses."""
    from faceoff_tpu_torch.cli import preprocess as pre_cli
    from faceoff_tpu_torch.preprocess import detectors as det_mod
    from faceoff_tpu_torch.preprocess import face_crop, landmarks

    raw, clips = work / "pre_raw", work / "pre_clips"
    raw.mkdir()
    footage = preprocess_footage(raw)
    say("preprocess", t0, f"{PRE_VIDEOS} raw MJPEG videos of {PRE_FRAMES} "
        f"frames {PRE_W}x{PRE_H}: {footage['bytes'] / 2**20:.1f} MiB in "
        f"{footage['s']:.2f} s")

    seeds = {"n": 0}
    tracker = det_mod.ImageEvidenceLandmarker
    seed_fn = tracker._seed_one

    def counted_seed(self, frame, box):
        seeds["n"] += 1
        return seed_fn(self, frame, box)

    stages = {}
    crop_fn, crop_timed = _timed(face_crop, "process_videos", stages)
    lms_fn, lms_timed = _timed(landmarks, "generate_landmarks_for_dataset",
                               stages)
    face_crop.process_videos = crop_timed
    landmarks.generate_landmarks_for_dataset = lms_timed
    tracker._seed_one = counted_seed
    try:
        torch.cuda.synchronize()
        zero_pre_counts()
        t = time.perf_counter()
        res = pre_cli.main(["all", "--videos", str(raw), "--out", str(clips),
                            "--resolution", str(TRAIN_SIZE),
                            "--min_frames", str(PRE_MIN_FRAMES)], device=DEV)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        counts = read_pre_counts()
    finally:
        face_crop.process_videos = crop_fn
        landmarks.generate_landmarks_for_dataset = lms_fn
        tracker._seed_one = seed_fn
    n_clip_files = sum(len(list((clips / f"raw_{v}").glob("*.mp4")))
                       for v in range(PRE_VIDEOS))
    frame_files = sorted(clips.glob("**/*.jpg"))
    lm_files = sorted(clips.glob("**/*_landmarks.npz"))
    stage2_frames = len(frame_files)
    if stage2_frames != len(lm_files):
        raise AssertionError(f"preprocess: {stage2_frames} JPEG frames, "
                             f"{len(lm_files)} landmark files")
    result = {
        "main_s": main_s, "stage1_s": stages["process_videos"],
        "stage2_s": stages["generate_landmarks_for_dataset"],
        "stage1_frames_per_s": PRE_VIDEOS * PRE_FRAMES
        / stages["process_videos"],
        "stage2_frames_per_s": stage2_frames
        / stages["generate_landmarks_for_dataset"],
        "clips": len(res["clips"]), "ok": len(res["ok"]),
        "quarantined": len(res["quarantined"]),
        "clip_files": n_clip_files, "frames_written": stage2_frames,
        "landmark_files": len(lm_files), "redetections": seeds["n"],
        "pyr_lk_launches_per_frame": counts["pyr_lk"] / max(stage2_frames, 1),
        "launches": counts}
    say("preprocess", t0, json.dumps(result))
    expect = 2 * PRE_VIDEOS
    if not (result["clips"] == result["ok"] == expect
            and not result["quarantined"]):
        raise AssertionError(f"preprocess: {result['clips']} clips, "
                             f"{result['ok']} ok, {result['quarantined']} "
                             f"quarantined; expected {expect} ok")
    if stage2_frames < 0.9 * PRE_VIDEOS * PRE_FRAMES:
        raise AssertionError(f"preprocess: {stage2_frames} frames, "
                             f"{len(lm_files)} landmark files")
    if not counts["connected_components"] or not counts["pyr_lk"]:
        raise AssertionError(f"preprocess: the kernels did not run on the "
                             f"main path: {counts}")
    for p in lm_files[:: max(1, len(lm_files) // 50)]:
        lm = np.load(p)["landmark"]
        if lm.shape != (68, 2) or not np.isfinite(lm).all() or (
                lm.min() < -TRAIN_SIZE or lm.max() > 2 * TRAIN_SIZE):
            raise AssertionError(f"preprocess: landmarks of {p}: {lm.shape} "
                                 f"in [{lm.min()}, {lm.max()}]")

    split, frames, _ = stage1_split(raw / "raw_0.avi")
    result["stage1_split"] = split
    say("preprocess", t0, "stage 1 split " + json.dumps(split))
    result["ccl"] = ccl_row(t0, frames)
    del frames
    result["lk"] = lk_row(t0, sorted(p for p in clips.glob("raw_0/*")
                                     if p.is_dir())[0])

    ds = TemporalAlignmentDataset(str(clips), "train", TRAIN_T,
                                  resolution=TRAIN_SIZE, device=DEV)
    item = ds.get_item(0, np.random.default_rng(0))
    if not all(np.isfinite(v).all() for v in item.values()):
        raise AssertionError("preprocess: a non-finite dataset item")
    window = [str(p).replace(".jpg", "_landmarks.npz")
              for p in sorted(Path(ds.videos[0]).glob("*.jpg"))[:PRE_WINDOW]]
    images = [w.replace("_landmarks.npz", ".jpg") for w in window]

    def host_ms(fn, reps=15):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    via_window = image_io.decode_jpeg_window(images, TRAIN_SIZE, DEV)
    per_frame = torch.stack(image_io.decode_jpeg_batch(images, DEV))
    if not torch.equal(via_window, per_frame):
        raise AssertionError("preprocess: decode_jpeg_window differs from "
                             "decode_jpeg_batch")
    result["window_ms"] = host_ms(
        lambda: image_io.decode_jpeg_window(images, TRAIN_SIZE, DEV))
    result["per_frame_loop_ms"] = host_ms(
        lambda: image_io.decode_jpeg_batch(images, DEV))
    t = time.perf_counter()
    corpus = build_resident_corpus(ds, device=DEV)
    torch.cuda.synchronize()
    result["corpus_stage_s"] = time.perf_counter() - t
    say("preprocess", t0, f"dataset: {len(ds)} videos, corpus "
        f"{tuple(corpus.frames.shape)} staged in "
        f"{result['corpus_stage_s']:.2f} s; window of {PRE_WINDOW}: "
        f"{result['window_ms']:.3f} ms batched, "
        f"{result['per_frame_loop_ms']:.3f} ms frame by frame")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=DEV,
                  generator=torch.Generator().manual_seed(0))
    lpips = init_lpips(torch.Generator().manual_seed(1), device=DEV)
    state = create_train_state(model, make_optimizer(
        model.parameters(), TRAIN_LR, "cycle", n_iter=TRAIN_N_ITER))
    step = make_train_step(model, lpips=lpips, prepare_fn=make_resident_prepare(
        corpus, TRAIN_B, TRAIN_T))
    zero_counts()
    state, metrics = step(state, {"frames": corpus.frames,
                                  "landmarks": corpus.landmarks}, seed=0)
    torch.cuda.synchronize()
    step_counts = read_counts()
    losses = {k: float(v) for k, v in metrics.items()}
    result["step"] = {"losses": losses, "launches": step_counts}
    say("preprocess", t0, "training step " + json.dumps(result["step"]))
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"preprocess: non-finite losses {losses}")
    if (step_counts["vq_assign"], step_counts["vq_stats"],
            step_counts["warp"]) != (2, 2, 1):
        raise AssertionError(f"preprocess: step launches {step_counts}")
    return result, counts


# -- phase 18: mp4 in and out ---------------------------------------------

MP4_FIXTURE = REPO / "tests" / "data_torch" / "face_mp4v.mp4"
MP4_STAGES = ("dequant_idct", "motion_compensate", "motion_search",
              "fdct_quant")
MP4_PLAIN = {name: getattr(mpeg4_cuda, name + "_plain")
             for name in MP4_STAGES}
# each byte of a 16 x 16 SAD is an absolute difference and an add; the
# integer units are no faster than the float32 CUDA cores
MP4_SAD_OPS = 2
# V4: two 8-term integer dot products a coefficient (rows, then columns)
MP4_FDCT_OPS = 2 * 2 * 8
# V3's second bound, from its SASS: one VABSDIFF4 (PTX vabsdiff4.add) sums
# the absolute differences of four bytes into an accumulator. The card
# issues it at the rate of IMAD (tools/mp4_variants_torch.py's rates: 8
# independent chains a thread, within 3 % of IMAD's and about half float32
# FMA's), which the CUDA programming guide gives as 64 a clock an SM on
# compute capability 9.0; at the clock F32_FLOPS assumes
H100_SMS = 132
H100_CLOCK_HZ = F32_FLOPS / (H100_SMS * 128 * 2)
MP4_VABSDIFF4_PER_CLOCK_SM = 64


def zero_mp4_counts():
    for k in mpeg4_cuda.launches:
        mpeg4_cuda.launches[k] = 0


def read_mp4_counts():
    return dict(mpeg4_cuda.launches)


class Mp4Calls:
    """The four stage wrappers of ops/mpeg4_cuda wrapped: with `hold`,
    each call also runs the plain version on the same inputs (clones of
    the planes V2 writes in place) and must equal it bit for bit; every
    call's arguments are kept as that stage's `last`, the largest call's
    (by its first dimension) as its `largest`."""

    def __init__(self, hold: bool):
        self.hold = hold
        self.held = {k: 0 for k in MP4_STAGES}
        self.largest = {}
        self.orig = {k: getattr(mpeg4_cuda, k) for k in MP4_STAGES}

    def __enter__(self):
        for name in MP4_STAGES:
            setattr(mpeg4_cuda, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(mpeg4_cuda, name, fn)

    def _size(self, name, args):
        """The call's items (V2-V4) or blocks (V1)."""
        return int(args[{"dequant_idct": 0, "motion_compensate": 3,
                         "motion_search": 1, "fdct_quant": 3}[name]]
                   .shape[0])

    def _wrap(self, name):
        fn = self.orig[name]

        def run(*args):
            size = self._size(name, args)
            if size >= self.largest.get(name, (0, None))[0]:
                self.largest[name] = (size, args)
            if not self.hold:
                return fn(*args)
            if name == "motion_compensate":
                planes = [p.clone() for p in args[0]]
                MP4_PLAIN[name](planes, *args[1:])
                out = fn(*args)
                same = all(torch.equal(a, b) for a, b in zip(args[0], planes))
            elif name == "dequant_idct":
                want = MP4_PLAIN[name](*args[:3], args[3].clone())
                out = fn(*args)
                same = torch.equal(out, want)
            else:
                out = fn(*args)
                same = torch.equal(out, MP4_PLAIN[name](*args))
            if not same:
                raise AssertionError(f"mp4: kernel {name} differs from its "
                                     f"plain version at the path's call")
            self.held[name] += 1
            return out
        return run


def mp4_bound(name, args) -> tuple:
    """(bound ms, "bytes" or "operations") of one call: what this call's
    data makes the kernel read, each byte once, and write, over the HBM
    rate, its operations over the float32 CUDA-core rate. Of a
    macroblock's record V1 and V4 read the mode and qp, V2 the mode and,
    for an inter macroblock with a reference, the four vectors; only
    inter macroblocks read the reference (V2) or prediction (V4)."""
    if name == "dequant_idct":
        blocks, bidx, mb, _ = args
        nb = blocks.shape[0]
        coded = int(torch.unique(bidx // 6).numel())
        n_bytes = 2 * nb * 64 * 2 + nb * 4 + coded * 2 * 4
        ops = nb * 64 * (2 + 16)  # dequantisation; rows and columns
    elif name == "motion_compensate":
        planes, mb, res, items = args[:4]
        mbs = items.shape[0] * mb.shape[1]
        rec = mb[items[:, 0].long()]
        inter = int(((rec[..., 0] != mpeg4_cuda.MB_INTRA)
                     & (items[:, 1:2] >= 0)).sum())
        area = sum(p[0].numel() for p in planes) // mb.shape[1]  # 384
        n_bytes = mbs * (area + 4) + inter * (8 * 4 + area)
        if res is not None:
            n_bytes += mbs * 6 * 64 * 2
        ops = mbs * area * 8  # four taps, their sum, the residual, a clip
    elif name == "motion_search":
        y, items = args[:2]
        g = items.shape[0]
        m = y[0].numel() // 256
        n_bytes = 2 * g * y[0].numel() + g * m * 3 * 4
        cands = (2 * mpeg4_cuda.SEARCH_RANGE + 1) ** 2 + 9
        ops = g * m * cands * 256 * MP4_SAD_OPS
    else:
        src, pred, mb, items = args
        mbs = items.shape[0] * mb.shape[1]
        inter = int((mb[..., 0] != mpeg4_cuda.MB_INTRA).sum())
        area = sum(p[0].numel() for p in src) // mb.shape[1]  # 384
        n_bytes = (mbs * (area + 2 * 4 + 6 * 64 * 2) + inter * area)
        ops = mbs * 6 * 64 * MP4_FDCT_OPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mp4_wide_share(args) -> dict:
    """The share of a V1 call's blocks, and of their columns, whose column
    pass the kernel runs in 64 bits (some |column input| above
    mpeg4_cuda.COL_SAFE), from the plain row pass."""
    blocks, bidx, mb, _ = args
    qp, intra, luma = mpeg4_cuda._block_params(bidx, mb)
    rows = mpeg4_cuda._idct_rows(mpeg4_cuda.dequantize_plain(
        blocks, qp, intra, luma).view(-1, 8, 8))
    wide = rows.abs().amax(1) > mpeg4_cuda.COL_SAFE  # (blocks, columns)
    return {"blocks": float(wide.any(1).float().mean()),
            "columns": float(wide.float().mean())}


def mp4_sass_bound(args) -> float:
    """V3's bound in ms from its SAD instruction, for the arguments of a
    motion_search call: a VABSDIFF4 for every four bytes of every
    candidate's 16 x 16 SAD (the integer candidates and the eight
    half-pel ones), at the card's issue rate for it."""
    y, items = args[:2]
    m = y[0].numel() // 256
    cands = (2 * mpeg4_cuda.SEARCH_RANGE + 1) ** 2 + 9
    n = items.shape[0] * m * cands * 256 // 4
    return n / (H100_SMS * MP4_VABSDIFF4_PER_CLOCK_SM * H100_CLOCK_HZ) * 1e3


def mp4_round_trip(frames: torch.Tensor, path: Path, fps: int,
                   host: dict) -> dict:
    """Encode (N, H, W, 3) uint8 frames on the card into an mp4v file,
    read it back through read_video_frames: the decode must equal the
    encoder's reconstruction bit for bit. Seconds of each way, the host
    coder's share (timed around ops/mpeg4_cuda's C++ calls, their
    record copies included), bytes a frame, PSNR against the frames."""
    n = frames.shape[0]
    start = dict(host)
    torch.cuda.synchronize()
    t = time.perf_counter()
    samples, sync, dsi, recon = mpeg4.encode(frames, fps, return_recon=True)
    mp4.write_mp4(str(path), samples, sync, frames.shape[2],
                  frames.shape[1], fps, dsi)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    back = read_video_frames(str(path), device=DEV)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t
    if back.shape != frames.shape or not torch.equal(back, recon):
        raise AssertionError(f"mp4 {path.name}: the decode differs from the "
                             f"encoder's reconstruction")
    sq = ((back.float() - frames.float()) ** 2).mean((1, 2, 3))
    psnr = (10 * torch.log10(255.0 ** 2 / sq.clamp_min(1e-12))).mean()
    return {"frames": n, "encode_s": enc_s, "decode_s": dec_s,
            "write_host_s": host.get("write_vops", 0.0)
            - start.get("write_vops", 0.0),
            "parse_host_s": host.get("parse_vops", 0.0)
            - start.get("parse_vops", 0.0),
            "bytes": sum(len(x) for x in samples), "psnr_db": float(psnr)}


def mp4_phase(t0, work: Path, pre: dict):
    """mp4 in and out on the card (io/mp4.py, io/mpeg4.py, kernels V1-V4
    of csrc/mpeg4.cu and its C++ entropy coder):

      fixture   tests/data_torch/face_mp4v.mp4 (cv2's mp4v, 24 frames of
                104 px) decoded on the card: equal to the plain decode
                (the Python coder and the plain stages on the CPU) and
                to cv2's stored decode, bit for bit (the tolerance of
                tests/test_torch_mp4.py, 0);
      footage   the preprocess phase's 4 x 300 frames at 1280x720 (its
                MJPEG AVIs decoded by nvJPEG) written as mp4v on the card
                and read back through read_video_frames (the main path;
                launch counts from 0 just before, read just after): each
                decode equal to the encoder's reconstruction; encode and
                decode frames/s, the host coder's share, bytes a frame,
                PSNR;
      held      V1-V4 against their plain versions at every call of the
                round trip of the first GOP of one 720p video and of one
                256-px clip, bit for bit;
      kernels   each kernel at the main path's largest call: device ms
                in a CUDA graph, wrapper ms eager, the plain version's
                ms, launches a frame, bound;
      preprocess cli/preprocess's main(["all", ...]) on one 720p mp4v
                video: NNNNN.mp4 clips, none quarantined; stage 1 and 2
                frames/s beside the AVI run's."""
    from faceoff_tpu_torch.cli import preprocess as pre_cli
    from faceoff_tpu_torch.preprocess import face_crop, landmarks

    result = {}
    track = mp4.read_mp4(str(MP4_FIXTURE))
    vol = mpeg4.parse_vol(track.dsi)
    got = read_video_frames(str(MP4_FIXTURE), device=DEV)
    plain = mpeg4.decode(track.samples, vol, torch.device("cpu"))
    cv2_decode = torch.from_numpy(np.load(
        MP4_FIXTURE.with_suffix(".npz"))["frames"])
    result["fixture"] = {
        "frames": int(got.shape[0]),
        "equal_plain_decode": bool(torch.equal(got.cpu(), plain)),
        "max_abs_diff_cv2": int((got.cpu().int() - cv2_decode.int()).abs()
                                .max())}
    say("mp4", t0, "fixture " + json.dumps(result["fixture"]))
    if not result["fixture"]["equal_plain_decode"] or result["fixture"][
            "max_abs_diff_cv2"] != 0:
        raise AssertionError(f"mp4 fixture: {result['fixture']}")

    host = {}
    wrapped = []
    for name in ("parse_vops", "write_vops"):
        fn, timed = _timed(mpeg4_cuda, name, host)
        wrapped.append((name, fn))
        setattr(mpeg4_cuda, name, timed)
    out = work / "mp4"
    out.mkdir()
    try:
        # the main path: 4 x 300 frames at 720p
        raws = [read_video_frames(str(work / "pre_raw" / f"raw_{v}.avi"),
                                  device=DEV) for v in range(PRE_VIDEOS)]
        rows = []
        zero_mp4_counts()
        with Mp4Calls(hold=False) as calls:
            for v, frames in enumerate(raws):
                rows.append(mp4_round_trip(frames, out / f"raw_{v}.mp4",
                                           PRE_FPS, host))
        counts = read_mp4_counts()
        largest = calls.largest
        n = sum(r["frames"] for r in rows)
        enc_s = sum(r["encode_s"] for r in rows)
        dec_s = sum(r["decode_s"] for r in rows)
        write_s = sum(r["write_host_s"] for r in rows)
        parse_s = sum(r["parse_host_s"] for r in rows)
        result["footage"] = {
            "videos": len(rows), "frames": n,
            "size": [PRE_W, PRE_H],
            "encode_frames_per_s": n / enc_s,
            "decode_frames_per_s": n / dec_s,
            "encode_host_share": write_s / enc_s,
            "decode_host_share": parse_s / dec_s,
            "encode_host_s": write_s, "encode_s": enc_s,
            "decode_host_s": parse_s, "decode_s": dec_s,
            "bytes_per_frame": sum(r["bytes"] for r in rows) / n,
            "psnr_db": statistics.mean(r["psnr_db"] for r in rows),
            "launches": counts,
            "launches_per_frame": {k: v / n for k, v in counts.items()}}
        say("mp4", t0, "720p " + json.dumps(result["footage"]))
        if not all(counts.values()):
            raise AssertionError(f"mp4: a kernel did not run on the main "
                                 f"path: {counts}")

        # 256 px: the trainer's sample streams' size
        small = draw_faces(torch.zeros((48, TRAIN_SIZE, TRAIN_SIZE, 3),
                                       dtype=torch.uint8, device=DEV) + 90,
                           torch.from_numpy(np.stack([face_landmarks(
                               (128 + 20 * np.sin(0.1 * f), 128), 70, 0)
                               for f in range(48)]).astype(np.float32))
                           .to(DEV), (205, 165, 140))
        result["256"] = mp4_round_trip(small, out / "small.mp4", PRE_FPS,
                                       host)
        r = result["256"]
        r.update(encode_frames_per_s=r["frames"] / r["encode_s"],
                 decode_frames_per_s=r["frames"] / r["decode_s"],
                 bytes_per_frame=r["bytes"] / r["frames"])
        say("mp4", t0, "256 px " + json.dumps(r))

        # V1-V4 against their plain versions on the first GOPs
        with Mp4Calls(hold=True) as held:
            mp4_round_trip(raws[0][: mpeg4.GOP], out / "gop720.mp4", PRE_FPS,
                           host)
            mp4_round_trip(small[: mpeg4.GOP], out / "gop256.mp4", PRE_FPS,
                           host)
        result["held_calls"] = held.held
        say("mp4", t0, "kernels equal their plain versions at "
            + json.dumps(held.held) + " calls")
        if not all(held.held.values()):
            raise AssertionError(f"mp4: a kernel was not held: {held.held}")
    finally:
        for name, fn in wrapped:
            setattr(mpeg4_cuda, name, fn)
    del raws

    rows = {}
    frames_by = {"dequant_idct": 2 * n, "motion_compensate": 2 * n,
                 "motion_search": n, "fdct_quant": n}
    for name in MP4_STAGES:
        size, args = largest[name]
        fn = getattr(mpeg4_cuda, name)
        if name == "motion_compensate":
            planes = [p.clone() for p in args[0]]
            MP4_PLAIN[name](planes, *args[1:])
            fn(*args)
            err = max(int((a.int() - b.int()).abs().max())
                      for a, b in zip(args[0], planes))
        elif name == "dequant_idct":
            want = MP4_PLAIN[name](*args[:3], args[3].clone())
            err = int((fn(*args).int() - want.int()).abs().max())
        else:
            err = int((fn(*args).int() - MP4_PLAIN[name](*args).int())
                      .abs().max())
        bound, by = mp4_bound(name, args)
        rows[name] = {
            "items": size, "max_abs_err": err,
            "kernel_ms": device_ms(lambda: fn(*args), reps=10, inner=5),
            "wrapper_ms": cuda_ms(lambda: fn(*args), reps=5, inner=3),
            "plain_ms": cuda_ms(lambda: MP4_PLAIN[name](*args), reps=1,
                                inner=1, warmup=0),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            # the main path's launches a frame (V1 and V2 run in both
            # ways)
            "launches_per_frame": counts[name] / frames_by[name]}
        if name == "motion_search":
            rows[name]["sass_bound_ms"] = mp4_sass_bound(args)
        if name == "dequant_idct":
            rows[name]["wide_share"] = mp4_wide_share(args)
        say("mp4", t0, f"{name} " + json.dumps(rows[name]))
        if err:
            raise AssertionError(f"mp4: {name} differs from its plain "
                                 f"version by {err}")
    result["kernels"] = rows

    # preprocessing from one 720p mp4v video
    raw_mp4, clips = work / "mp4_raw", work / "mp4_clips"
    raw_mp4.mkdir()
    shutil.copy(out / "raw_0.mp4", raw_mp4 / "raw_0.mp4")
    stages = {}
    crop_fn, crop_timed = _timed(face_crop, "process_videos", stages)
    lms_fn, lms_timed = _timed(landmarks, "generate_landmarks_for_dataset",
                               stages)
    face_crop.process_videos = crop_timed
    landmarks.generate_landmarks_for_dataset = lms_timed
    try:
        res = pre_cli.main(["all", "--videos", str(raw_mp4), "--out",
                            str(clips), "--resolution", str(TRAIN_SIZE),
                            "--min_frames", str(PRE_MIN_FRAMES)], device=DEV)
    finally:
        face_crop.process_videos = crop_fn
        landmarks.generate_landmarks_for_dataset = lms_fn
    clip_files = sorted(p.name for p in (clips / "raw_0").glob("*"))
    frame_files = sorted(clips.glob("**/*.jpg"))
    result["preprocess"] = {
        "clips": len(res["clips"]), "ok": len(res["ok"]),
        "quarantined": len(res["quarantined"]), "clip_files": clip_files,
        "stage1_frames_per_s": PRE_FRAMES / stages["process_videos"],
        "stage2_frames_per_s": len(frame_files)
        / stages["generate_landmarks_for_dataset"],
        "avi_stage1_frames_per_s": pre["stage1_frames_per_s"],
        "avi_stage2_frames_per_s": pre["stage2_frames_per_s"]}
    say("mp4", t0, "preprocess " + json.dumps(result["preprocess"]))
    mp4_clips = [c for c in clip_files if c.endswith(".mp4")]
    if not (result["preprocess"]["clips"] == result["preprocess"]["ok"]
            == 2 == len(mp4_clips) and not res["quarantined"]
            and mp4_clips == ["00000.mp4", "00001.mp4"]):
        raise AssertionError(f"mp4 preprocess: {result['preprocess']}")
    return result, counts


# -- phase 17: the postnets over a clip sharded in time -------------------

TIME_T, TIME_BLOCKS = 64, 4
# max |diff| against the whole clip, as a share of the largest |value|:
# float32 without TF32 (the same products, summed by other algorithms of
# cuDNN: some 3456 terms a sum, three layers), and bf16 under autocast
# (both paths round the same fp32 sums to bf16; four bf16 ulps)
TIME_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def time_phase(t0):
    """Phase 17 (module docstring): returns {postnet_dtype: the output's
    and the input gradient's max |diff| and largest |value|}."""
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=DEV,
                  generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=DEV).manual_seed(7)
    tf32 = torch.backends.cudnn.allow_tf32
    out = {}
    zero_counts()
    try:
        torch.backends.cudnn.allow_tf32 = False
        for name, post, hw in (
                ("postnet_b", model.conv3d_encoded_b, TRAIN_SIZE // 4),
                ("postnet_t", model.conv3d_encoded_t, TRAIN_SIZE // 8)):
            shape = (1, model.channel, TIME_T, hw, hw)
            x = torch.randn(shape, generator=gen, device=DEV)
            g = torch.randn(shape, generator=gen, device=DEV)
            for dtype, tol in TIME_TOL.items():
                def run(blocks):
                    xi = x.clone().requires_grad_()
                    with torch.autocast("cuda", dtype=dtype,
                                        enabled=dtype != torch.float32):
                        if blocks:
                            y = torch.cat(postnet_over_shards(
                                post, xi.chunk(TIME_BLOCKS, dim=2)), dim=2)
                        else:
                            y = post(xi)
                    (y.float() * g).sum().backward()
                    return y.detach().float(), xi.grad

                want_y, want_g = run(False)
                got_y, got_g = run(True)
                row = {}
                for what, got, want in (("output", got_y, want_y),
                                        ("input_grad", got_g, want_g)):
                    big = float(want.abs().max())
                    err = float((got - want).abs().max())
                    row[f"{what}_max_abs_diff"] = err
                    row[f"{what}_max_abs"] = big
                    if not (torch.isfinite(got).all() and err <= tol * big):
                        raise AssertionError(
                            f"time: {name} {dtype} {what} differs by {err} "
                            f"(largest |value| {big}, tolerance {tol})")
                out[f"{name}_{str(dtype).split('.')[-1]}"] = row
                del want_y, want_g, got_y, got_g
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"time: kernels launched {counts}")
    say("time", t0, json.dumps(out))
    return out



# -- phase 19: the train phase's step with --no_pallas -------------------

NP_STEPS = 2  # float32 steps of each route
NP_BF16_STEPS = 4  # steps of each bf16 --no_pallas run; the last 2 timed
NP_CLI_STEPS = 2
# the float32 routes differ only in the VQ statistics' order of summation
# (and in a row whose two best codes tie within float32 rounding): the
# losses and codebooks are held as train_check and the trainer phase hold
# two runs (losses 1e-3 relative; codebooks 1e-3 of max(1, |value|), the
# EMA sums reaching 1e4 at 524288 rows); parameters within 2 lr a step,
# 99 % within 1e-5
NP_LOSS_TOL = NP_CODEBOOK_TOL = 1e-3


def _model_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _record_assign(name, store):
    """Replace V.<name> (`vq_assign` or `vq_assign_plain`) by a wrapper
    that keeps each call's inputs and indices; returns the original."""
    original = getattr(V, name)

    def wrapper(flat, embed):
        out = original(flat, embed)
        store.append((flat.detach().to(torch.float32).clone(),
                      embed.detach().to(torch.float32).clone(),
                      out[0].clone()))
        return out

    setattr(V, name, wrapper)
    return original


def _tie_rows(x, e, idx_a, idx_b):
    """(rows of x whose codes differ between the two assignments, how many
    of them score further apart than two of check_vq's tie margins: each
    float32 pick lies within one margin of the exact best, so two picks of
    one row lie within two)."""
    differ = idx_a != idx_b
    n = int(differ.sum())
    if n == 0:
        return 0, 0
    xs, d = x[differ], x.shape[1]
    hn = 0.5 * (e * e).sum(0)
    scores = xs @ e - hn
    margin = 2 * (d + 1) * U32 * (xs.abs() @ e.abs() + hn).amax(1)
    sa = scores.gather(1, idx_a[differ].long()[:, None])[:, 0]
    sb = scores.gather(1, idx_b[differ].long()[:, None])[:, 0]
    return n, int(((sa - sb).abs() > 2 * margin).sum())


def _expect_launches(what, counts, steps, vq_calls):
    """`vq_calls` VQ assignment+statistics calls a step (2, or 0 on the
    plain route), one warp a step, no warp backward."""
    want = {"vq_assign": vq_calls * steps, "vq_stats": vq_calls * steps,
            "warp": steps, "warp_backward": 0}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def no_pallas_phase(t0, work: Path):
    """Phase 19 (module docstring). Returns (result, the launch counts of
    the --no_pallas runs)."""
    frames, lms, n_frames = synthetic_corpus(
        CORPUS_VIDEOS, CORPUS_FRAMES, TRAIN_SIZE, seed=3, device=DEV)
    corpus = corpus_from_arrays(frames, lms, n_frames, device=DEV)
    del frames
    prepare = make_resident_prepare(corpus, TRAIN_B, TRAIN_T)
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}

    def build(use_kernels, dtype):
        model = VQVAE(ModelConfig(use_pallas_vq=use_kernels),
                      dtype=torch.float32, device=DEV,
                      generator=torch.Generator().manual_seed(0))
        lpips = init_lpips(torch.Generator().manual_seed(1), device=DEV,
                           dtype=dtype)
        opt = make_optimizer(model.parameters(), TRAIN_LR, "cycle",
                             n_iter=TRAIN_N_ITER)
        step = make_train_step(model, lpips=lpips, prepare_fn=prepare,
                               compute_dtype=dtype)
        return model, create_train_state(model, opt), step

    # float32 without TF32: the kernel route against the plain route
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    routes = {}
    try:
        for route, use in (("kernels", True), ("plain", False)):
            model, state, step = build(use, torch.float32)
            name = "vq_assign" if use else "vq_assign_plain"
            calls, losses = [], []
            zero_counts()
            for i in range(NP_STEPS):
                # the first step's two assignments, on the same inputs
                original = _record_assign(name, calls) if i == 0 else None
                try:
                    state, m = step(state, raw, seed=0)
                finally:
                    if original is not None:
                        setattr(V, name, original)
                losses.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            counts = read_counts()
            _expect_launches(f"no_pallas {route} float32", counts, NP_STEPS,
                             2 if use else 0)
            routes[route] = {
                "losses": losses, "state": _model_state(model),
                "params": {n for n, _ in model.named_parameters()},
                "calls": calls, "launches": counts}
            del model, state, step
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    ker, pl = routes["kernels"], routes["plain"]
    assign = {}
    moved = {}  # codes a differing row moved between, by level
    for level, a, b in zip(("quantize_t", "quantize_b"), ker["calls"],
                           pl["calls"]):
        n_diff, outside = _tie_rows(b[0], b[1], a[2], b[2])
        differ = a[2] != b[2]
        moved[level] = torch.unique(torch.cat([a[2][differ], b[2][differ]]))
        assign[level] = {"rows": int(b[0].shape[0]),
                         "same_inputs": bool(torch.equal(a[0], b[0])
                                             and torch.equal(a[1], b[1])),
                         "rows_differing": n_diff,
                         "share_differing": n_diff / int(b[0].shape[0]),
                         "differing_outside_tie_margin": outside}
    # the plain statistics at the step's bottom call beside the kernel,
    # the atomics of index_add_ and index_put_'s sorted sums
    x, _, idx = pl["calls"][1]
    n_embed = ModelConfig().n_embed
    idx64 = idx.long()
    counts = torch.bincount(idx64, minlength=n_embed)
    reps = dict(reps=5, inner=1, warmup=1)
    again = (V.vq_stats(x, idx, n_embed), V.vq_stats(x, idx, n_embed))
    stats = {
        "shape": list(x.shape) + [n_embed],
        "codes_used": int((counts > 0).sum()),
        "largest_code_share": float(counts.max() / x.shape[0]),
        "plain_ms": cuda_ms(lambda: V.vq_stats(x, idx, n_embed), **reps),
        "plain_repeats_bitwise": bool(torch.equal(again[0][1],
                                                  again[1][1])),
        "kernel_ms": cuda_ms(lambda: vq_cuda.code_stats(x, idx, n_embed),
                             **reps),
        "index_add_ms": cuda_ms(lambda: torch.zeros(
            (n_embed, x.shape[1]), device=DEV).index_add_(0, idx64, x),
            **reps),
        "index_put_sorted_ms": cuda_ms(lambda: torch.zeros(
            (n_embed, x.shape[1]), device=DEV).index_put_(
                (idx64,), x, accumulate=True), **reps)}
    del x, idx, idx64, again
    sd_k, sd_p = ker["state"], pl["state"]
    diffs = torch.cat([(sd_k[k] - sd_p[k]).abs().ravel().cpu()
                       for k in ker["params"]])
    cb_err = 0.0
    for k in sd_k:
        if k in ker["params"]:
            continue
        err = (sd_k[k] - sd_p[k]).abs() / sd_p[k].abs().clamp_min(1)
        # a code that a tied row moved between is left out
        keep = torch.ones(err.shape[-1], dtype=torch.bool, device=err.device)
        keep[moved[k.split(".")[0]]] = False
        cb_err = max(cb_err, float(err[..., keep].max()))
    keys = ("loss", "mse", "latent", "perceptual")
    float32 = {
        "assignment": assign,
        "max_loss_rel_err": max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                                for a, b in zip(ker["losses"], pl["losses"])
                                for k in keys),
        "max_param_diff": float(diffs.max()),
        "share_params_within_1e-5": float((diffs <= 1e-5).float().mean()),
        "max_codebook_scaled_diff": cb_err,
        "codebooks_bitwise_equal": all(
            torch.equal(sd_k[k], sd_p[k]) for k in sd_k
            if k not in ker["params"]),
        "plain_statistics": stats,
        "losses_kernels": ker["losses"], "losses_plain": pl["losses"],
        "launches": {"kernels": ker["launches"], "plain": pl["launches"]}}
    say("no_pallas", t0, json.dumps(float32))
    del routes, ker, pl, sd_k, sd_p
    if not stats["plain_repeats_bitwise"]:
        raise AssertionError("no_pallas: two calls of the plain statistics "
                             "on the same inputs differ")
    if any(v["differing_outside_tie_margin"] for v in assign.values()):
        raise AssertionError("no_pallas: the routes' codes differ outside "
                             "a float32 tie")
    if not (float32["max_loss_rel_err"] <= NP_LOSS_TOL
            and float32["max_param_diff"] <= 2 * TRAIN_LR * NP_STEPS + 1e-6
            and float32["share_params_within_1e-5"] >= 0.99
            and cb_err <= NP_CODEBOOK_TOL):
        raise AssertionError("no_pallas: the plain route disagrees with the "
                             "kernel route")

    # bf16 as the CLI trains: two runs of the plain route from one seed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    runs = []
    zero_counts()
    for _ in range(2):
        model, state, step = build(False, torch.bfloat16)
        losses, times = [], []
        for _ in range(NP_BF16_STEPS):
            t = time.perf_counter()
            state, m = step(state, raw, seed=0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append({k: float(v) for k, v in m.items()})
        runs.append((losses, _model_state(model), times))
        del model, state, step
        torch.cuda.empty_cache()
    bf16_counts = read_counts()
    _expect_launches("no_pallas bf16", bf16_counts, 2 * NP_BF16_STEPS, 0)
    (l_a, sd_a, t_a), (l_b, sd_b, t_b) = runs
    bf16 = {"bitwise_equal": l_a == l_b and all(torch.equal(sd_a[k], sd_b[k])
                                                for k in sd_a),
            "step_ms": [t_a, t_b],
            "step_ms_median": statistics.median(t_a[2:] + t_b[2:]),
            "losses": l_a, "launches": bf16_counts}
    bf16["frames_per_s"] = TRAIN_B * TRAIN_T / (bf16["step_ms_median"] / 1e3)
    say("no_pallas", t0, json.dumps(bf16))
    del runs, sd_a, sd_b
    if not bf16["bitwise_equal"]:
        raise AssertionError("no_pallas: two bf16 runs of the plain route "
                             "from one seed differ")

    # the CLI with --no_pallas at the trainer phase's point and dataset
    zero_counts()
    run = trainer_cli.main(
        ["--data_root", str(work / "data"), "--validation_folder",
         str(work / "val"), "--resident_data", "--batch_size", str(TRAIN_B),
         "--train_frames", str(TRAIN_T), "--val_frames", str(TRAIN_T),
         "--size", str(TRAIN_SIZE), "--sched", "cycle",
         "--epoch", str(NP_CLI_STEPS), "--validate_at", "1000",
         "--metrics_path", str(work / "metrics_np.jsonl"),
         "--sample_folder", str(work / "samples_np"),
         "--checkpoint_dir", str(work / "ckpt_np"), "--no_pallas"],
        device=DEV)
    cli_counts = read_counts()
    _expect_launches("no_pallas CLI", cli_counts, NP_CLI_STEPS, 0)
    rec = _records(work / "metrics_np.jsonl")
    rec_u = _records(work / "metrics_u.jsonl")  # the trainer phase's run U
    steps = list(range(1, NP_CLI_STEPS + 1))
    if sorted(rec) != steps or not all(
            math.isfinite(r[k]) for r in rec.values()
            for k in ("loss", "mse", "latent", "perceptual", "lr")):
        raise AssertionError(f"no_pallas CLI: records {rec}")
    if run.model.quantize_b.use_kernels or run.cfg.model.use_pallas_vq:
        raise AssertionError("no_pallas CLI: the model kept the kernel route")
    cli = {"records": [rec[s] for s in steps],
           # beside the trainer phase's unbroken kernel run: bf16, so
           # reported, not held (float32 is held above)
           "max_loss_rel_diff_vs_kernel_run": max(
               abs(rec[s][k] - rec_u[s][k]) / max(abs(rec_u[s][k]), 1e-12)
               for s in steps for k in ("loss", "mse", "latent",
                                         "perceptual")),
           "launches": cli_counts}
    say("no_pallas", t0, json.dumps(cli))
    counts = {k: float32["launches"]["plain"][k] + bf16_counts[k]
              + cli_counts[k] for k in cli_counts}
    return {"float32": float32, "bf16": bf16, "cli": cli}, counts


# -- phase 20: 512 px training with remat ---------------------------------

R512_VIDEOS, R512_FRAMES = 8, 16  # the synthetic corpus on the card
R512_WARMUP, R512_TIMED = 2, 3
R512_CLI_VIDEOS, R512_CLI_FRAMES, R512_CLI_EPOCHS = 8, 12, 2
# (name, ModelConfig.remat, remat_scope, LPIPS recomputed: --remat_lpips)
R512_CONFIGS = (("no_remat", False, "all", False),
                ("remat", True, "all", False),
                ("remat_decoder", True, "decoder", False),
                ("remat_lpips", True, "all", True))
# float32 without TF32, one step on one batch, against no remat. Remat
# recomputes the same forward operations, so the losses, the codes and
# the EMA step can only move by cuDNN choosing another algorithm for a
# recomputed convolution (float32 rounding of a mean: 1e-5 relative; the
# codebooks as the trainer phase holds two runs, 1e-3 of max(1, |value|)).
# The backward's sums are the same products added by cuDNN in another
# order: float32 sums of up to 32 x 256^2 terms differ by about
# sqrt(n) u, 1e-4 of their absolute sum, so each gradient tensor must lie
# within 1e-3 of its L2 norm.
R512_LOSS_TOL, R512_GRAD_TOL, R512_CODEBOOK_TOL = 1e-5, 1e-3, 1e-3


def _r512_parts(name, remat, scope, remat_lpips, dtype, prepare=None):
    """The model, LPIPS (recomputed with --remat_lpips), state and step of
    one configuration at the flagship widths."""
    model = VQVAE(ModelConfig(remat=remat, remat_scope=scope),
                  dtype=torch.float32, device=DEV,
                  generator=torch.Generator().manual_seed(0))
    lpips = init_lpips(torch.Generator().manual_seed(1), device=DEV,
                       dtype=dtype)
    if remat_lpips:
        lpips = RematLPIPS(lpips)
    opt = make_optimizer(model.parameters(), TRAIN_LR, "cycle",
                         n_iter=TRAIN_N_ITER)
    step = make_train_step(model, lpips=lpips, prepare_fn=prepare,
                           compute_dtype=dtype)
    return model, create_train_state(model, opt), step


def remat512_phase(t0, work: Path):
    """Phase 20 (module docstring). Returns (result, the launch counts of
    the bf16 steps and the CLI run)."""
    frames, lms, n_frames = synthetic_corpus(
        R512_VIDEOS, R512_FRAMES, R512_SIZE, seed=12, device=DEV)
    corpus = corpus_from_arrays(frames, lms, n_frames, device=DEV)
    del frames
    prepare = make_resident_prepare(corpus, R512_B, R512_T)
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}
    with torch.no_grad():
        held = prepare(torch.Generator(device=DEV).manual_seed(13),
                       corpus.frames, corpus.landmarks)

    # parity: float32 without TF32, one step on the held batch each
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = {}
    try:
        for name, remat, scope, rl in R512_CONFIGS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model, state, step = _r512_parts(name, remat, scope, rl,
                                             torch.float32)
            zero_counts()
            state, m = step(state, held)
            torch.cuda.synchronize()
            if any(read_counts()[k] != 2 for k in ("vq_assign", "vq_stats")):
                raise AssertionError(f"remat512 {name}: launches "
                                     f"{read_counts()}")
            steps[name] = {
                "losses": {k: float(v) for k, v in m.items()},
                "grads": {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()},
                "codebooks": {k: v.detach().clone() for k, v in
                              model.state_dict().items()
                              if k.startswith("quantize_")},
                "peak_bytes": torch.cuda.max_memory_allocated() - base}
            del model, state, step, m
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    ref = steps["no_remat"]
    parity = {}
    for name, _, _, _ in R512_CONFIGS[1:]:
        got = steps[name]
        grad_rel = {n: float((got["grads"][n] - g).norm()
                             / g.norm().clamp_min(1e-30))
                    for n, g in ref["grads"].items()}
        parity[name] = {
            "max_loss_rel_err": max(
                abs(got["losses"][k] - v) / max(abs(v), 1e-12)
                for k, v in ref["losses"].items()),
            "max_grad_rel_norm_diff": max(grad_rel.values()),
            "worst_grad": max(grad_rel, key=grad_rel.get),
            "grads_bitwise_equal": all(
                torch.equal(got["grads"][n], g)
                for n, g in ref["grads"].items()),
            "max_codebook_scaled_diff": max(
                float(((got["codebooks"][k] - v).abs()
                       / v.abs().clamp_min(1)).max())
                for k, v in ref["codebooks"].items()),
            "codebooks_bitwise_equal": all(
                torch.equal(got["codebooks"][k], v)
                for k, v in ref["codebooks"].items()),
            "float32_peak_bytes": got["peak_bytes"]}
    parity["no_remat"] = {"float32_peak_bytes": ref["peak_bytes"],
                          "losses": ref["losses"]}
    say("remat512", t0, json.dumps(parity))
    del steps, ref
    torch.cuda.empty_cache()
    for name, row in parity.items():
        if name != "no_remat" and not (
                row["max_loss_rel_err"] <= R512_LOSS_TOL
                and row["max_grad_rel_norm_diff"] <= R512_GRAD_TOL
                and row["max_codebook_scaled_diff"] <= R512_CODEBOOK_TOL):
            raise AssertionError(f"remat512: {name} disagrees with the step "
                                 f"without remat: {row}")

    # bf16 as the CLI trains: each configuration's step with the resident
    # prepare function (the warp kernel at (32, 512, 512, 3))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    timing = {}
    total = {k: 0 for k in read_counts()}
    n_steps = R512_WARMUP + R512_TIMED
    for name, remat, scope, rl in R512_CONFIGS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model, state, step = _r512_parts(name, remat, scope, rl,
                                         torch.bfloat16, prepare)
        zero_counts()
        times, losses = [], []
        for _ in range(n_steps):
            t = time.perf_counter()
            state, m = step(state, raw, seed=0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append({k: float(v) for k, v in m.items()})
        counts = read_counts()
        _expect_launches(f"remat512 {name}", counts, n_steps, 2)
        for k in total:
            total[k] += counts[k]
        step_ms = statistics.median(times[R512_WARMUP:])
        timing[name] = {
            "step_ms_median": step_ms, "step_ms": times,
            "frames_per_s": R512_B * R512_T / (step_ms / 1e3),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "step_peak_bytes": torch.cuda.max_memory_allocated() - base,
            "launches": counts, "last_losses": losses[-1]}
        say("remat512", t0, json.dumps({name: timing[name]}))
        if not all(math.isfinite(v) for m in losses for v in m.values()):
            raise AssertionError(f"remat512 {name}: non-finite losses")
        del model, state, step, m
    torch.cuda.empty_cache()

    # the CLI at the JAX package's 512 px point
    data = work / "data512"
    generate_dataset(str(data), R512_CLI_VIDEOS, R512_CLI_FRAMES, R512_SIZE,
                     seed=14, device=DEV)
    zero_counts()
    run = trainer_cli.main(
        ["--data_root", str(data), "--resident_data", "--size",
         str(R512_SIZE), "--batch_size", str(R512_B), "--train_frames",
         str(R512_T), "--val_frames", str(R512_T), "--remat",
         "--epoch", str(R512_CLI_EPOCHS), "--validate_at", "1000",
         "--metrics_path", str(work / "metrics_512.jsonl"),
         "--sample_folder", str(work / "samples_512"),
         "--checkpoint_dir", str(work / "ckpt_512")], device=DEV)
    cli_counts = read_counts()
    n_cli = R512_CLI_EPOCHS * (R512_CLI_VIDEOS // R512_B)
    _expect_launches("remat512 CLI", cli_counts, n_cli, 2)
    for k in total:
        total[k] += cli_counts[k]
    rec = _records(work / "metrics_512.jsonl")
    kept = CheckpointManager(str(_run_dir(work, "ckpt_512"))).all_steps()
    if sorted(rec) != list(range(1, n_cli + 1)) or not all(
            math.isfinite(r[k]) for r in rec.values()
            for k in ("loss", "mse", "latent", "perceptual", "lr")):
        raise AssertionError(f"remat512 CLI: records {rec}")
    if kept != [n_cli] or not run.model.remat_encoder:
        raise AssertionError(f"remat512 CLI: checkpoints {kept}, remat "
                             f"{run.model.remat_encoder}")
    cli = {"steps": n_cli, "checkpoints": kept,
           "records": [rec[s] for s in sorted(rec)],
           "launches": cli_counts}
    say("remat512", t0, json.dumps(cli))
    return {"parity": parity, "timing": timing, "cli": cli}, total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one more training step")
    parser.add_argument("--dist-child", metavar="WORK", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    if args.dist_child:
        return dist_child(Path(args.dist_child))
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    builds = (warp_cuda.build, vq_cuda.build, image_io.build_jpeg,
              ccl_cuda.build, lk_cuda.build, mpeg4_cuda.build,
              build_lk_probe)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = [f.result() for f in [pool.submit(b) for b in builds]]
    warp_cuda.load()
    vq_cuda.load()
    image_io.load_jpeg()
    ccl_cuda.load()
    lk_cuda.load()
    mpeg4_cuda.load()
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
        no_pallas, no_pallas_counts = no_pallas_phase(t0, Path(work))
        t0 = time.perf_counter()
        jpeg_phase(t0, Path(work))
        t0 = time.perf_counter()
        swap = swap_phase(t0, Path(work))
        t0 = time.perf_counter()
        exported = export_phase(t0, Path(work), streams)
        t0 = time.perf_counter()
        gan_result = gan_phase(t0, Path(work))
        t0 = time.perf_counter()
        b2f, b2f_counts = b2f_phase(t0)
        t0 = time.perf_counter()
        aux, aux_counts = aux_phase(t0, Path(work))
        t0 = time.perf_counter()
        dist, dist_counts = dist_phase(t0, Path(work))
        t0 = time.perf_counter()
        pre, pre_counts = preprocess_phase(t0, Path(work))
        t0 = time.perf_counter()
        mp4_result, mp4_counts = mp4_phase(t0, Path(work), pre)
        t0 = time.perf_counter()
        r512, r512_counts = remat512_phase(t0, Path(work))
    t0 = time.perf_counter()
    time_result = time_phase(t0)
    trainer_counts = trainer["launches"]
    swap_counts = swap["launches"]
    gan_counts = gan_result["launches"]
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

    say("swap", t_all, json.dumps({
        "card": card,
        "host_frames_per_s": swap["host"]["frames_per_s"],
        "host_geometry_frames_per_s": swap["host"]["geometry_frames_per_s"],
        "device_pipeline_frames_per_s":
            swap["device_pipeline"]["frames_per_s"],
        "device_geometry_frames_per_s":
            swap["device_pipeline"]["geometry_frames_per_s"],
        "streaming_push_ms_p50": swap["streaming"]["push_ms_p50"],
        "streaming_k4_push_ms_p50": swap["streaming_k4"]["push_ms_p50"],
        "poisson_chunk_s": swap["poisson"]["chunk_s"],
        "poisson_naive_nonfinite_share":
            swap["poisson"]["naive_nonfinite_share"],
        "launches": swap_counts}))
    gan_step = gan_result["step"]
    say("gan", t_all, json.dumps({
        "card": card,
        "pair_ms_median": gan_step["pair_ms_median"],
        "device_busy_share": gan_step["profile"]["device_busy_share"],
        "frames_per_s": gan_step["frames_per_s"],
        "max_memory_allocated_bytes": gan_step["max_memory_allocated_bytes"],
        "launches_per_pair": gan_step["launches_per_pair"],
        "check": {k: gan_result["check"][k] for k in (
            "max_loss_rel_err", "max_param_diff", "share_params_within_1e-5",
            "max_codebook_diff", "disc_step_left_codebooks_unchanged")},
        "left_out_residue": {
            k: v for k, v in gan_result["check"]["left_out_residue"].items()
            if k != "worst"},
        "cli_steps_per_s": {k: v["steps_per_s"] for k, v in
                            gan_result["cli"].items() if k != "launches"},
        "cli_fd": {k: v["fd"] for k, v in gan_result["cli"].items()
                   if k != "launches"},
        "resume_bitwise_equal":
            gan_result["cli"]["mocoganhd"]["resume_bitwise_equal"],
        "launches": gan_counts}))
    say("export", t_all, json.dumps({
        "card": card,
        "export_s": exported["export_s"],
        "bundle_bytes": exported["bundle_bytes"],
        "offline_vs_eager_max_abs_diff":
            exported["offline_vs_eager_max_abs_diff"],
        "stream_vs_session_max_abs_diff":
            exported["stream_vs_session_max_abs_diff"],
        "push_ms_p50": exported["push_ms_p50"],
        "launches": exported["launches"]}))
    say("b2f", t_all, json.dumps({
        "card": card, "step_ms_median": b2f["step_ms_median"],
        "frames_per_s": b2f["frames_per_s"],
        "max_memory_allocated_bytes": b2f["max_memory_allocated_bytes"],
        "bottom_call": {k: b2f["bottom_call"][k] for k in (
            "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "flagged_rows", "max_abs_err")},
        "float32_check": b2f["float32_check"], "launches": b2f_counts}))
    say("aux", t_all, json.dumps({
        "card": card,
        "vanilla_frames_per_s": aux["vanilla"]["frames_per_s"],
        "encode_psnr_db": aux["encode"]["decode_psnr_db"],
        "alignment_first_last_loss": [aux["alignment"]["first_loss"],
                                      aux["alignment"]["last_loss"]],
        "alignment_steps_per_s": aux["alignment"]["steps_per_s"],
        "launches": aux_counts}))
    say("dist", t_all, json.dumps({
        "card": card,
        "shardmap_step_ms": dist["step"]["shardmap_step_ms"],
        "plain_step_ms": dist["step"]["plain_step_ms"],
        "train_phase_step_ms": train_result["step_ms_median"],
        "step_bitwise_equal": dist["step"]["bitwise_equal"],
        "multihost_cli_bitwise_equal": dist["cli"]["vs_single"][
            "bitwise_equal"],
        "launches": dist_counts}))
    say("preprocess", t_all, json.dumps({
        "card": card,
        "stage1_frames_per_s": pre["stage1_frames_per_s"],
        "stage2_frames_per_s": pre["stage2_frames_per_s"],
        "stage1_split_frames_per_s": {
            k: v for k, v in pre["stage1_split"].items()
            if k.endswith("frames_per_s")},
        "pyr_lk_launches_per_frame": pre["pyr_lk_launches_per_frame"],
        "redetections": pre["redetections"],
        "window_ms": pre["window_ms"],
        "per_frame_loop_ms": pre["per_frame_loop_ms"],
        "kernel_a": {k: pre["ccl"][k] for k in (
            "kernel_ms", "wrapper_ms", "plain_ms", "bound_ms")},
        "kernel_b": {k: pre["lk"][k] for k in (
            "kernel_ms", "wrapper_ms", "plain_ms", "bound_ms",
            "latency_bound_ms", "work")},
        "launches": pre_counts}))
    say("time", t_all, json.dumps({"card": card, **time_result}))
    say("no_pallas", t_all, json.dumps({
        "card": card,
        "float32_vs_kernels": {k: no_pallas["float32"][k] for k in (
            "max_loss_rel_err", "max_param_diff", "share_params_within_1e-5",
            "max_codebook_scaled_diff")},
        "share_rows_differing": {
            k: v["share_differing"]
            for k, v in no_pallas["float32"]["assignment"].items()},
        "bf16_bitwise_equal": no_pallas["bf16"]["bitwise_equal"],
        "bf16_step_ms_median": no_pallas["bf16"]["step_ms_median"],
        "train_phase_step_ms_median": train_result["step_ms_median"],
        "launches": no_pallas_counts}))
    say("remat512", t_all, json.dumps({
        "card": card,
        "step_ms_median": {k: v["step_ms_median"]
                           for k, v in r512["timing"].items()},
        "frames_per_s": {k: v["frames_per_s"]
                         for k, v in r512["timing"].items()},
        "max_memory_allocated_bytes": {
            k: v["max_memory_allocated_bytes"]
            for k, v in r512["timing"].items()},
        "parity": {k: {m: v[m] for m in ("max_loss_rel_err",
                                         "max_grad_rel_norm_diff",
                                         "max_codebook_scaled_diff")}
                   for k, v in r512["parity"].items() if k != "no_remat"},
        "launches": r512_counts}))
    footage = mp4_result["footage"]
    say("mp4", t_all, json.dumps({
        "card": card,
        "720p": {k: footage[k] for k in (
            "encode_frames_per_s", "decode_frames_per_s",
            "encode_host_share", "decode_host_share", "bytes_per_frame",
            "psnr_db")},
        "256px": {k: mp4_result["256"][k] for k in (
            "encode_frames_per_s", "decode_frames_per_s", "bytes_per_frame",
            "psnr_db")},
        "preprocess_from_mp4": mp4_result["preprocess"],
        "launches": mp4_counts}))
    # the serving path: the slice phase's sessions and the export phase's
    launches += exported["launches"]["warp"]
    paths = {"serving": {"vq_assign": 0, "vq_stats": 0, "warp": launches,
                         "warp_backward": 0},
             "training": dict(train_counts), "trainer": trainer_counts,
             "swap": swap_counts, "gan": gan_counts, "b2f": b2f_counts,
             "vanilla_trainer": aux_counts, "dist": dist_counts,
             "preprocess_step": pre["step"]["launches"],
             "no_pallas": no_pallas_counts, "remat512": r512_counts}
    say("launches", t_all, json.dumps(paths))

    def by_path(key):
        return {p: c[key] for p, c in paths.items()}

    def total(key):
        return sum(c[key] for c in paths.values())

    # each statistics launch is one call of the pair (assignment and
    # statistics); the GAN's assignment-only calls count in the
    # assignment row
    pairs = {p: c["vq_stats"] for p, c in paths.items()}
    main_row = rows[0]
    row512 = next(r for r in rows if r["shape"][1] == R512_SIZE)
    vq_main, vq_big = vq_rows[0], vq_rows[-1]
    kernels = [{
        "name": "bilinear_warp",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/warp.cu",
        "replaces": "faceoff_tpu/ops/warp_pallas.py:54",
        "launches": total("warp"),
        "launches_by_path": by_path("warp"),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        # the 512 px step's call (32, 512, 512, 3)
        "call_512": {k: row512[k] for k in (
            "shape", "max_abs_err", "kernel_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")},
    }, {
        "name": "vq_assign",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/vq.cu",
        "replaces": "faceoff_tpu/ops/vq_pallas.py:44",
        # the pair: each call launches both kernels once
        "launches": sum(pairs.values()),
        "launches_by_path": pairs,
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
        "launches": total("vq_assign"),
        "launches_by_path": by_path("vq_assign"),
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
        "launches": total("vq_stats"),
        "launches_by_path": by_path("vq_stats"),
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
        "launches": total("warp_backward"),
        "launches_by_path": by_path("warp_backward"),
        "max_abs_err": bwd["max_abs_err"],
        "ms": bwd["kernel_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
    }, {
        "name": "connected_components",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/ccl.cu",
        "replaces": "faceoff_tpu/preprocess/detectors.py:59",
        "launches": pre_counts["connected_components"],
        "launches_by_shape": pre_counts["connected_components_by_shape"],
        "max_abs_err": pre["ccl"]["max_abs_err"],
        "ms": pre["ccl"]["kernel_ms"],
        # the wrapper: the kernel, then its table or result tensors
        "wrapper_ms": pre["ccl"]["wrapper_ms"],
        "plain_ms": pre["ccl"]["plain_ms"],
        "bound_ms": pre["ccl"]["bound_ms"],
        "bound_by": pre["ccl"]["bound_by"],
        "library_ms": None,  # no PyTorch call computes it
    }, {
        "name": "pyr_lk",
        "route": "cuda",
        "source": "faceoff_tpu_torch/csrc/lk.cu",
        "replaces": "faceoff_tpu/preprocess/detectors.py:483",
        "launches": pre_counts["pyr_lk"],
        "max_abs_err": pre["lk"]["max_abs_err"],
        "ms": pre["lk"]["kernel_ms"],
        # the wrapper: the kernel, then its table or result tensors
        "wrapper_ms": pre["lk"]["wrapper_ms"],
        "plain_ms": pre["lk"]["plain_ms"],
        "bound_ms": pre["lk"]["bound_ms"],
        "bound_by": pre["lk"]["bound_by"],
        # a point's links run one after another (lk_row)
        "latency_bound_ms": pre["lk"]["latency_bound_ms"],
        "library_ms": None,  # no PyTorch call computes it
    }]
    mp4_rows = mp4_result["kernels"]
    for name, replaces in (("dequant_idct", "faceoff_tpu/io/video.py:61"),
                           ("motion_compensate",
                            "faceoff_tpu/io/video.py:61"),
                           ("motion_search", "faceoff_tpu/io/video.py:22"),
                           ("fdct_quant", "faceoff_tpu/io/video.py:22")):
        row = mp4_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "faceoff_tpu_torch/csrc/mpeg4.cu",
            # cv2's FFmpeg mp4v behind the JAX package's video I/O; no TPU
            # kernel
            "replaces": replaces,
            "launches": mp4_counts[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "wrapper_ms": row["wrapper_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
        for key in ("sass_bound_ms", "wide_share"):
            if key in row:
                kernels[-1][key] = row[key]
    print(f"[total] {time.perf_counter() - t_all:.2f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
