#!/usr/bin/env python3
"""Throughput and latency of the PyTorch/CUDA port, the counterparts of
`bench.py`'s modes at their points, metric names and timing:

    python3 bench_torch.py [--mode resident|gan|stream|swap_session|infer|
                                   e2e|e2e_host] [--batch N]
                           [--frames_per_call K] [--scan K]

resident (the default; `bench_resident`, `--mode e2e_resident`): a
synthetic dataset of max(8, B) videos x (T + 8) frames at 256 px written
as PNG to a temporary directory (`data/synthetic.generate_dataset`) and
decoded onto the card (`data/resident.build_resident_corpus`); then the
flagship VQVAE (random weights from seed 0) with a random VGG16 LPIPS in
bf16 takes WARMUP steps and ITERS timed steps of B = 16 clips of T = 8
frames, one step a call, each step sampling and preparing its clips on
the card. The time runs on the host clock from before the first timed
step to after a read of the last step's loss.

gan (`bench_gan`): the GAN stage's mocoganhd recipe: the flagship VQVAE
(bf16 autocast) with MultiscaleDiscriminator2D/3D (ndf 64, float32), one
clip of 16 frames at 256 px drawn uniform in [-1, 1] on the card (input
= clip || clip, as bench.py builds it), a 16-frame window; 2 warm-up and
6 timed calls, each a gen/disc pair seeded 2i and 2i + 1 as bench.py
keys them, or with --scan K (even) K alternating steps through
`make_gan_multi_step`; frames/s = B T (steps a call) 6 / seconds, the
time from before the first timed call to after a read of the last
call's generator loss.

stream (`bench_stream`): the flagship VQVAE in bf16 (seed 0) behind a
`StreamingSwapper` of --batch concurrent 256 px streams; one frame a
push, or --frames_per_call K a `push_many`. max(1, ceil((delay+2)/K))
warm-up calls, then 30 timed calls, each ending in a read of its last
output on the host; p50 ms per frame.

swap_session (`bench_swap_session`): a `SwapSession` fed host uint8
frames and landmarks (numpy, seed 0) — the copy to the card, the swap
geometry (one warp kernel launch a push) and the streaming forward —
timed as stream is.

infer (`bench_infer`): `make_eval_step` on (--batch, 8, 256, 256, 6)
clips, the flagship VQVAE in bf16; WARMUP calls, then ITERS timed calls
and a read of the last output.

e2e / e2e_host (`bench_e2e`): training through the input pipeline on a
synthetic PNG dataset of max(4, 2B) videos x (T + 4) frames (no LPIPS,
as bench.py): e2e loads raw frames and landmarks (`RawClipLoader`) and
prepares the batch on the card inside the step (`prepare_train_batch`);
e2e_host prepares it on the host (`DataLoader`). Batches are staged by
`prefetch_to_device` at depth 3; one warm-up step, then 12 timed steps
ending in a read of the last loss.

Prints one JSON line in `bench.py`'s format, with the card's name and
power limit (nvidia-smi) added. Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data import synthetic
from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset
from faceoff_tpu_torch.data.device_pipeline import (RawClipLoader,
                                                    prepare_train_batch)
from faceoff_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
from faceoff_tpu_torch.data.resident import (build_resident_corpus,
                                             make_resident_prepare)
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models.discriminators import (MultiscaleDiscriminator2D,
                                                     MultiscaleDiscriminator3D)
from faceoff_tpu_torch.models.lpips import init_lpips
from faceoff_tpu_torch.serve import StreamingSwapper, SwapSession
from faceoff_tpu_torch.train.gan import (create_gan_state,
                                         make_gan_multi_step, make_gan_steps)
from faceoff_tpu_torch.train.state import create_train_state
from faceoff_tpu_torch.train.train_step import make_eval_step, make_train_step

B, T, HW = 16, 8, 256
WARMUP, ITERS = 3, 20
# bench.py's estimate of the reference trainer's frames/s on one GPU
REF_FPS_PER_GPU_EST = 43.72


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    name, power = (s.strip() for s in line.split(","))
    return {"device": name, "power_limit": power}


def bench_resident() -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as root:
        synthetic.generate_dataset(root, n_videos=max(8, B), n_frames=T + 8,
                                   size=HW)
        ds = TemporalAlignmentDataset(root, "train", T, resolution=HW,
                                      device=dev)
        corpus = build_resident_corpus(ds, device=dev)

    model = VQVAE(ModelConfig(), dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, lr=3e-4)
    lpips = init_lpips(torch.Generator().manual_seed(1), device=dev)
    step = make_train_step(model, lpips=lpips,
                           prepare_fn=make_resident_prepare(corpus, B, T))
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}

    for _ in range(WARMUP):
        state, m = step(state, raw, 2)
    float(m["loss"])  # a host read: the card has finished
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state, m = step(state, raw, 2)
    float(m["loss"])
    dt = time.perf_counter() - t0
    fps = B * T * ITERS / dt
    return {"metric": f"e2e_train_frames_per_sec_resident_b{B}",
            "value": round(fps, 2), "unit": "frames/s/chip",
            "vs_baseline": round(fps / REF_FPS_PER_GPU_EST, 3), **card()}


def _cuda() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device())


def _flagship(dtype: torch.dtype, seed: int, dev: torch.device) -> VQVAE:
    return VQVAE(ModelConfig(), dtype=dtype, device=dev,
                 generator=torch.Generator().manual_seed(seed))


def bench_gan(scan: int = 0) -> dict:
    dev = _cuda()
    b, t, sf, calls = 1, 16, 16, 6
    model = _flagship(torch.float32, 1, dev)
    disc_gen = torch.Generator().manual_seed(2)
    d_img = MultiscaleDiscriminator2D(device=dev, generator=disc_gen)
    d_3d = MultiscaleDiscriminator3D(n_frames=sf, device=dev,
                                     generator=disc_gen)
    gt = torch.rand((b, t, HW, HW, 3), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 2 - 1
    batch = {"input": torch.cat([gt, gt], dim=-1), "gt": gt}
    state = create_gan_state(create_train_state(model, lr=3e-4), d_img, d_3d)

    if scan > 1:
        multi = make_gan_multi_step(model, d_img, d_3d, scan,
                                    sample_frames=sf)
        batches = {k: v.expand((scan,) + v.shape) for k, v in batch.items()}

        def one(i):
            nonlocal state
            state, m = multi(state, batches, 3)
            return m["gen"]["g_loss"]

        steps_per_call = scan
    else:
        gen_step, disc_step = make_gan_steps(model, d_img, d_3d,
                                             sample_frames=sf)

        def one(i):
            nonlocal state
            state, m = gen_step(state, batch, 2 * i)
            state, _ = disc_step(state, batch, 2 * i + 1)
            return m["g_loss"]

        steps_per_call = 2  # one gen and one disc step a call

    for i in range(2):
        out = one(i)
    out.cpu()
    t0 = time.perf_counter()
    for i in range(calls):
        out = one(i)
    out.cpu()
    dt = time.perf_counter() - t0
    fps = b * t * steps_per_call * calls / dt
    name = ("gan_train_frames_per_sec_256px_T16" if scan <= 1
            else f"gan_train_frames_per_sec_256px_T16_scan{scan}")
    return {"metric": name, "value": round(fps, 2), "unit": "frames/s/chip",
            "vs_baseline": round(fps / REF_FPS_PER_GPU_EST, 3), **card()}


def _latency(push_once, delay: int, k: int) -> float:
    """Warm up, then the p50 over 30 calls of one call's ms per frame,
    each call ending in a read of its output on the host."""
    for _ in range(max(1, (delay + 2 + k - 1) // k)):
        out = push_once()
    out.cpu()
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        push_once().cpu()
        lat.append((time.perf_counter() - t0) * 1e3 / k)
    return statistics.median(lat)


def bench_stream(batch: int = 1, frames_per_call: int = 1) -> dict:
    dev = _cuda()
    sw = StreamingSwapper(_flagship(torch.bfloat16, 0, dev), height=HW,
                          width=HW, batch=batch, device=dev)
    k = max(1, frames_per_call)
    frame = torch.rand((batch, HW, HW, 6), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev) * 2 - 1
    if k > 1:
        frames_k = frame.expand((k,) + frame.shape)

        def push_once():
            return sw.push_many(frames_k)[-1]
    else:
        def push_once():
            return sw.push(frame)

    p50 = _latency(push_once, sw.delay, k)
    name = "stream_swap_latency_ms_per_frame_256px"
    if batch > 1:
        name += f"_b{batch}"
    if k > 1:
        name += f"_k{k}"
    return {"metric": name, "value": round(p50, 4),
            "unit": "ms/frame (p50)" if k == 1
            else f"ms/frame (p50, amortized over {k}/dispatch)",
            "vs_baseline": round(batch * 1e3 / p50 / REF_FPS_PER_GPU_EST, 3),
            **card()}


def bench_swap_session(frames_per_call: int = 1) -> dict:
    dev = _cuda()
    sess = SwapSession(_flagship(torch.bfloat16, 0, dev), height=HW,
                       width=HW, device=dev)
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (HW, HW, 3), dtype=np.uint8)
    # plausible in-frame landmarks (the geometry only needs a sane hull)
    lms = (rng.uniform(0.3, 0.7, (68, 2)) * HW).astype(np.float32)
    k = max(1, frames_per_call)
    if k > 1:
        fk, lk = [frame] * k, [lms] * k

        def push_once():
            return sess.push_many(fk, lk, fk, lk)[-1]
    else:
        def push_once():
            return sess.push(frame, lms, frame, lms)

    p50 = _latency(push_once, sess.delay, k)
    name = "swap_session_latency_ms_per_frame_256px"
    if k > 1:
        name += f"_k{k}"
    return {"metric": name, "value": round(p50, 4),
            "unit": "ms/frame (p50, host frames in)" if k == 1
            else f"ms/frame (p50, host frames in, {k}/dispatch)",
            "vs_baseline": round(1e3 / p50 / REF_FPS_PER_GPU_EST, 3),
            **card()}


def bench_infer(batch: int = 1) -> dict:
    dev = _cuda()
    model = _flagship(torch.bfloat16, 1, dev)
    gt = torch.rand((batch, T, HW, HW, 3), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 2 - 1
    batch_d = {"input": torch.cat([gt, gt], dim=-1), "gt": gt}
    state = create_train_state(model)
    eval_step = make_eval_step(model)
    for _ in range(WARMUP):
        out, _ = eval_step(state, batch_d)
    out.ravel()[:1].cpu()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out, _ = eval_step(state, batch_d)
    out.ravel()[:1].cpu()
    fps = batch * T * ITERS / (time.perf_counter() - t0)
    return {"metric": f"infer_frames_per_sec_256px_b{batch}",
            "value": round(fps, 2), "unit": "frames/s/chip",
            "vs_baseline": round(fps / REF_FPS_PER_GPU_EST, 3), **card()}


def bench_e2e(device_pipeline: bool, batch: int = 1) -> dict:
    dev = _cuda()
    b = batch
    model = _flagship(torch.float32, 0, dev)
    state = create_train_state(model, lr=3e-4)
    with tempfile.TemporaryDirectory() as root:
        synthetic.generate_dataset(root, n_videos=max(4, 2 * b),
                                   n_frames=T + 4, size=HW)
        ds = TemporalAlignmentDataset(root, "train", T, resolution=HW,
                                      device=dev)
        if device_pipeline:
            loader = RawClipLoader(ds, batch_clips=b, num_workers=8)
            # the input preparation runs on the card inside the step
            step = make_train_step(model, prepare_fn=prepare_train_batch)
            keep = ("frames", "landmarks")
        else:
            loader = DataLoader(ds, batch_clips=b, num_workers=8)
            step = make_train_step(model)
            keep = ("input", "gt")

        def host_batches(n):
            served = 0
            while served < n:
                for raw in loader:
                    yield {k: raw[k] for k in keep}
                    served += 1
                    if served >= n:
                        return

        staged = next(prefetch_to_device(host_batches(1), dev))
        state, m = step(state, staged, 0)
        float(m["loss"])  # a host read: the card has finished
        n_steps = 0
        t0 = time.perf_counter()
        for staged in prefetch_to_device(host_batches(12), dev, depth=3):
            state, m = step(state, staged, n_steps)
            n_steps += 1
        float(m["loss"])
        dt = time.perf_counter() - t0
    fps = b * T * n_steps / dt
    label = "device" if device_pipeline else "host"
    return {"metric": f"e2e_train_frames_per_sec_{label}_pipeline_b{b}",
            "value": round(fps, 2), "unit": "frames/s/chip",
            "vs_baseline": round(fps / REF_FPS_PER_GPU_EST, 3), **card()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--mode", default="resident",
        choices=["resident", "gan", "stream", "swap_session", "infer", "e2e",
                 "e2e_host"],
        help="resident: bench_resident's training point; gan: bench_gan's "
             "(--scan K: K steps a call); stream: the streaming push "
             "(--batch streams, --frames_per_call K); swap_session: the "
             "session from host frames; infer: the eval forward; e2e / "
             "e2e_host: training through the input pipeline, prepared on "
             "the card / on the host")
    parser.add_argument("--batch", type=int, default=None,
                        help="stream, infer, e2e and e2e_host modes: "
                             "streams or clips a call (default 1)")
    parser.add_argument("--frames_per_call", type=int, default=1,
                        help="stream and swap_session modes: K frames a "
                             "push_many call")
    parser.add_argument("--scan", type=int, default=0,
                        help="gan mode: K alternating gen/disc steps a call "
                             "(even; 0 = one pair a call)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; this benchmark runs on a GPU "
              "only", file=sys.stderr)
        return 1
    batch = args.batch or 1
    benches = {
        "resident": bench_resident,
        "gan": lambda: bench_gan(args.scan),
        "stream": lambda: bench_stream(batch, args.frames_per_call),
        "swap_session": lambda: bench_swap_session(args.frames_per_call),
        "infer": lambda: bench_infer(batch),
        "e2e": lambda: bench_e2e(True, batch),
        "e2e_host": lambda: bench_e2e(False, batch),
    }
    print(json.dumps(benches[args.mode]()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
