#!/usr/bin/env python3
"""Training throughput of the PyTorch/CUDA port, the counterpart of
`bench.py`'s `bench_resident` (`--mode e2e_resident`) and `bench_gan`
(`--mode gan`):

    python3 bench_torch.py [--mode resident|gan]

A synthetic dataset of max(8, B) videos x (T + 8) frames at 256 px is
written as PNG to a temporary directory (`data/synthetic.generate_dataset`)
and decoded onto the card (`data/resident.build_resident_corpus`); then the
flagship VQVAE (random weights from seed 0) with a random VGG16 LPIPS in
bf16 takes WARMUP steps and ITERS timed steps of B = 16 clips of T = 8
frames, one step a call, each step sampling and preparing its clips on
the card. The time runs on
the host clock from before the first timed step to after a read of the
last step's loss.

--mode gan: the GAN stage's mocoganhd recipe at bench_gan's point: the
flagship VQVAE (bf16 autocast) with MultiscaleDiscriminator2D/3D (ndf 64,
float32), one clip of 16 frames at 256 px drawn uniform in [-1, 1] on the
card (input = clip || clip, as bench.py builds it), a 16-frame window; 2
warm-up and 6 timed gen/disc pairs, each pair's steps seeded 2i and
2i + 1 as bench.py keys them; frames/s = B T 2 6 / seconds, the time
from before the first timed pair to after a read of the last pair's
generator loss.

Prints one JSON line in `bench.py`'s format, with the card's name and
power limit (nvidia-smi) added. Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import torch

from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data import synthetic
from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset
from faceoff_tpu_torch.data.resident import (build_resident_corpus,
                                             make_resident_prepare)
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models.discriminators import (MultiscaleDiscriminator2D,
                                                     MultiscaleDiscriminator3D)
from faceoff_tpu_torch.models.lpips import init_lpips
from faceoff_tpu_torch.train.gan import create_gan_state, make_gan_steps
from faceoff_tpu_torch.train.state import create_train_state
from faceoff_tpu_torch.train.train_step import make_train_step

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


def bench_gan() -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    b, t, sf, calls = 1, 16, 16, 6
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(1))
    disc_gen = torch.Generator().manual_seed(2)
    d_img = MultiscaleDiscriminator2D(device=dev, generator=disc_gen)
    d_3d = MultiscaleDiscriminator3D(n_frames=sf, device=dev,
                                     generator=disc_gen)
    gt = torch.rand((b, t, HW, HW, 3), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 2 - 1
    batch = {"input": torch.cat([gt, gt], dim=-1), "gt": gt}
    state = create_gan_state(create_train_state(model, lr=3e-4), d_img, d_3d)
    gen_step, disc_step = make_gan_steps(model, d_img, d_3d, sample_frames=sf)

    def one(i):
        nonlocal state
        state, m = gen_step(state, batch, 2 * i)
        state, _ = disc_step(state, batch, 2 * i + 1)
        return m["g_loss"]

    for i in range(2):
        out = one(i)
    float(out)
    t0 = time.perf_counter()
    for i in range(calls):
        out = one(i)
    float(out)
    dt = time.perf_counter() - t0
    fps = b * t * 2 * calls / dt
    return {"metric": "gan_train_frames_per_sec_256px_T16",
            "value": round(fps, 2), "unit": "frames/s/chip",
            "vs_baseline": round(fps / REF_FPS_PER_GPU_EST, 3), **card()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", choices=["resident", "gan"],
                        default="resident",
                        help="resident: bench_resident's training point; "
                             "gan: bench_gan's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; this benchmark runs on a GPU "
              "only", file=sys.stderr)
        return 1
    bench = bench_gan if args.mode == "gan" else bench_resident
    print(json.dumps(bench()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
