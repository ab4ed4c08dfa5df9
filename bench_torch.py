#!/usr/bin/env python3
"""Training throughput of the PyTorch/CUDA port with the corpus resident on
the card, the counterpart of `bench.py --mode e2e_resident`
(`bench_resident`):

    python3 bench_torch.py

A synthetic dataset of max(8, B) videos x (T + 8) frames at 256 px is
written as PNG to a temporary directory (`data/synthetic.generate_dataset`)
and decoded onto the card (`data/resident.build_resident_corpus`); then the
flagship VQVAE (random weights from seed 0) with a random VGG16 LPIPS in
bf16 takes WARMUP steps and ITERS timed steps of B = 16 clips of T = 8
frames, one step a call, each step sampling and preparing its clips on
the card. The time runs on
the host clock from before the first timed step to after a read of the
last step's loss.

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
from faceoff_tpu_torch.models.lpips import init_lpips
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


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; this benchmark runs on a GPU "
              "only", file=sys.stderr)
        return 1
    print(json.dumps(bench_resident()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
