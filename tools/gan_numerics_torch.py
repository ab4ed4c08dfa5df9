#!/usr/bin/env python3
"""Numerics of the GAN stage's pooling and repeatability on the card:

    python3 tools/gan_numerics_torch.py

1. `F.avg_pool2d`/`avg_pool3d` (3 wide, padding 1, count_include_pad
   False) and the discriminators' `avg_pool3`, forward and backward in
   float32 on the card and on the CPU, each against a float64 CPU
   reference, for a contiguous and a channels-last input (largest
   |diff| over the reference's largest value).
2. Whether a backward repeats bit for bit: three launches of each pool's
   backward on the same inputs.
   Then the multiscale discriminators' gradient with respect to their
   channels-last input (ndf 8, 64 px, float32 without TF32) on the card
   against the CPU, pooling between scales with `avg_pool3` and with
   `F.avg_pool2d`/`avg_pool3d` on the same views.
3. Whether a mocoganhd gen/disc pair repeats bit for bit at bench_gan's
   point (B 1, T 16, 256 px, flagship widths; two runs of two pairs
   from the same seed), with cuDNN's default algorithm choices and with
   its deterministic ones (`train.gan.cudnn_deterministic`), and the pair
   ms of each, timed in turns (default, deterministic, deterministic,
   default; 6 pairs each after 2 warm-up pairs, host clock ending in a
   synchronize).

Prints one JSON line a part and the card's name and power limit. Runs
on CUDA only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from faceoff_tpu_torch.config import ModelConfig  # noqa: E402
from faceoff_tpu_torch.data.resident import (corpus_from_arrays,  # noqa: E402
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import synthetic_corpus  # noqa: E402
from faceoff_tpu_torch.models import VQVAE  # noqa: E402
from faceoff_tpu_torch.models import discriminators as D  # noqa: E402
from faceoff_tpu_torch.train import gan  # noqa: E402
from faceoff_tpu_torch.train.state import create_train_state  # noqa: E402


def pools():
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    cases = {
        "avg_pool2d": (lambda x: F.avg_pool2d(
            x, 3, stride=2, padding=1, count_include_pad=False),
            (1, 6, 64, 64)),
        "avg_pool3d": (lambda x: F.avg_pool3d(
            x, 3, stride=(1, 2, 2), padding=1, count_include_pad=False),
            (1, 6, 15, 64, 64)),
        "avg_pool3_2d": (lambda x: D.avg_pool3(x, 2), (1, 6, 64, 64)),
        "avg_pool3_3d": (lambda x: D.avg_pool3(x, (1, 2, 2)),
                         (1, 6, 15, 64, 64)),
    }
    out = {}
    for name, (fn, shape) in cases.items():
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        gy = torch.randn(fn(x).shape, generator=g, dtype=torch.float64)

        def run(dev, dtype, channels_last):
            xx = x.to(dev, dtype)
            if channels_last:
                xx = xx.movedim(1, -1).contiguous().movedim(-1, 1)
            xx = xx.detach().requires_grad_(True)
            y = fn(xx)
            y.backward(gy.to(dev, dtype))
            return y.detach().double().cpu(), xx.grad.double().cpu()

        y_ref, g_ref = run("cpu", torch.float64, False)
        for dev in ("cpu", "cuda"):
            for cl in (False, True):
                y, gx = run(dev, torch.float32, cl)
                key = f"{name} {dev} {'channels_last' if cl else 'contiguous'}"
                out[key] = {
                    "forward": float((y - y_ref).abs().max()
                                     / y_ref.abs().max()),
                    "backward": float((gx - g_ref).abs().max()
                                      / g_ref.abs().max())}
        grads = [run("cuda", torch.float32, False)[1] for _ in range(3)]
        out[f"{name} cuda backward repeats"] = all(
            torch.equal(grads[0], gr) for gr in grads[1:])
    return out


def torch_pool(x, stride):
    pool = F.avg_pool2d if x.dim() == 4 else F.avg_pool3d
    return pool(x, 3, stride=stride, padding=1, count_include_pad=False)


def input_gradients():
    """|card - CPU| / max |CPU| of the discriminators' input gradient."""
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for kind, cls, shape in (
            ("2d", D.MultiscaleDiscriminator2D, (1, 64, 64, 6)),
            ("3d", D.MultiscaleDiscriminator3D, (1, 3, 64, 64, 6))):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
        for name, pool in (("avg_pool3", D.avg_pool3),
                           ("torch avg_pool", torch_pool)):
            grads = []
            for dev in ("cpu", "cuda"):
                disc = cls(ndf=8, device=dev,
                           generator=torch.Generator().manual_seed(2))
                xx = x.detach().to(dev).requires_grad_(True)
                kept, D.avg_pool3 = D.avg_pool3, pool
                try:
                    feats = disc(xx)
                finally:
                    D.avg_pool3 = kept
                sum((f[-1] ** 2).mean() for f in feats).backward()
                grads.append(xx.grad.cpu())
            out[f"{kind} {name}"] = float((grads[1] - grads[0]).abs().max()
                                          / grads[0].abs().max())
    return out


def pairs(deterministic: bool, corpus, n_runs=2, n_pairs=2):
    """n_runs runs of n_pairs pairs from the same seed: whether every
    run ends bitwise equal to the first."""
    wrap = gan.cudnn_deterministic
    if not deterministic:
        gan.cudnn_deterministic = lambda fn: fn
    try:
        finals = []
        for _ in range(n_runs):
            state, (gen_step, disc_step), raw = build(corpus)
            for _ in range(n_pairs):
                state, _ = gen_step(state, raw, 0)
                state, _ = disc_step(state, raw, 0)
            finals.append({**{f"g.{k}": v.clone() for k, v in
                              state.gen.model.state_dict().items()},
                           **{f"d.{k}": v.clone() for k, v in
                              state.d_3d.state_dict().items()}})
    finally:
        gan.cudnn_deterministic = wrap
    return all(torch.equal(finals[0][k], f[k]) for f in finals[1:]
               for k in f)


def build(corpus):
    dev = corpus.frames.device
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    d_img = D.MultiscaleDiscriminator2D(device=dev, generator=g)
    d_3d = D.MultiscaleDiscriminator3D(n_frames=16, device=dev, generator=g)
    state = gan.create_gan_state(create_train_state(model, lr=3e-4), d_img,
                                 d_3d)
    steps = gan.make_gan_steps(model, d_img, d_3d, sample_frames=16,
                               prepare_fn=make_resident_prepare(corpus, 1,
                                                                16))
    return state, steps, {"frames": corpus.frames,
                          "landmarks": corpus.landmarks}


def pair_ms(deterministic: bool, corpus, warmup=2, timed=6):
    wrap = gan.cudnn_deterministic
    if not deterministic:
        gan.cudnn_deterministic = lambda fn: fn
    try:
        state, (gen_step, disc_step), raw = build(corpus)
    finally:
        gan.cudnn_deterministic = wrap
    times = []
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = gen_step(state, raw, 0)
        state, _ = disc_step(state, raw, 0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times[warmup:])


def main() -> int:
    if not torch.cuda.is_available():
        print("gan_numerics_torch: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"pools": pools()}), flush=True)
    print(json.dumps({"input_gradient_vs_cpu": input_gradients()}),
          flush=True)
    torch.backends.cudnn.allow_tf32 = True
    frames, lms, n = synthetic_corpus(4, 24, 256, seed=3, device="cuda")
    corpus = corpus_from_arrays(frames, lms, n, device="cuda")
    print(json.dumps({"pair_repeats_bitwise": {
        "default": pairs(False, corpus),
        "deterministic": pairs(True, corpus)}}), flush=True)
    order = [False, True, True, False]
    ms = {False: [], True: []}
    for det in order:
        ms[det].append(pair_ms(det, corpus))
    print(json.dumps({"pair_ms_in_turns": {
        "default": ms[False], "deterministic": ms[True]}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
