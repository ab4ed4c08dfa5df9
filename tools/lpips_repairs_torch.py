#!/usr/bin/env python3
"""The perceptual training step of the PyTorch port, timed on one GPU with
several builds of LPIPS, to measure what each change to LPIPS does to the
step.

    python3 tools/lpips_repairs_torch.py LABEL=PATH[:DTYPE] [...]

PATH is a file that defines `init_lpips` (the port's
`faceoff_tpu_torch/models/lpips.py`, or an earlier version of it saved
elsewhere); DTYPE (float32 or bfloat16), when given, is passed as
`init_lpips(dtype=...)`. The setup is `chip_smoke.py`'s train phase:
flagship widths, b16, T8, 256 px, a resident corpus of synthetic videos,
bf16 autocast. The variants run in the order given, each 2 warm-up and 5
timed steps (step ms: host clock around a step ending in a
synchronise, median), then LPIPS forward and backward alone at the
step's shapes (`chip_smoke.module_split`'s measurement: CUDA events,
median of 5), and LPIPS of one held batch against a perturbed copy.
Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from faceoff_tpu_torch.config import ModelConfig  # noqa: E402
from faceoff_tpu_torch.data.resident import (corpus_from_arrays,  # noqa: E402
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import synthetic_corpus  # noqa: E402
from faceoff_tpu_torch.models import VQVAE  # noqa: E402
from faceoff_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                           make_optimizer)
from faceoff_tpu_torch.train.train_step import make_train_step  # noqa: E402


def parse(arg: str, i: int):
    label, _, rest = arg.partition("=")
    path, _, dtype = rest.partition(":")
    spec = importlib.util.spec_from_file_location(f"lpips_variant_{i}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return label, module, dtype or None


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    variants = [parse(a, i) for i, a in enumerate(sys.argv[1:])]
    dev = cs.DEV
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    frames, lms, n_frames = synthetic_corpus(
        cs.CORPUS_VIDEOS, cs.CORPUS_FRAMES, cs.TRAIN_SIZE, seed=3, device=dev)
    corpus = corpus_from_arrays(frames, lms, n_frames, device=dev)
    del frames
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), cs.TRAIN_LR, "cycle",
                         n_iter=len(variants) * 7)
    state = create_train_state(model, opt)
    prepare = make_resident_prepare(corpus, cs.TRAIN_B, cs.TRAIN_T)
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}
    with torch.no_grad():
        held = prepare(torch.Generator(device=dev).manual_seed(11),
                       corpus.frames, corpus.landmarks)
    gt = held["gt"].reshape(-1, *held["gt"].shape[2:])
    other = (gt * 0.9).clamp(-1, 1)

    for label, module, dtype in variants:
        kw = {"dtype": getattr(torch, dtype)} if dtype else {}
        lpips = module.init_lpips(torch.Generator().manual_seed(1),
                                  device=dev, **kw)
        step = make_train_step(model, lpips=lpips, prepare_fn=prepare)
        times = []
        for _ in range(cs.WARMUP_STEPS + cs.TIMED_STEPS):
            t = time.perf_counter()
            state, _ = step(state, raw, seed=0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        pred = gt.detach().clone().requires_grad_(True)

        def lpips_step():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                loss = lpips(gt, pred)
            loss.backward()

        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            held_value = float(lpips(gt, other))
        row = {"variant": label, "dtype": dtype,
               "step_ms_median": statistics.median(times[cs.WARMUP_STEPS:]),
               "step_ms": times,
               "lpips_fwd_bwd_ms": cs.cuda_ms(lpips_step, reps=5, inner=1),
               "lpips_held_batch": held_value}
        print(json.dumps(row), flush=True)
        del lpips, step, pred
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
