#!/usr/bin/env python3
"""Where a time-sharded rank's step spends its time, on one GPU: the
parts of the perceptual step at the plain step's layout (b16 x T8) and
at the frame blocks a rank of `tools/dist_check_torch.py --time K`
holds (128 frames a GPU either way), in turns.

    python3 tools/time_shard_split_torch.py [--reps N]

Flagship widths, 256 px, bf16 autocast, float32 parameters (the
training step's setting). Each configuration is timed with CUDA events
(the median of --reps calls after 2 warm-ups), in the order A B B A:

  model   the VQVAE's training forward (codebooks left as they are) and
          backward of a squared-output loss, at clips x frames:
            plain 16x8   the plain step's layout;
            plain 1x128  one clip of 128 frames, whole ('same' padding);
            shard 1x128  the same block as a time-sharded rank runs it:
                         the postnets' shard path (`layer_shard` between
                         one-frame halos before each layer), with the
                         exchange replaced by zero halos, so no
                         communication is timed;
            plain 2x64, shard 2x64  the data=2 x time=2 rank's block;
  prepare the resident prepare function at 16x8, 1x512 and 2x128 (what
          a rank prepares: its data group's whole clips);
  step    the whole training step (random-VGG LPIPS in bf16, Adam): the
          plain step at b16 x T8 beside the step of rank 1 of
          `make_mesh(time=4)` (one T512 clip prepared, frames 128-255
          kept) and of `make_mesh(data=2, time=2)` (two T128 clips, the
          second half of their frames), both with the shard path's zero
          halos and without collectives: a rank's device work without
          its communication (host clock around a synchronised step, the
          median of --reps after 2 warm-ups, in turns).

  inputs  LPIPS's forward and backward (bf16 autocast, as in the step)
          and the VQVAE's as above, on the plain step's prepared batch
          and on the time=4 rank's 128 prepared frames, in turns: whether
          the frames themselves, not their layout, change the cost.

Then one call each of plain 16x8 and shard 1x128, and one step each of
the plain step and the time=4 rank's, under torch.profiler: the device
ms of the operators that differ most. Prints the card's name and power
limit, then one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from faceoff_tpu_torch.config import ModelConfig  # noqa: E402
from faceoff_tpu_torch.data.resident import (corpus_from_arrays,  # noqa: E402
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import synthetic_corpus  # noqa: E402
from faceoff_tpu_torch.models import VQVAE  # noqa: E402
from faceoff_tpu_torch.models.lpips import init_lpips  # noqa: E402
from faceoff_tpu_torch.models.vqvae import TemporalPostnet  # noqa: E402
from faceoff_tpu_torch.parallel import collectives  # noqa: E402
from faceoff_tpu_torch.parallel.mesh import Mesh, frame_block  # noqa: E402
from faceoff_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                           make_optimizer)
from faceoff_tpu_torch.train.train_step import make_train_step  # noqa: E402

SIZE = 256
LAYOUTS = {"16x8": (16, 8), "1x128": (1, 128), "2x64": (2, 64)}
PREPARE = {"16x8": (16, 8), "1x512": (1, 512), "2x128": (2, 128)}
# step: (clips, frames) prepared, and the rank's place on its mesh
STEPS = {"plain_16x8": ((16, 8), None),
         "time4_rank1": ((1, 512), Mesh(data=1, time=4, rank=1)),
         "data2_time2_rank1": ((2, 128), Mesh(data=2, time=2, rank=1))}


def zero_halos(x, time_axis, group, width=1):
    """The exchange's result at a clip's ends, without communication."""
    shape = list(x.shape)
    shape[time_axis] = width
    return x.new_zeros(shape), x.new_zeros(shape)


def set_shard(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, TemporalPostnet):
            m.time_group = object() if on else None


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def model_call(model, video, shard: bool):
    def run():
        set_shard(model, shard)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            dec, lat = model(video, train=True, update_codebooks=False)
            loss = dec.float().square().mean() + lat
        loss.backward()
        model.zero_grad(set_to_none=True)
        set_shard(model, False)

    return run


def profile_ops(fn):
    """Device ms by operator (the kernels each launched itself) of one
    call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    return {e.key: e.self_device_time_total / 1e3 for e in ops}


def step_call(corpus, lpips, clips_frames, mesh):
    """One training step of a fresh flagship model (see the docstring);
    returns a function of no arguments running the next step."""
    model = VQVAE(ModelConfig(), dtype=torch.float32, device="cuda",
                  generator=torch.Generator().manual_seed(0))
    box = [create_train_state(model, make_optimizer(model.parameters(),
                                                    3e-4))]
    step = make_train_step(model, lpips=lpips, mesh=mesh,
                           prepare_fn=make_resident_prepare(corpus,
                                                            *clips_frames))
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}

    def run():
        set_shard(model, mesh is not None)
        box[0], m = step(box[0], raw, seed=0)
        float(m["loss"])
        set_shard(model, False)

    return run


def lpips_call(lpips, gt):
    frames = gt.reshape(-1, *gt.shape[2:])
    pred = frames.detach().clone().requires_grad_(True)

    def run():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = lpips(frames, pred)
        loss.backward()
        pred.grad = None

    return run


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def top_diff(a, b, n=12):
    """The n operators whose device ms differ most between profiles a
    and b, each as [a's, b's]."""
    keys = sorted(set(a) | set(b), key=lambda k: -abs(b.get(k, 0)
                                                       - a.get(k, 0)))
    return {k: [a.get(k, 0.0), b.get(k, 0.0)] for k in keys[:n]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_shard_split_torch: no CUDA device", file=sys.stderr)
        return 1
    collectives.halo_exchange = zero_halos
    dev = torch.device("cuda")
    model = VQVAE(ModelConfig(), dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    videos = {k: torch.rand((b, t, SIZE, SIZE, 6), generator=gen,
                            device=dev) * 2 - 1
              for k, (b, t) in LAYOUTS.items()}
    calls = {
        "plain_16x8": model_call(model, videos["16x8"], False),
        "plain_1x128": model_call(model, videos["1x128"], False),
        "shard_1x128": model_call(model, videos["1x128"], True),
        "plain_2x64": model_call(model, videos["2x64"], False),
        "shard_2x64": model_call(model, videos["2x64"], True),
    }
    # every configuration twice, in the order A B ... B A
    order = list(calls) + list(calls)[::-1]
    seen = {k: [] for k in calls}
    for name in order:
        seen[name].append(cuda_ms(calls[name], args.reps))
    res = {"model_fwd_bwd_ms": {k: statistics.mean(v) for k, v in
                                seen.items()},
           "model_fwd_bwd_ms_turns": seen}

    frames, lms, n = synthetic_corpus(4, 520, SIZE, seed=3, device=dev)
    corpus = corpus_from_arrays(frames, lms, n, device=dev)
    del frames
    pgen = torch.Generator(device=dev).manual_seed(0)
    prep = {}
    for name, (b, t) in PREPARE.items():
        prepare = make_resident_prepare(corpus, b, t)
        prep[name] = cuda_ms(lambda: prepare(pgen, corpus.frames,
                                             corpus.landmarks), args.reps)
    res["prepare_ms"] = prep

    a = profile_ops(calls["plain_16x8"])
    b = profile_ops(calls["shard_1x128"])
    res["ops_device_ms_plain_16x8_vs_shard_1x128"] = top_diff(a, b)
    res["ops_total_device_ms"] = [sum(a.values()), sum(b.values())]
    del calls, videos, model

    lpips = init_lpips(torch.Generator().manual_seed(1), device=dev)
    steps = {k: step_call(corpus, lpips, *v) for k, v in STEPS.items()}
    order = list(steps) + list(steps)[::-1]
    seen = {k: [] for k in steps}
    for name in order:
        seen[name].append(host_ms(steps[name], args.reps))
    res["step_ms"] = {k: statistics.mean(v) for k, v in seen.items()}
    res["step_ms_turns"] = seen
    a = profile_ops(steps["plain_16x8"])
    b = profile_ops(steps["time4_rank1"])
    res["step_ops_device_ms_plain_vs_time4_rank1"] = top_diff(a, b, 16)
    res["step_ops_total_device_ms"] = [sum(a.values()), sum(b.values())]
    del steps

    model = VQVAE(ModelConfig(), dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(0))
    batches = {}
    for name, (clips_frames, mesh) in STEPS.items():
        if name == "data2_time2_rank1":
            continue
        with torch.no_grad():
            b = make_resident_prepare(corpus, *clips_frames)(
                torch.Generator(device=dev).manual_seed(5), corpus.frames,
                corpus.landmarks)
        if mesh is not None:
            b = {k: frame_block(v, mesh) for k, v in b.items()}
        batches[name] = b
    calls = {}
    for name, b in batches.items():
        calls[f"lpips_{name}"] = lpips_call(lpips, b["gt"])
        calls[f"model_{name}"] = model_call(model, b["input"],
                                            name != "plain_16x8")
    order = list(calls) + list(calls)[::-1]
    seen = {k: [] for k in calls}
    for name in order:
        seen[name].append(cuda_ms(calls[name], args.reps))
    res["inputs_fwd_bwd_ms"] = {k: statistics.mean(v)
                                for k, v in seen.items()}
    res["inputs_fwd_bwd_ms_turns"] = seen

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    res["card"] = card
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
