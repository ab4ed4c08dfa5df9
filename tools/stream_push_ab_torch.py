#!/usr/bin/env python3
"""Time the streaming push of this checkout's `serve/streaming.py` against
another version of that file, in turns, in one process on the card.

    python3 tools/stream_push_ab_torch.py OTHER_STREAMING_PY [--pushes N]

The other file is loaded as a module of its own beside the package, so
it must import only modules whose code it shares with this checkout (an
earlier `faceoff_tpu_torch/serve/streaming.py` saved with `git show`
does). Both versions wrap one flagship VQVAE in bf16 (random weights from
seed 0) at 256 px. Two modes, as `bench_torch.py --mode stream` and
`--mode swap_session` feed them: `StreamingSwapper.push` of a frame on
the card, and `SwapSession.push` of host uint8 frames and landmarks. In
each mode the two versions push in turns (this, other, other, this, ...),
each push timed on the host clock to after a read of its output on the
host, so that a slower or busier host moves both alike. Prints one JSON
line: per mode and version the p50 and quartiles of a push's ms and the
CUDA kernels and copies a push launches (torch.profiler), with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from faceoff_tpu_torch.config import ModelConfig  # noqa: E402
from faceoff_tpu_torch.models import VQVAE  # noqa: E402
from faceoff_tpu_torch.serve import streaming as this_version  # noqa: E402

HW = 256


def load_other(path: str):
    spec = importlib.util.spec_from_file_location("other_streaming", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_events_per_push(push, n: int = 5) -> float:
    """CUDA kernels and copies a push launches, from torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            push()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == cuda) / n


def in_turns(pushes: dict, n: int) -> dict:
    """ms of each push function, the two called in alternating order."""
    names = list(pushes)
    lat = {k: [] for k in names}
    for r in range(n):
        for name in (names if r % 2 == 0 else names[::-1]):
            t = time.perf_counter()
            pushes[name]().cpu()
            lat[name].append((time.perf_counter() - t) * 1e3)
    out = {}
    for name, v in lat.items():
        q1, q2, q3 = statistics.quantiles(v, n=4)
        out[name] = {"p50_ms": q2, "q1_ms": q1, "q3_ms": q3}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", help="another version of serve/streaming.py")
    parser.add_argument("--pushes", type=int, default=200,
                        help="timed pushes of each version in each mode")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("stream_push_ab_torch: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    versions = {"this": this_version, "other": load_other(args.other)}
    model = VQVAE(ModelConfig(), dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))

    frame = torch.rand((1, HW, HW, 6), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev) * 2 - 1
    rng = np.random.default_rng(0)
    host = rng.integers(0, 256, (HW, HW, 3), dtype=np.uint8)
    lms = (rng.uniform(0.3, 0.7, (68, 2)) * HW).astype(np.float32)

    modes = {}
    for mode in ("stream", "swap_session"):
        pushes = {}
        for name, mod in versions.items():
            if mode == "stream":
                sw = mod.StreamingSwapper(model, height=HW, width=HW,
                                          device=dev)
                pushes[name] = lambda sw=sw: sw.push(frame)
            else:
                sess = mod.SwapSession(model, height=HW, width=HW,
                                       device=dev)
                pushes[name] = lambda s=sess: s.push(host, lms, host, lms)
            for _ in range(8):  # the pipeline fills; warm-up
                pushes[name]()
        result = in_turns(pushes, args.pushes)
        for name, push in pushes.items():
            result[name]["device_events_per_push"] = device_events_per_push(
                push)
        modes[mode] = result
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[dev.index]
    print(json.dumps({"card": card, "pushes": args.pushes, **modes}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
