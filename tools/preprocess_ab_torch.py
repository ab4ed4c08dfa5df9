#!/usr/bin/env python3
"""Time offline preprocessing's two stages with this checkout's package
against another checkout's, in turns, on the card.

    python3 tools/preprocess_ab_torch.py OTHER_REPO [--pairs N]

OTHER_REPO is the root of another checkout (for example `git archive` of
a parent commit unpacked into a git-ignored directory). The footage is
`chip_smoke.py`'s preprocess phase's (four 300-frame 1280x720 motion-JPEG
videos), written once by this checkout. Each run is a fresh interpreter
with one checkout on its path: `cli/preprocess.main(["all", ...])` on the
footage into a fresh directory, stage 1 (`face_crop.process_videos`) and
stage 2 (`landmarks.generate_landmarks_for_dataset`) each timed on the
host clock to a synchronize, as the phase times them, after the CUDA
context and the kernels' libraries are loaded (each checkout builds its
own, in its first run). The checkouts run in turns
(this, other, other, this, ...), so that a slower or busier host moves
both alike. Prints one JSON line a run (a run that fails is printed with
its exit code and output ends, and left out), then one with each
checkout's runs, failures, median and quartiles of stage 1 and stage 2
frames/s and the card's name and power limit; exits 1 if a run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CHILD = r"""
import json, sys, time
from pathlib import Path
import torch
from faceoff_tpu_torch.cli import preprocess as pre_cli
from faceoff_tpu_torch.io import image as image_io
from faceoff_tpu_torch.ops import ccl_cuda, lk_cuda, mpeg4_cuda
from faceoff_tpu_torch.preprocess import face_crop, landmarks

raw, out = Path(sys.argv[1]), Path(sys.argv[2])
size, min_frames = sys.argv[3:5]
# the context and the kernels' builds before any stage is timed
torch.zeros(1, device="cuda")
for lib in (ccl_cuda, lk_cuda, mpeg4_cuda):
    lib.load()
image_io.load_jpeg()
stages = {}

def timed(module, name):
    fn = getattr(module, name)
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        return result
    setattr(module, name, wrapper)

timed(face_crop, "process_videos")
timed(landmarks, "generate_landmarks_for_dataset")
res = pre_cli.main(["all", "--videos", str(raw), "--out", str(out),
                    "--resolution", size, "--min_frames", min_frames],
                   device="cuda")
frames = len(list(out.glob("**/*.jpg")))
print(json.dumps({"stage1_s": stages["process_videos"],
                  "stage2_s": stages["generate_landmarks_for_dataset"],
                  "stage2_frames": frames, "clips": len(res["ok"])}))
"""


def run(tree: Path, raw: Path, out: Path, size: int, min_frames: int
        ) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(raw), str(out), str(size),
         str(min_frames)], cwd=tree,
        env={**os.environ, "PYTHONPATH": str(tree)}, capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        return {"failed": proc.returncode, "stdout": proc.stdout[-1500:],
                "stderr": proc.stderr[-1500:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def quartiles(values):
    q = statistics.quantiles(values, n=4) if len(values) > 1 else values * 3
    return {"median": statistics.median(values), "q1": q[0], "q3": q[-1]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", help="root of the other checkout")
    parser.add_argument("--pairs", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as cs

    trees = {"this": REPO, "other": Path(args.other).resolve()}
    runs = {k: [] for k in trees}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        raw = work / "raw"
        raw.mkdir()
        cs.preprocess_footage(raw)
        order = []
        for p in range(args.pairs):
            order += ["this", "other"] if p % 2 == 0 else ["other", "this"]
        for i, name in enumerate(order):
            r = run(trees[name], raw, work / f"out{i}", cs.TRAIN_SIZE,
                    cs.PRE_MIN_FRAMES)
            r["tree"] = name
            if "failed" not in r:
                r.update(stage1_frames_per_s=cs.PRE_VIDEOS * cs.PRE_FRAMES
                         / r["stage1_s"],
                         stage2_frames_per_s=r["stage2_frames"]
                         / r["stage2_s"])
            runs[name].append(r)
            print(json.dumps(r), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    summary = {"card": card}
    for name, rs in runs.items():
        ok = [r for r in rs if "failed" not in r]
        summary[name] = {"runs": len(ok), "failed": len(rs) - len(ok), **{
            key: quartiles([r[key] for r in ok]) for key in (
                "stage1_frames_per_s", "stage2_frames_per_s") if ok}}
    print(json.dumps(summary), flush=True)
    return 0 if all("failed" not in r for rs in runs.values()
                    for r in rs) else 1


if __name__ == "__main__":
    sys.exit(main())
