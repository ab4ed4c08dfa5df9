#!/usr/bin/env python3
"""Where stage 2 of the port's preprocessing spends its time, on the card.

    python3 tools/preprocess_profile_torch.py [--top N]

Writes one raw motion-JPEG video as `chip_smoke.py`'s preprocess phase
does (300 frames of 1280x720, a cut at frame 150), crops it into its two
clips (stage 1), runs stage 2 once on the first clip to warm up, then
once more under cProfile, and times stage 2 over both clips with 1 and
with 4 worker threads. Prints the profile's top N functions by
cumulative time, then one JSON line: the clip's seconds, the seconds of
the profile's main parts (the seeds, the tracking, the frame and
landmark writes, the pyramid builds), the two thread counts' seconds,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from faceoff_tpu_torch.preprocess import face_crop, landmarks  # noqa: E402

# the profile's entries reported in the JSON line: (file suffix, function)
PARTS = {
    "seeds": ("preprocess/detectors.py", "_seed_one"),
    "tracking": ("preprocess/detectors.py", "_track"),
    "pyramids": ("ops/lk_cuda.py", "build_pyramids"),
    "frame_writes": ("io/image.py", "write_jpeg"),
    "landmark_writes": ("numpy/lib/_npyio_impl.py", "savez"),
    "detection": ("preprocess/detectors.py", "detect_batch"),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.PRE_VIDEOS = 1
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        (work / "raw").mkdir()
        chip_smoke.preprocess_footage(work / "raw")
        clips = face_crop.process_videos(str(work / "raw"),
                                         str(work / "clips"), device="cuda")
        landmarks.generate_landmarks_for_video(clips[0], str(work / "warm"),
                                               device="cuda")
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        t = time.perf_counter()
        prof.enable()
        landmarks.generate_landmarks_for_video(clips[0], str(work / "one"),
                                               device="cuda")
        torch.cuda.synchronize()
        prof.disable()
        clip_s = time.perf_counter() - t
        out = io.StringIO()
        stats = pstats.Stats(prof, stream=out)
        stats.sort_stats("cumulative").print_stats(args.top)
        print(out.getvalue(), flush=True)
        parts = {}
        for (path, _, name), row in stats.stats.items():
            for key, (suffix, fn) in PARTS.items():
                if path.endswith(suffix) and name == fn:
                    parts[key] = parts.get(key, 0.0) + row[3]
        threads = {}
        for n in (1, 4):
            t = time.perf_counter()
            landmarks.generate_landmarks_for_dataset(
                str(work / "clips"), num_workers=n, device="cuda")
            torch.cuda.synchronize()
            threads[n] = time.perf_counter() - t
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "clips": len(clips),
                      "clip_frames": chip_smoke.PRE_CUT,
                      "one_clip_s": clip_s, "parts_s": parts,
                      "two_clips_s_by_threads": threads}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
