#!/usr/bin/env python3
"""Measure the mp4v codec's batch size on the card: for each number of
VOPs a batch, encode and decode frames/s, V1-V4 launches a clip and the
device bytes a batch takes a pixel of the 16-aligned VOP, beside what
`io/mpeg4.batch_vops` picks from BATCH_BYTES and WORK_BYTES.

    python3 tools/mp4_batch_torch.py [--frames 300] [--sizes 12 48 72 144 300]

Two clips, drawn on the card: a face drifting over a textured background
at 1280x720, as chip_smoke.py's preprocessing footage, and the 256 px
synthetic video of data/synthetic.py. Each batch size runs twice, in
turns (the sizes forward, then backward), after a warm-up at the
module's own size; each run encodes the clip, then decodes the file's
samples batch by batch without keeping the frames. Memory is the peak
allocated above what was held before the call (the clip, and for the
decode the samples' records nowhere on the card). Prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from faceoff_tpu_torch.data.synthetic import (draw_faces,  # noqa: E402
                                              face_landmarks, video_frames)
from faceoff_tpu_torch.io import mpeg4  # noqa: E402
from faceoff_tpu_torch.ops import mpeg4_cuda  # noqa: E402

FPS = 25
DRAW_CHUNK = 50


def footage_720p(n: int, dev) -> torch.Tensor:
    """(n, 720, 1280, 3) uint8: a face drifting over grey texture."""
    h, w = 720, 1280
    gen = torch.Generator(device=dev).manual_seed(100)
    noise = torch.rand((1, 1, h // 16, w // 16), generator=gen,
                       device=dev) * 70 + 20
    grey = torch.nn.functional.interpolate(noise, size=(h, w), mode="bicubic",
                                           align_corners=False)
    bg = grey[0, 0].clamp(0, 255).round().to(torch.uint8)[..., None]
    bg = bg.expand(h, w, 3)
    lms = np.stack([face_landmarks((w * (0.4 + 0.03 * np.sin(0.05 * f)),
                                    h * (0.5 + 0.03 * np.cos(0.04 * f))),
                                   h * 0.15, 4 * np.sin(0.03 * f))
                    for f in range(n)]).astype(np.float32)
    parts = []
    for lo in range(0, n, DRAW_CHUNK):
        hi = min(n, lo + DRAW_CHUNK)
        parts.append(draw_faces(bg.expand(hi - lo, -1, -1, -1),
                                torch.from_numpy(lms[lo:hi]).to(dev),
                                (205, 165, 140)))
    return torch.cat(parts)


def run(frames: torch.Tensor, batch: int) -> dict:
    """Encode then decode `frames` with `batch` VOPs a batch."""
    n, h, w = frames.shape[:3]
    vol = mpeg4.Vol(w, h, FPS)
    pixels = 256 * vol.n_mb
    per = min(batch, n)
    own = mpeg4.batch_vops
    mpeg4.batch_vops = lambda _vol: batch
    try:
        for k in mpeg4_cuda.launches:
            mpeg4_cuda.launches[k] = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        samples, sync, _, _ = mpeg4.encode(frames, FPS)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t
        enc_peak = torch.cuda.max_memory_allocated() - base
        enc_launches = dict(mpeg4_cuda.launches)
        for k in mpeg4_cuda.launches:
            mpeg4_cuda.launches[k] = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got = 0
        for part in mpeg4.iter_decode(samples, vol, frames.device, sync):
            got += part.shape[0]
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t
        dec_peak = torch.cuda.max_memory_allocated() - base
        if got != n:
            raise AssertionError(f"decoded {got} of {n} frames")
        return {"encode_frames_per_s": n / enc_s,
                "decode_frames_per_s": n / dec_s,
                "encode_peak_bytes": enc_peak,
                "decode_peak_bytes": dec_peak,
                "encode_bytes_per_pixel": enc_peak / (per * pixels),
                "decode_bytes_per_pixel": dec_peak / (per * pixels),
                "encode_launches": enc_launches,
                "decode_launches": dict(mpeg4_cuda.launches)}
    finally:
        mpeg4.batch_vops = own


def sweep(frames: torch.Tensor, sizes) -> dict:
    h, w = frames.shape[1:3]
    vol = mpeg4.Vol(w, h, FPS)
    run(frames, mpeg4.batch_vops(vol))  # warm-up: build, threads, pool
    runs = {s: [] for s in sizes}
    for s in list(sizes) + list(reversed(sizes)):
        runs[s].append(run(frames, s))
    out = {}
    for s, rs in runs.items():
        row = {k: [r[k] for r in rs] for k in rs[0]
               if not k.endswith("launches")}
        row["encode_launches"] = rs[0]["encode_launches"]
        row["decode_launches"] = rs[0]["decode_launches"]
        out[str(s)] = row
    return {"frames": frames.shape[0], "size": f"{w}x{h}",
            "module_batch_vops": mpeg4.batch_vops(vol), "runs": out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[12, 48, 72, 144, 300])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mp4_batch_torch: needs a CUDA card")
    dev = torch.device("cuda")
    mpeg4_cuda.load()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    result = {"card": card, "batch_bytes": mpeg4.BATCH_BYTES,
              "work_bytes": mpeg4.WORK_BYTES, "host_threads":
              mpeg4_cuda.threads()}
    big = footage_720p(args.frames, dev)
    result["720p"] = sweep(big, args.sizes)
    del big
    small = video_frames(args.frames, 256, seed=4, device=dev)[0]
    result["256"] = sweep(small, [s for s in args.sizes if s <= 48]
                          + [args.frames])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
