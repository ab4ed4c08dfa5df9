"""Offline preprocessing command line, twin of
`faceoff_tpu/cli/preprocess.py`: raw videos -> a training-ready dataset.

    # stage 1: face-crop clips
    python -m faceoff_tpu_torch.cli.preprocess crop --videos raw/ --out clips/

    # stage 2: landmarks (writes the dataset contract)
    python -m faceoff_tpu_torch.cli.preprocess landmarks --clips clips/

    # both
    python -m faceoff_tpu_torch.cli.preprocess all --videos raw/ --out clips/

The same subcommands, flags and defaults as the JAX CLI, with the
backends the JAX package picks without mediapipe and face_alignment
(`preprocess/detectors.py`). Input videos are `*.mp4` (mp4v, as the JAX
package and cv2 write them; an H.264 mp4 raises naming its codec) and the
port's `*.avi` (uncompressed or motion JPEG). The clips are `NNNNN.mp4`
(mp4v) as the JAX package writes them; on CUDA the frames are JPEG
(nvJPEG); `main(argv, device="cpu")` runs on the CPU and writes PNG
frames.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

from faceoff_tpu_torch.device import DeviceLike, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    crop = sub.add_parser("crop")
    crop.add_argument("--videos", required=True)
    crop.add_argument("--out", required=True)
    crop.add_argument("--resolution", type=int, default=256)
    crop.add_argument("--min_frames", type=int, default=30)

    lms = sub.add_parser("landmarks")
    lms.add_argument("--clips", required=True)
    lms.add_argument("--resolution", type=int, default=256)
    lms.add_argument("--bad_list", default=None,
                     help="write quarantined clip paths as json")

    both = sub.add_parser("all")
    both.add_argument("--videos", required=True)
    both.add_argument("--out", required=True)
    both.add_argument("--resolution", type=int, default=256)
    both.add_argument("--min_frames", type=int, default=30)
    both.add_argument("--bad_list", default=None)
    return p


def main(argv=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Run the stages on `device` (CUDA unless named). Returns the clips
    written ("clips") and the landmark stage's ("ok", "quarantined")
    paths, for the stages that ran."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    out: Dict[str, Any] = {}

    if args.cmd in ("crop", "all"):
        from faceoff_tpu_torch.preprocess.face_crop import process_videos

        written = process_videos(args.videos, args.out,
                                 resolution=args.resolution,
                                 min_frames=args.min_frames, device=dev)
        print(f"crop: wrote {len(written)} clips under {args.out}",
              flush=True)
        out["clips"] = written

    if args.cmd in ("landmarks", "all"):
        from faceoff_tpu_torch.preprocess.landmarks import (
            generate_landmarks_for_dataset)

        clips_root = args.out if args.cmd == "all" else args.clips
        ok, bad = generate_landmarks_for_dataset(
            clips_root, resolution=args.resolution, device=dev)
        print(f"landmarks: {len(ok)} clips ok, {len(bad)} quarantined",
              flush=True)
        if args.bad_list:
            with open(args.bad_list, "w") as f:
                json.dump(bad, f, indent=1)
            print(f"quarantine list -> {args.bad_list}", flush=True)
        out.update(ok=ok, quarantined=bad)
    return out


if __name__ == "__main__":
    main()
