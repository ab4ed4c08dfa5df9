"""Stage 2 of preprocessing: face clips -> per-frame landmarks and frames,
counterpart of `faceoff_tpu/preprocess/landmarks.py` without OpenCV.

Writes the on-disk contract the training datasets read
(`data/dataset.py`, and the JAX package's): per clip, a directory of
`NNNNN.jpg` frames (nvJPEG on CUDA) or `NNNNN.png` frames (on the CPU,
which has no JPEG codec) plus `NNNNN_landmarks.npz` files (key
'landmark', (68, 2) float32 pixel coordinates on the resized frame).
Clips where more than `max_bad_frac` of the frames have no landmarks are
quarantined: nothing is written and the clip is reported. Frames without
landmarks are skipped and the numbering keeps each frame's index.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
from glob import glob
from typing import List, Optional, Tuple

import numpy as np
import torch

from faceoff_tpu_torch.data.geometry import resize_frame_tensor
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.io.image import write_jpeg, write_png
from faceoff_tpu_torch.io.video import read_video_frames
from faceoff_tpu_torch.preprocess.detectors import default_landmarker

MAX_BAD_FRACTION = 0.10


def generate_landmarks_for_video(
    video_path: str,
    out_dir: Optional[str] = None,
    *,
    landmarker=None,
    resolution: int = 256,
    max_bad_frac: float = MAX_BAD_FRACTION,
    batch_size: int = 32,
    device: DeviceLike = None,
) -> Tuple[bool, int, int]:
    """Process one clip on `device` (CUDA unless named). Returns (ok,
    n_written, n_bad); ok=False means the clip was quarantined and nothing
    was written."""
    dev = resolve_device(device)
    landmarker = landmarker or default_landmarker(dev)
    out_dir = out_dir or osp.splitext(video_path)[0]

    frames = read_video_frames(video_path, device=dev)
    if len(frames) == 0:
        return False, 0, 0
    if isinstance(frames, list):
        frames = torch.from_numpy(np.stack(frames))
    resized = resize_frame_tensor(frames, resolution)

    all_lms: List[Optional[np.ndarray]] = []
    if getattr(landmarker, "tracks_across_frames", False):
        # trackers carry state frame to frame: feed the whole clip
        all_lms = landmarker.landmarks(resized)
    else:
        for i in range(0, len(resized), batch_size):
            all_lms += landmarker.landmarks(resized[i: i + batch_size])

    def valid(lm):
        return lm is not None and lm.shape == (68, 2)

    n_bad = sum(0 if valid(lm) else 1 for lm in all_lms)
    if n_bad > max_bad_frac * len(all_lms):
        return False, 0, n_bad

    os.makedirs(out_dir, exist_ok=True)
    n_written = 0
    for i, (frame, lm) in enumerate(zip(resized, all_lms)):
        if not valid(lm):
            continue  # skip bad frames, keep the numbering
        if dev.type == "cuda":
            write_jpeg(osp.join(out_dir, f"{i:05d}.jpg"), frame)
        else:
            write_png(osp.join(out_dir, f"{i:05d}.png"), frame.numpy())
        np.savez(osp.join(out_dir, f"{i:05d}_landmarks.npz"),
                 landmark=np.asarray(lm, np.float32))
        n_written += 1
    return True, n_written, n_bad


def generate_landmarks_for_dataset(
    clips_root: str, *, landmarker=None, num_workers: int = 4,
    device: DeviceLike = None, **kwargs
) -> Tuple[List[str], List[str]]:
    """Process every `*.mp4` and `*.avi` clip under clips_root (at any
    depth) in a pool of `num_workers` threads; returns (ok, quarantined)
    paths."""
    from concurrent.futures import ThreadPoolExecutor

    dev = resolve_device(device)
    paths = sorted(glob(osp.join(clips_root, "**", "*.mp4"), recursive=True)
                   + glob(osp.join(clips_root, "**", "*.avi"),
                          recursive=True))
    ok_list: List[str] = []
    bad_list: List[str] = []

    def work(path):
        # a stream of its own, so that one thread's nvJPEG waits do not
        # wait for the others' work
        with torch.cuda.stream(torch.cuda.Stream(dev)) if \
                dev.type == "cuda" else contextlib.nullcontext():
            ok, _, _ = generate_landmarks_for_video(
                path, landmarker=landmarker, device=dev, **kwargs)
        return path, ok

    with ThreadPoolExecutor(max(1, num_workers)) as pool:
        for path, ok in pool.map(work, paths):
            (ok_list if ok else bad_list).append(path)
    return ok_list, bad_list
