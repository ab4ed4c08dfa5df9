"""Stage 1 of preprocessing: raw videos -> constant-crop face clips,
counterpart of `faceoff_tpu/preprocess/face_crop.py` without OpenCV.

Detect a face box per frame, split the video wherever the box jumps (IoU
with the running segment below 0.7) or is lost, average each stable
segment's boxes into one square crop, and write every segment of at
least `min_frames` frames as its own clip, in memory-bounded chunks of
`chunk_frames` frames.

Input is `*.mp4` (mp4v, as cv2 writes it; H.264 mp4 raises naming its
codec) and the port's `*.avi` (uncompressed, or motion JPEG on CUDA), the
format found by content. Detection runs batched on
the frames' device (`HeuristicDetector.detect_batch`, in launches of its
`batch_size` frames, the same boxes as frame by frame). Crops are resized
with `geometry.resize_tensor`, cv2.resize's integers. Clips are written
as `NNNNN.mp4` (mp4v, encoded on the device), as the JAX package names
them.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np

from faceoff_tpu_torch.data.geometry import resize_tensor
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.io.video import save_frames_as_video, video_frame_chunks
from faceoff_tpu_torch.preprocess.detectors import Box, default_detector

IOU_THRESHOLD = 0.7
MIN_CLIP_FRAMES = 30
CHUNK_FRAMES = 8000
# frames a crop resize takes at once (its int64 temporaries stay small)
RESIZE_BATCH = 32


def iou(a: Box, b: Box) -> float:
    """Intersection-over-union of two (x1, y1, x2, y2) boxes."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(ix2 - ix1, 0), max(iy2 - iy1, 0)
    inter = iw * ih
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def square_crop_box(box: Box, frame_shape, margin: float = 0.25) -> Box:
    """Expand a face box into a margin-padded square crop clamped to the
    frame."""
    h, w = frame_shape[:2]
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    half = max(x2 - x1, y2 - y1) * (1 + margin) / 2
    return (
        int(max(cx - half, 0)),
        int(max(cy - half, 0)),
        int(min(cx + half, w)),
        int(min(cy + half, h)),
    )


def segment_stable_boxes(
    boxes: Sequence[Optional[Box]],
    iou_threshold: float = IOU_THRESHOLD,
    min_frames: int = MIN_CLIP_FRAMES,
) -> List[Tuple[int, int, Box]]:
    """Split a per-frame box track into stable segments: [(start,
    end_exclusive, mean_box)] for every run of consecutive detections
    whose IoU with the segment's last box stays >= threshold and whose
    length is >= min_frames."""
    segments: List[Tuple[int, int, Box]] = []
    start: Optional[int] = None
    acc: List[Box] = []

    def flush(end: int):
        nonlocal start, acc
        if start is not None and end - start >= min_frames:
            mean = tuple(int(v) for v in np.mean(acc, axis=0))
            segments.append((start, end, mean))  # type: ignore[arg-type]
        start, acc = None, []

    for i, box in enumerate(boxes):
        if box is None:
            flush(i)
            continue
        if start is None:
            start, acc = i, [box]
        elif iou(acc[-1], box) >= iou_threshold:
            acc.append(box)
        else:
            flush(i)
            start, acc = i, [box]
    flush(len(boxes))
    return segments


def process_video(
    video_path: str,
    out_dir: str,
    *,
    detector=None,
    resolution: int = 256,
    min_frames: int = MIN_CLIP_FRAMES,
    chunk_frames: int = CHUNK_FRAMES,
    fps: int = 25,
    device: DeviceLike = None,
) -> List[str]:
    """Crop one raw video into stable face clips on `device` (CUDA unless
    named); returns the written paths (`NNNNN.mp4`, numbered across the
    video's chunks)."""
    dev = resolve_device(device)
    detector = detector or default_detector(dev)
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    clip_idx = 0
    for frames in video_frame_chunks(video_path, chunk_frames, dev):
        boxes = detector.detect_batch(frames)
        for start, end, mean_box in segment_stable_boxes(
                boxes, min_frames=min_frames):
            x1, y1, x2, y2 = square_crop_box(mean_box, frames.shape[1:3])
            clip = []
            for lo in range(start, end, RESIZE_BATCH):
                crops = frames[lo: min(end, lo + RESIZE_BATCH), y1:y2, x1:x2]
                clip.extend(resize_tensor(crops, (resolution, resolution)))
            out_path = osp.join(out_dir, f"{clip_idx:05d}.mp4")
            save_frames_as_video(clip, out_path, fps, device=dev)
            written.append(out_path)
            clip_idx += 1
    return written


def process_videos(video_dir: str, out_root: str, *, detector=None,
                   device: DeviceLike = None, **kwargs) -> List[str]:
    """Process every `*.mp4` and `*.avi` under video_dir into
    out_root/<name>/."""
    dev = resolve_device(device)
    detector = detector or default_detector(dev)
    written: List[str] = []
    for path in sorted(glob(osp.join(video_dir, "*.mp4"))
                       + glob(osp.join(video_dir, "*.avi"))):
        name = osp.splitext(osp.basename(path))[0]
        written += process_video(path, osp.join(out_root, name),
                                 detector=detector, device=dev, **kwargs)
    return written
