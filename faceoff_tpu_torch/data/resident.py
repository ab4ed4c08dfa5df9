"""A corpus held on the device: every frame staged once, clip sampling and
the training input built inside each step, counterpart of
`faceoff_tpu/data/resident.py`.

    stage once:  frames (V, Fmax, H, W, 3) uint8, landmarks
                 (V, Fmax, 68, 2) float32, n_frames (V,)
    every step:  sample B clip windows, hull/perturb/composite on the
                 device; the host only launches.

`build_resident_corpus` decodes every frame of a dataset on disk
(`data/dataset.py`): PNG frames on the host, JPEG frames with nvJPEG
straight into the tensor on the card. `corpus_from_arrays` stages frames
already in memory (`data/synthetic.synthetic_corpus`). Sampling follows
the dataset's policy: a uniform video, a uniform start clamped to the
video's length, short videos repeating their last frame.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from faceoff_tpu_torch.data.device_pipeline import prepare_train_batch
from faceoff_tpu_torch.device import DeviceLike, resolve_device


class ResidentCorpus:
    """The staged corpus: frames (V, Fmax, H, W, 3) uint8, landmarks
    (V, Fmax, 68, 2) float32 and n_frames (V,) int64, on one device.
    Frames past a video's n_frames are padding."""

    def __init__(self, frames: torch.Tensor, landmarks: torch.Tensor,
                 n_frames: torch.Tensor):
        self.frames = frames
        self.landmarks = landmarks
        self.n_frames = n_frames

    @property
    def n_videos(self) -> int:
        return int(self.frames.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.frames.numel() * self.frames.element_size()
                   + self.landmarks.numel() * self.landmarks.element_size())


def estimate_corpus_bytes(n_videos: int, max_frames: int,
                          resolution: int) -> int:
    return n_videos * max_frames * (resolution * resolution * 3 + 68 * 2 * 4)


def _budget_check(n_videos: int, fmax: int, h: int, w: int,
                  budget_bytes: Optional[int]) -> None:
    est = estimate_corpus_bytes(n_videos, fmax, max(h, w))
    if budget_bytes is not None and est > budget_bytes:
        raise MemoryError(
            f"resident corpus would need ~{est / 2**30:.2f} GiB ({n_videos} "
            f"videos x {fmax} frames at {h}x{w}) > budget "
            f"{budget_bytes / 2**30:.2f} GiB; cap max_frames_per_video or "
            f"fall back to --device_pipeline")


def corpus_from_arrays(
    frames,
    landmarks,
    n_frames,
    device: DeviceLike = None,
    budget_bytes: Optional[int] = 8 << 30,
) -> ResidentCorpus:
    """Stage frames (V, Fmax, H, W, 3) uint8, landmarks (V, Fmax, 68, 2)
    and n_frames (V,) (numpy arrays or tensors) on `device` (CUDA unless
    named). Raises MemoryError before staging when the corpus would take
    more than `budget_bytes` (None disables the guard), so that it cannot
    silently crowd out the model."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames)
    if frames.dtype != torch.uint8 or frames.dim() != 5 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (V, F, H, W, 3) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    v, fmax, h, w = frames.shape[:4]
    _budget_check(v, fmax, h, w, budget_bytes)
    lms = torch.as_tensor(landmarks, dtype=torch.float32)
    counts = torch.as_tensor(n_frames, dtype=torch.int64)
    if tuple(lms.shape) != (v, fmax, 68, 2) or tuple(counts.shape) != (v,):
        raise ValueError(f"landmarks {tuple(lms.shape)} / n_frames "
                         f"{tuple(counts.shape)} do not fit frames "
                         f"{tuple(frames.shape)}")
    return ResidentCorpus(frames.to(dev), lms.to(dev), counts.to(dev))


def _stage_video(paths, res: int, out: torch.Tensor,
                 pool: ThreadPoolExecutor) -> None:
    """Decode the frames of one video into out (F, res, res, 3) uint8:
    JPEG frames of the right size with nvJPEG straight into `out` on the
    card, every other frame on the host."""
    from faceoff_tpu_torch.data.dataset import _image_for_landmark, load_frame
    from faceoff_tpu_torch.io import image

    images = [_image_for_landmark(p) for p in paths]
    host = []
    for f, img in enumerate(images):
        if img.endswith(".jpg") and out.device.type == "cuda":
            data = Path(img).read_bytes()
            info = image.jpeg_info(data)
            if (info["height"], info["width"]) == (res, res):
                image.decode_jpeg_into(data, out[f])
                continue
        host.append(f)
    if host:
        decoded = list(pool.map(
            lambda f: load_frame(paths[f], res, out.device)[0], host))
        idx = torch.as_tensor(host, device=out.device)
        out[idx] = torch.from_numpy(np.stack(decoded)).to(out.device)


def build_resident_corpus(
    dataset,
    *,
    max_frames_per_video: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = 8 << 30,
    device: DeviceLike = None,
) -> ResidentCorpus:
    """Decode every frame of every video of `dataset`
    (`data.dataset.TemporalAlignmentDataset`) at its resolution and stage
    the padded stacks on `device` (CUDA unless named).

    max_frames_per_video keeps a prefix of long videos. Raises MemoryError
    before staging when the estimate exceeds hbm_budget_bytes (None
    disables the guard)."""
    from faceoff_tpu_torch.data.dataset import _landmark_paths, _landmarks

    dev = resolve_device(device)
    per_video = []
    for vdir in dataset.videos:
        paths = _landmark_paths(vdir)
        if max_frames_per_video is not None:
            paths = paths[:max_frames_per_video]
        per_video.append(paths)
    fmax = max(len(p) for p in per_video)
    res = dataset.resolution
    _budget_check(len(per_video), fmax, res, res, hbm_budget_bytes)

    frames = torch.zeros((len(per_video), fmax, res, res, 3),
                         dtype=torch.uint8, device=dev)
    landmarks = np.zeros((len(per_video), fmax, 68, 2), np.float32)
    n_frames = np.zeros((len(per_video),), np.int64)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for v, paths in enumerate(per_video):
            _stage_video(paths, res, frames[v], pool)
            landmarks[v, : len(paths)] = np.stack(
                [_landmarks(p) for p in paths])
            n_frames[v] = len(paths)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return ResidentCorpus(frames, torch.from_numpy(landmarks).to(dev),
                          torch.from_numpy(n_frames).to(dev))


def sample_clip_windows(
    generator: Optional[torch.Generator],
    frames: torch.Tensor,
    landmarks: torch.Tensor,
    n_frames: torch.Tensor,
    batch_clips: int,
    clip_len: int,
    *,
    vids: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample `batch_clips` windows of `clip_len` frames from the staged
    corpus: video `vids` (uniform) and start floor(u * (hi + 1)), u
    uniform in [0, 1), hi the last start that fits. Both are drawn from
    `generator` unless given. Returns (clips (B, T, H, W, 3) uint8,
    lms (B, T, 68, 2) float32)."""
    dev = frames.device
    if vids is None:
        vids = torch.randint(0, frames.shape[0], (batch_clips,),
                             generator=generator, device=generator.device)
    if u is None:
        u = torch.rand((batch_clips,), generator=generator,
                       device=generator.device)
    vids = vids.to(dev).long()
    u = u.to(dev).to(torch.float32)
    count = n_frames.to(dev)[vids]
    hi = torch.clamp_min(count - clip_len, 0)  # inclusive
    starts = torch.floor(u * (hi + 1).to(torch.float32)).long()
    starts = torch.minimum(starts, hi)
    idx = starts[:, None] + torch.arange(clip_len, device=dev)[None, :]
    # videos shorter than the clip repeat their last frame
    idx = torch.minimum(idx, torch.clamp_min(count - 1, 0)[:, None])
    return frames[vids[:, None], idx], landmarks[vids[:, None], idx]


def make_resident_prepare(
    corpus: ResidentCorpus,
    batch_clips: int,
    clip_len: int,
    *,
    color_jitter: str = "",
) -> Callable:
    """`prepare(generator, frames, landmarks) -> batch` for
    `train.train_step.make_train_step`: frames/landmarks are the whole
    staged corpus; the windows are sampled, then prepared, from one
    generator."""
    n_frames = corpus.n_frames

    def prepare(generator, frames, landmarks) -> Dict[str, torch.Tensor]:
        clips, lms = sample_clip_windows(
            generator, frames, landmarks, n_frames, batch_clips, clip_len)
        return prepare_train_batch(generator, clips, lms,
                                   color_jitter=color_jitter)

    return prepare


class ResidentBatches:
    """A loader over a staged corpus: every iteration yields the same raw
    batch {"frames": corpus.frames, "landmarks": corpus.landmarks}; the
    step's prepare function samples fresh clips from it, seeded by the
    step counter.

    len() is the epoch's optimizer steps: with steps_per_call = K the
    iterator yields max(1, steps_per_epoch // K) batches, each worth K
    steps, and len() is exactly that times K.
    """

    is_resident = True

    def __init__(self, corpus: ResidentCorpus, steps_per_epoch: int,
                 steps_per_call: int = 1, *, clips_per_step: int = 1,
                 clip_len: int = 1):
        if steps_per_epoch < 1:
            raise ValueError("steps_per_epoch must be >= 1")
        self.corpus = corpus
        self.steps_per_call = max(1, steps_per_call)
        self.calls_per_epoch = max(1, steps_per_epoch // self.steps_per_call)
        self.steps_per_epoch = self.calls_per_epoch * self.steps_per_call
        self.clips_per_step = clips_per_step
        self.clip_len = clip_len
        self._batch = {"frames": corpus.frames,
                       "landmarks": corpus.landmarks}

    def __len__(self) -> int:
        return self.steps_per_epoch

    def __iter__(self):
        for _ in range(self.calls_per_epoch):
            yield self._batch
