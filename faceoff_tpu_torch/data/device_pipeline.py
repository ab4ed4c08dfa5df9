"""The training input on the device: raw frames and landmarks in, the
training batch out, counterpart of `faceoff_tpu/data/device_pipeline.py`.

    in:  (B, T, H, W, 3) uint8 frames, (B, T, 68, 2) landmarks
    out: {"input": (B, T, H, W, 6), "gt": (B, T, H, W, 3)} float32 in [-1, 1]

Hull masks, the face/background split, the composite perturbation (one
batched warp of all B*T frames), the colour jitter and the normalisation
all run where the frames lie. Randomness comes from an explicit
`torch.Generator` on that device; `draw_train_batch` draws it, and
`prepare_train_batch` takes the draws as an argument so that a test can
hand it the JAX package's. `RawClipLoader` feeds it from disk
(--device_pipeline).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from faceoff_tpu_torch.ops import warp as W


def eye_centers_from_landmarks(lms: torch.Tensor) -> torch.Tensor:
    """(..., 68, 2) -> (..., 2): the midpoint of the two eye centroids,
    each the mean of points 36:41 and 42:47 as the reference takes them."""
    left = torch.mean(lms[..., 36:41, :], dim=-2)
    right = torch.mean(lms[..., 42:47, :], dim=-2)
    return (left + right) / 2.0


def draw_train_batch(
    generator: torch.Generator, b: int, t: int, color_jitter: str = ""
) -> Dict[str, object]:
    """The random draws of one batch: the perturbation of each of the B*T
    frames and, with `color_jitter`, brightness and saturation factors in
    [1, 1.5), one per clip ("const") or one per frame."""
    draws: Dict[str, object] = {
        "perturb": W.draw_perturbation(generator, b * t)}
    if color_jitter:
        shape = (b, 1, 1, 1, 1) if color_jitter == "const" else (
            b * t, 1, 1, 1)
        dev = generator.device
        draws["brightness"] = 1.0 + 0.5 * torch.rand(
            shape, generator=generator, device=dev)
        draws["saturation"] = 1.0 + 0.5 * torch.rand(
            shape, generator=generator, device=dev)
    return draws


def prepare_train_batch(
    generator: Optional[torch.Generator],
    frames: torch.Tensor,
    landmarks: torch.Tensor,
    *,
    hull_start: int = 17,
    hull_end: int = 67,
    color_jitter: str = "",
    draws: Optional[Dict[str, object]] = None,
) -> Dict[str, torch.Tensor]:
    """The self-supervised training input: each frame's face inside the
    landmark hull, perturbed, composited over its own background.

    frames (B, T, H, W, 3) uint8 or float in [0, 255]; landmarks
    (B, T, 68, 2). Draws come from `generator` unless `draws` is given.
    """
    b, t, h, w = frames.shape[:4]
    if draws is None:
        draws = draw_train_batch(generator, b, t, color_jitter)
    imgs = frames.to(torch.float32) / 127.5 - 1.0
    flat_imgs = imgs.reshape(b * t, h, w, 3)
    flat_lms = landmarks.reshape(b * t, 68, 2).to(torch.float32)

    masks = W.convex_mask(flat_lms[:, hull_start:hull_end], h, w)[..., None]
    # the masked face keeps the background at the "black" extreme (-1)
    face = (flat_imgs + 1.0) * masks - 1.0
    background = (flat_imgs + 1.0) * (1.0 - masks) - 1.0

    eyes = eye_centers_from_landmarks(flat_lms)
    # perturb in [0, 1] so that empty regions stay empty under resampling
    face01 = (face + 1.0) * 0.5
    perturbed = W.perturb_clip(None, face01, eyes, params=draws["perturb"])

    if color_jitter:
        dev = perturbed.device
        brightness = draws["brightness"].to(dev)
        saturation = draws["saturation"].to(dev)
        if color_jitter == "const":
            brightness = brightness.expand(b, t, 1, 1, 1).reshape(
                b * t, 1, 1, 1)
            saturation = saturation.expand(b, t, 1, 1, 1).reshape(
                b * t, 1, 1, 1)
        p = perturbed * brightness
        gray = (0.299 * p[..., 0] + 0.587 * p[..., 1]
                + 0.114 * p[..., 2])[..., None]
        perturbed = torch.clamp(gray + saturation * (p - gray), 0.0, 1.0)

    source = perturbed * 2.0 - 1.0
    inputs = torch.cat([source, background], dim=-1)
    return {"input": inputs.reshape(b, t, h, w, 6), "gt": imgs}


class _RawView:
    """A dataset view whose items are raw clip windows: decoded frames and
    landmarks, no geometry."""

    def __init__(self, dataset):
        self.ds = dataset

    def __len__(self):
        return len(self.ds)

    def get_item(self, index, rng):
        from faceoff_tpu_torch.data.dataset import (_landmark_paths,
                                                    load_window_frames)

        paths = _landmark_paths(self.ds.videos[index])
        window = self.ds._sample_window(paths, rng)
        frames, lms = load_window_frames(window, self.ds.resolution,
                                         self.ds.device)
        return {"frames": frames, "landmarks": lms}


def _pack_raw(items):
    return {"frames": np.stack([it["frames"] for it in items]),
            "landmarks": np.stack([it["landmarks"] for it in items])}


class RawClipLoader:
    """Host loader of raw (frames uint8, landmarks) batches for
    `prepare_train_batch` on the device: the host only decodes frames and
    reads landmarks. The windows are the DataLoader's, seeded alike."""

    def __init__(
        self, dataset, batch_clips: int = 1, *, num_workers: int = 8,
        prefetch: int = 2, seed: int = 0, shuffle: bool = True,
        shard_index: int = 0, shard_count: int = 1,
    ):
        from faceoff_tpu_torch.data.pipeline import DataLoader

        self.loader = DataLoader(
            _RawView(dataset), batch_clips, shuffle=shuffle,
            num_workers=num_workers, prefetch=prefetch, seed=seed,
            pack=_pack_raw, shard_index=shard_index, shard_count=shard_count)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return iter(self.loader)
