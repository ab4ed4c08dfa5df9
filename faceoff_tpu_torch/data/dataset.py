"""The video dataset of the self-supervised items, counterpart of
`faceoff_tpu/data/dataset.py` without OpenCV.

On-disk contract (the JAX package's):

    <root>/<video_id>/
        00000.png | 00000.jpg        frames (any size; padded to a square
                                     and resized to the resolution on load)
        00000_landmarks.npz          key 'landmark': (68, 2) float pixel
                                     coordinates on the resized frame

PNG frames decode on the host (`io/image.py`); JPEG frames need CUDA
(nvJPEG). Items are channels-last float32 in [-1, 1] of shape
(T, H, W, C). Randomness is explicit per call (a numpy Generator) and
drawn in the JAX package's order, so one seed gives the same windows and
perturbations in both packages.

Item modes, as in the JAX package:
  * self-supervised (`get_item_jitter`): the video's own face, segmented
    by its hull and perturbed, over its background; the frame is the
    target;
  * cross-identity (`cross_identity`): a random other video's face warped
    onto this video's frames (`geometry.generate_warped_image`), with the
    source frames as `source_original` and, with `naive_blend` "paste" or
    "poisson", the naive composite as `naive`;
  * custom validation (`custom_validation_source`): the same with a fixed
    pairing of this dataset's videos to those under another root;
  * alignment (`alignment`): self-supervised items with the negated
    ground-truth rotation and translations as `transforms`.
"""

from __future__ import annotations

import json
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from faceoff_tpu_torch.data import geometry, perturbations
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.io.image import decode_jpeg_window, read_image

def _frame_index(path: str) -> int:
    return int(osp.basename(path).split("_")[0])


def list_videos(
    root: str,
    min_landmark_files: int = 3,
    exclude_list: Optional[str] = None,
) -> List[str]:
    """Video directories at any depth under `root` with more than
    `min_landmark_files` landmark files, sorted; `exclude_list` is an
    optional JSON list of directory names or paths to skip."""
    excluded = set()
    if exclude_list:
        with open(exclude_list) as f:
            for entry in json.load(f):
                excluded.add(osp.normpath(entry))
                excluded.add(osp.basename(osp.normpath(entry)))

    roots = set()
    for lm in glob(osp.join(root, "**", "*_landmarks.npz"), recursive=True):
        roots.add(osp.dirname(lm))
    return [
        d for d in sorted(roots)
        if len(glob(osp.join(d, "*_landmarks.npz"))) > min_landmark_files
        and osp.normpath(d) not in excluded
        and osp.basename(osp.normpath(d)) not in excluded
    ]


def _landmark_paths(video_dir: str) -> List[str]:
    return sorted(glob(osp.join(video_dir, "*_landmarks.npz")),
                  key=_frame_index)


def _image_for_landmark(lm_path: str) -> str:
    stem = lm_path.rsplit("_", 1)[0]
    for ext in (".jpg", ".png"):
        if osp.exists(stem + ext):
            return stem + ext
    raise FileNotFoundError(f"no frame image for {lm_path}")


def _landmarks(lm_path: str) -> np.ndarray:
    with np.load(lm_path, allow_pickle=False) as data:
        return np.asarray(data["landmark"], np.float32)


def load_frame(lm_path: str, resolution: int = 256,
               device: DeviceLike = None):
    """(the frame resized to resolution x resolution, uint8 RGB; its
    landmarks (68, 2) float32). A JPEG frame decodes on `device`
    (`io.image.read_image`)."""
    img = geometry.resize_frame(
        read_image(_image_for_landmark(lm_path), device), resolution)
    return img, _landmarks(lm_path)


def load_window_frames(
    lm_paths: Sequence[str], resolution: int = 256,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """A clip window: (frames (T, res, res, 3) uint8, landmarks
    (T, 68, 2) float32). A window whose frames are all JPEG decodes on a
    CUDA device in one `io.image.decode_jpeg_window` call (the JAX
    package's native `fo_load_frames` path), other windows frame by
    frame."""
    images = [_image_for_landmark(p) for p in lm_paths]
    if images and all(p.endswith(".jpg") for p in images) and \
            resolve_device(device).type == "cuda":
        frames = decode_jpeg_window(images, resolution, device).cpu().numpy()
    else:
        frames = np.stack([load_frame(p, resolution, device)[0]
                           for p in lm_paths])
    lms = np.stack([_landmarks(p) for p in lm_paths])
    return frames, lms


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return img.astype(np.float32) / 127.5 - 1.0


def denormalize(img: np.ndarray) -> np.ndarray:
    return np.clip(np.rint((img + 1.0) * 127.5), 0, 255).astype(np.uint8)


def to_grayscale3(img: np.ndarray) -> np.ndarray:
    """Luma grey replicated to three channels."""
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).astype(img.dtype)
    return np.stack([gray] * 3, axis=-1)


def color_jitter(img: np.ndarray, brightness: float,
                 saturation: float) -> np.ndarray:
    """Brightness, then saturation, on uint8 RGB."""
    out = img.astype(np.float32) * brightness
    gray = (0.299 * out[..., 0] + 0.587 * out[..., 1]
            + 0.114 * out[..., 2])[..., None]
    out = gray + saturation * (out - gray)
    return np.clip(out, 0, 255).astype(np.uint8)


class TemporalAlignmentDataset:
    """Clips of the videos under `root`; `mode` in {'train', 'val'}. See
    the module docstring for the item modes."""

    def __init__(
        self,
        root: str,
        mode: str,
        max_frame_len: int,
        *,
        resolution: int = 256,
        color_jitter_type: str = "",
        cross_identity: bool = False,
        grayscale: bool = False,
        custom_validation_source: Optional[str] = None,
        hull_start: int = 17,
        hull_end: int = 67,
        mask_enlargement: int = 10,
        min_landmark_files: int = 3,
        use_bb_mask: bool = False,
        exclude_list: Optional[str] = None,
        alignment: bool = False,
        naive_blend: str = "",
        device: DeviceLike = None,
    ):
        self.mode = mode
        self.alignment = alignment
        self.max_len = max_frame_len
        self.resolution = resolution
        self.cross_identity = cross_identity
        self.grayscale = grayscale
        self.hull_slice = slice(hull_start, hull_end)
        self.mask_enlargement = mask_enlargement
        self.use_bb_mask = use_bb_mask
        # cross-identity items take no colour jitter
        self.color_jitter_type = "" if cross_identity else color_jitter_type
        if naive_blend not in ("", "paste", "poisson"):
            raise ValueError(f"unknown naive_blend '{naive_blend}'")
        self.naive_blend = naive_blend
        self.device = device  # where JPEG frames decode (io.image)
        self.videos = list_videos(root, min_landmark_files, exclude_list)
        if not self.videos:
            raise FileNotFoundError(f"no usable videos under {root}")
        self.source_videos: Optional[List[str]] = None
        if custom_validation_source is not None:
            self.source_videos = list_videos(custom_validation_source,
                                             min_landmark_files)

    def __len__(self) -> int:
        return len(self.videos)

    def _sample_window(
        self, paths: Sequence[str], rng: np.random.Generator,
        start: Optional[int] = None,
    ) -> Sequence[str]:
        """A window of max_len paths from a uniform start clamped to the
        video; a short video repeats its last frame."""
        if start is None:
            hi = max(0, len(paths) - self.max_len)
            start = int(rng.integers(0, hi + 1))
        else:
            start = min(start, max(0, len(paths) - self.max_len))
        window = list(paths[start: start + self.max_len])
        while window and len(window) < self.max_len:
            window.append(window[-1])
        return window

    def _face_mask(self, img, lms):
        if self.use_bb_mask:
            return geometry.bounding_box_mask(img.shape, lms[self.hull_slice])
        return geometry.convex_hull_mask(img.shape, lms[self.hull_slice])

    def get_item_jitter(
        self, index: int, rng: np.random.Generator
    ) -> Dict[str, np.ndarray]:
        video_dir = self.videos[index]
        window = self._sample_window(_landmark_paths(video_dir), rng)
        if not window:
            raise RuntimeError(f"empty video dir {video_dir}")

        if self.color_jitter_type == "const":
            b = float(rng.uniform(1.0, 1.5))
            s = float(rng.uniform(1.0, 1.5))

        sources, backgrounds, originals = [], [], []
        for lm_path in window:
            img, lms = load_frame(lm_path, self.resolution, self.device)
            if self.grayscale:
                img = to_grayscale3(img)
            mask = self._face_mask(img, lms)
            face = geometry.apply_mask(mask, img)
            background = geometry.apply_mask(255 - mask, img)
            perturbed, _ = perturbations.perturb_image_composite(
                face, lms, rng)

            if self.color_jitter_type == "random":
                perturbed = color_jitter(
                    perturbed, float(rng.uniform(1.0, 1.5)),
                    float(rng.uniform(1.0, 1.5)))
            elif self.color_jitter_type == "const":
                perturbed = color_jitter(perturbed, b, s)

            sources.append(normalize(perturbed))
            backgrounds.append(normalize(background))
            originals.append(normalize(img))

        return {
            "source": np.stack(sources),
            "background": np.stack(backgrounds),
            "gt": np.stack(originals),
        }

    def get_item_alignment(
        self, index: int, rng: np.random.Generator
    ) -> Dict[str, np.ndarray]:
        """A self-supervised item without colour jitter, with the negated
        rotation and translations that perturbed each frame as
        `transforms` (T, 3): what the alignment head regresses."""
        video_dir = self.videos[index]
        window = self._sample_window(_landmark_paths(video_dir), rng)
        sources, backgrounds, originals, gts = [], [], [], []
        for lm_path in window:
            img, lms = load_frame(lm_path, self.resolution, self.device)
            mask = self._face_mask(img, lms)
            face = geometry.apply_mask(mask, img)
            background = geometry.apply_mask(255 - mask, img)
            perturbed, gt_t = perturbations.perturb_image_composite(
                face, lms, rng)
            sources.append(normalize(perturbed))
            backgrounds.append(normalize(background))
            originals.append(normalize(img))
            gts.append([-gt_t["rotate_image"], -gt_t["translate_horizontal"],
                        -gt_t["translate_vertical"]])
        return {
            "source": np.stack(sources),
            "background": np.stack(backgrounds),
            "gt": np.stack(originals),
            "transforms": np.asarray(gts, np.float32),
        }

    def get_item_cross_identity(
        self,
        index: int,
        rng: np.random.Generator,
        target_index: Optional[int] = None,
        keep_same_index: bool = False,
    ) -> Dict[str, np.ndarray]:
        """This video's face warped onto another video's frames: the
        target video drawn from `rng` (or `target_index`, or the paired
        custom source), then the two window starts, each clamped and a
        short window padded with its last frame."""
        source_dir = self.videos[index]
        if self.source_videos is not None:
            target_dir = self.source_videos[index % len(self.source_videos)]
        elif target_index is not None:
            target_dir = self.videos[target_index]
        else:
            target_dir = self.videos[int(rng.integers(0, len(self.videos)))]

        src_paths = _landmark_paths(source_dir)
        tgt_paths = _landmark_paths(target_dir)
        if keep_same_index or self.source_videos is not None:
            s0 = t0 = 0
        else:
            s0 = int(rng.integers(
                0, max(5, len(src_paths) - self.max_len - 1) + 1))
            t0 = int(rng.integers(
                0, max(5, len(tgt_paths) - self.max_len - 1) + 1))
        s0 = min(s0, max(0, len(src_paths) - self.max_len))
        t0 = min(t0, max(0, len(tgt_paths) - self.max_len))
        src_w = list(src_paths[s0: s0 + self.max_len])
        tgt_w = list(tgt_paths[t0: t0 + self.max_len])
        for w in (src_w, tgt_w):
            while w and len(w) < self.max_len:
                w.append(w[-1])

        streams = {k: [] for k in ("source", "background", "gt",
                                   "source_original", "naive")}
        for sp, tp in zip(src_w, tgt_w):
            s_img, s_lms = load_frame(sp, self.resolution, self.device)
            t_img, t_lms = load_frame(tp, self.resolution, self.device)
            out = geometry.generate_warped_image(
                s_lms, t_lms, s_img, t_img,
                enlargement=self.mask_enlargement,
                poisson=self.naive_blend == "poisson")
            streams["source"].append(normalize(out["source_face_transformed"]))
            streams["background"].append(
                normalize(out["target_without_face_features"]))
            streams["gt"].append(normalize(out["target_image"]))
            streams["source_original"].append(normalize(out["source_image"]))
            if self.naive_blend:
                streams["naive"].append(normalize(out["combined"]))
        return {k: np.stack(v) for k, v in streams.items() if v}

    def __getitem__(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        return self.get_item(index, rng or np.random.default_rng(index))

    def get_item(self, index: int, rng: np.random.Generator):
        if self.alignment:
            return self.get_item_alignment(index, rng)
        if self.cross_identity or self.source_videos is not None:
            return self.get_item_cross_identity(index, rng)
        return self.get_item_jitter(index, rng)


def pack_batch(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-clip items into (B, T, H, W, C) arrays with the 6-channel
    model input (source || background); other streams pass through
    stacked."""
    source = np.stack([it["source"] for it in items])
    background = np.stack([it["background"] for it in items])
    gt = np.stack([it["gt"] for it in items])
    batch = {
        "input": np.concatenate([source, background], axis=-1),
        "gt": gt,
    }
    for key in items[0]:
        if key not in ("source", "background", "gt"):
            batch[key] = np.stack([it[key] for it in items])
    return batch
