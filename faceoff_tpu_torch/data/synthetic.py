"""Synthetic faces: 68-point landmarks and cartoon frames drawn from them.

`face_landmarks` is a copy of `faceoff_tpu.data.synthetic.face_landmarks`
(pure numpy). `draw_face` paints a face consistent with the landmarks by
rasterising convex hulls with the port's `ops.warp.convex_mask`, so no
image library is needed. `synthetic_corpus` makes a whole corpus of
moving faces in memory; `generate_dataset` writes the same videos to disk
in the dataset contract (`data/dataset.py`), as PNG. `textured_background`
is the JAX package's background generator.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from faceoff_tpu_torch.data import geometry
from faceoff_tpu_torch.io.image import write_png
from faceoff_tpu_torch.ops.warp import convex_mask


def face_landmarks(
    center: Tuple[float, float], scale: float, angle_deg: float = 0.0
) -> np.ndarray:
    """Synthesize a plausible 68-point iBUG landmark set.

    Groups: 0-16 jaw, 17-26 brows, 27-35 nose, 36-41 / 42-47 eyes,
    48-67 mouth.
    """
    cx, cy = center
    s = scale
    pts = np.zeros((68, 2), np.float32)

    t = np.linspace(np.pi * 0.15, np.pi * 0.85, 17)
    pts[0:17, 0] = -np.cos(t) * s
    pts[0:17, 1] = np.sin(t) * s * 1.1

    bx = np.linspace(-0.6, -0.1, 5)
    pts[17:22, 0] = bx * s
    pts[17:22, 1] = (-0.45 - 0.08 * np.sin(np.linspace(0, np.pi, 5))) * s
    pts[22:27, 0] = -bx[::-1] * s
    pts[22:27, 1] = pts[17:22, 1][::-1]

    pts[27:31, 0] = 0
    pts[27:31, 1] = np.linspace(-0.35, 0.1, 4) * s
    pts[31:36, 0] = np.linspace(-0.15, 0.15, 5) * s
    pts[31:36, 1] = 0.18 * s

    for base, ex in ((36, -0.35), (42, 0.35)):
        et = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        pts[base: base + 6, 0] = (ex + 0.12 * np.cos(et)) * s
        pts[base: base + 6, 1] = (-0.25 + 0.07 * np.sin(et)) * s

    mt = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    pts[48:68, 0] = 0.25 * np.cos(mt) * s
    pts[48:68, 1] = (0.55 + 0.12 * np.sin(mt)) * s

    a = np.radians(angle_deg)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]], np.float32)
    pts = pts @ R.T
    pts[:, 0] += cx
    pts[:, 1] += cy
    return pts


def draw_faces(
    imgs: torch.Tensor, lms: torch.Tensor, skin: Tuple[int, int, int]
) -> torch.Tensor:
    """Copies of imgs (N, H, W, 3) uint8 with cartoon faces painted over
    them from lms (N, 68, 2): the skin hull of all 68 points, white eye
    hulls and a dark mouth hull, each rasterised with `convex_mask`."""
    h, w = imgs.shape[1:3]
    lms = torch.as_tensor(lms, dtype=torch.float32, device=imgs.device)
    out = imgs.clone()
    for pts, color in (
        (lms, skin),
        (lms[:, 36:42], (250, 250, 250)),
        (lms[:, 42:48], (250, 250, 250)),
        (lms[:, 48:68], (120, 40, 50)),
    ):
        mask = convex_mask(pts, h, w, n_directions=64).bool()
        out[mask] = torch.tensor(color, dtype=imgs.dtype, device=imgs.device)
    return out


def draw_face(
    img: torch.Tensor, lms: torch.Tensor, skin: Tuple[int, int, int]
) -> torch.Tensor:
    """`draw_faces` for one image (H, W, 3) and its landmarks (68, 2)."""
    lms = torch.as_tensor(lms, dtype=torch.float32, device=img.device)
    return draw_faces(img[None], lms[None], skin)[0]


def _skin(v: int) -> Tuple[int, int, int]:
    """The skin tone of video v, as the JAX package's generate_dataset."""
    return (180 + 15 * (v % 4), 150 + 10 * ((v + 1) % 5),
            120 + 12 * ((v + 2) % 6))


def video_frames(
    n_frames: int, size: int = 256, *, seed: int = 0,
    skin: Tuple[int, int, int] = (210, 170, 140),
    device: torch.device = torch.device("cpu"),
) -> Tuple[torch.Tensor, np.ndarray]:
    """One synthetic video: a cartoon face drifting and turning over a
    textured background, made from `seed`. Returns (frames (F, S, S, 3)
    uint8 on `device`, landmarks (F, 68, 2) float32)."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 255, (1, 3, max(size // 8, 1),
                                  max(size // 8, 1))).astype(np.float32)
    bg = F.interpolate(torch.from_numpy(noise).to(device), size=(size, size),
                       mode="bicubic", align_corners=False)
    bg = bg.clamp(0, 255).round().to(torch.uint8)[0].permute(1, 2, 0)
    cx0 = size / 2 + rng.uniform(-20, 20) * size / 256
    cy0 = size / 2 + rng.uniform(-20, 20) * size / 256
    scale = size * rng.uniform(0.22, 0.3)
    phase = rng.uniform(0, 2 * np.pi)
    lms = np.zeros((n_frames, 68, 2), np.float32)
    for f in range(n_frames):
        cx = cx0 + 10 * size / 256 * np.sin(0.2 * f + phase)
        cy = cy0 + 6 * size / 256 * np.cos(0.15 * f + phase)
        ang = 5 * np.sin(0.1 * f + phase)
        lms[f] = face_landmarks((cx, cy), scale, ang)
    frames = draw_faces(bg.expand(n_frames, -1, -1, -1),
                        torch.from_numpy(lms).to(device), skin)
    return frames, lms


def textured_background(rng: np.random.Generator, size: int) -> np.ndarray:
    """A (size, size, 3) uint8 background: uniform noise of (size // 8)^2
    pixels drawn from `rng` in HWC order, as the JAX package draws it,
    upscaled with cv2's INTER_CUBIC semantics (`geometry.resize`: equal
    to cv2's but for rare values one level apart, where a sum lands on
    the other side of a half).
    `video_frames` draws its own noise in CHW order and is unaffected."""
    noise = rng.integers(0, 255, (size // 8, size // 8, 3), np.uint8)
    return geometry.resize(noise, (size, size), interpolation="cubic")


def synthetic_corpus(
    n_videos: int, n_frames: int, size: int = 256, *, seed: int = 0,
    device: torch.device = torch.device("cpu"),
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """A corpus of `n_videos` videos of `n_frames` frames at size x size
    (`video_frames` with the seed and skin tone of each video, as the JAX
    package's `generate_dataset` picks them). Returns (frames
    (V, F, S, S, 3) uint8 on `device`, landmarks (V, F, 68, 2) float32,
    n_frames (V,) int64). `generate_dataset` writes the same frames to
    disk."""
    frames = torch.empty((n_videos, n_frames, size, size, 3),
                         dtype=torch.uint8, device=device)
    lms_all = np.zeros((n_videos, n_frames, 68, 2), np.float32)
    for v in range(n_videos):
        frames[v], lms_all[v] = video_frames(
            n_frames, size, seed=seed * 1000 + v, skin=_skin(v),
            device=device)
    return frames, lms_all, np.full((n_videos,), n_frames, np.int64)


def generate_video(
    out_dir: str, n_frames: int, *, size: int = 256, seed: int = 0,
    skin: Tuple[int, int, int] = (210, 170, 140),
    device: torch.device = torch.device("cpu"),
) -> None:
    """Write one `video_frames` video (drawn on `device`) in the dataset
    contract: `{f:05d}.png` frames beside `{f:05d}_landmarks.npz` (key
    'landmark', (68, 2) float32). The JAX generator writes JPEG through
    cv2; the port has no JPEG encoder, so it writes PNG."""
    os.makedirs(out_dir, exist_ok=True)
    frames, lms = video_frames(n_frames, size, seed=seed, skin=skin,
                               device=device)
    frames = frames.cpu().numpy()
    for f in range(n_frames):
        write_png(osp.join(out_dir, f"{f:05d}.png"), frames[f])
        np.savez(osp.join(out_dir, f"{f:05d}_landmarks.npz"), landmark=lms[f])


def generate_dataset(
    root: str, n_videos: int = 2, n_frames: int = 12, size: int = 256,
    seed: int = 0, *, device: torch.device = torch.device("cpu"),
) -> str:
    """Write a synthetic dataset of `n_videos` directories `video_{v:03d}`
    (the frames of `synthetic_corpus` with the same arguments, drawn on
    `device`); returns `root`."""
    for v in range(n_videos):
        generate_video(osp.join(root, f"video_{v:03d}"), n_frames, size=size,
                       seed=seed * 1000 + v, skin=_skin(v), device=device)
    return root
