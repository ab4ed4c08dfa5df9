"""The host perturbation engine of the self-supervised items, counterpart
of `faceoff_tpu/data/perturbations.py` without OpenCV.

Translations, a rotation about the eye centre, a zoom, and one of three
radial distortions (arc, barrel, inverse barrel) of the segmented face; at
least one is applied. Every draw comes from the caller's numpy Generator
in the JAX package's order, so one seed picks the same perturbations and
amounts in both packages. The resampling is `data/geometry.py`'s, which
follows cv2's arithmetic: integer translations are exact shifts, the other
operations agree with cv2 to a level where a float32 rounding differs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from faceoff_tpu_torch.data import geometry

TRANSLATION_RANGE = 3  # pixels
ROTATION_RANGE = 3.0  # degrees
SCALE_RANGE = (90, 110)  # percent
DISTORTIONS = ("arc", "barrel", "barrel_inverse")


def translate(image: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Shift by (dx, dy) pixels, zeros entering."""
    m = np.float32([[1, 0, dx], [0, 1, dy]])
    return geometry.warp_affine(image, m)


def rotate(
    image: np.ndarray, angle_deg: float,
    center: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """Rotate by angle_deg about `center` (the image centre by default)."""
    h, w = image.shape[:2]
    if center is None:
        center = (w // 2, h // 2)
    return geometry.warp_affine(
        image, geometry.rotation_matrix(center, angle_deg, 1.0))


def rescale(image: np.ndarray, magnification: float) -> np.ndarray:
    """Zoom about the centre by `magnification` (bicubic), keeping the
    canvas size: a zoom in is cropped, a zoom out padded with zeros."""
    h, w = image.shape[:2]
    res = geometry.resize(image, fx=magnification, fy=magnification,
                          interpolation="cubic")
    if magnification >= 1:
        cy, cx = res.shape[0] // 2, res.shape[1] // 2
        top, left = cy - h // 2, cx - w // 2
        return res[top: top + h, left: left + w]
    out = np.zeros_like(image)
    hs, ws = res.shape[:2]
    top, left = (h - hs) // 2, (w - ws) // 2
    out[top: top + hs, left: left + ws] = res
    return out


def _radial_remap(image: np.ndarray, src_r_of_dst_r) -> np.ndarray:
    """Remap the output's polar radius about the image centre to a source
    radius (radii normalised by half the smaller image side)."""
    h, w = image.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    norm = min(cx, cy)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dx, dy = (xs - cx) / norm, (ys - cy) / norm
    r = np.sqrt(dx * dx + dy * dy)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(r > 1e-8, src_r_of_dst_r(r) / np.maximum(r, 1e-8),
                         1.0)
    map_x = (cx + dx * scale * norm).astype(np.float32)
    map_y = (cy + dy * scale * norm).astype(np.float32)
    return geometry.remap(image, map_x, map_y)


def barrel_distort(
    image: np.ndarray, a: float, b: float, c: float, d: float = 1.0
) -> np.ndarray:
    """ImageMagick's 'barrel': r_src = r (a r^3 + b r^2 + c r + d)."""
    return _radial_remap(
        image, lambda r: r * (a * r ** 3 + b * r ** 2 + c * r + d))


def barrel_inverse_distort(
    image: np.ndarray, a: float, b: float, c: float, d: float = 1.0
) -> np.ndarray:
    """ImageMagick's 'barrel_inverse': r_src = r / (a r^3 + b r^2 + c r + d)."""
    return _radial_remap(
        image,
        lambda r: r / np.maximum(a * r ** 3 + b * r ** 2 + c * r + d, 1e-6))


def arc_distort(image: np.ndarray, angle_deg: float) -> np.ndarray:
    """Bend the image onto an annulus spanning `angle_deg` whose outer arc
    is as long as the image is wide (ImageMagick's 'arc'); small angles
    approach the identity."""
    angle = np.radians(max(float(angle_deg), 1e-3))
    h, w = image.shape[:2]
    r_outer = w / angle
    r_inner = max(r_outer - h, 0.0)
    cx = (w - 1) / 2.0
    # the circle's centre sits above the image so that the annulus fits
    cy_arc = r_outer

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dx = xs - cx
    dy = cy_arc - ys
    r = np.sqrt(dx * dx + dy * dy)
    theta = np.arctan2(dx, dy)  # 0 at the top, +/- angle/2 at the edges

    src_x = (theta / angle + 0.5) * (w - 1)
    denom = max(r_outer - r_inner, 1e-6)
    src_y = (r_outer - r) / denom * (h - 1)

    inside = (np.abs(theta) <= angle / 2) & (r >= r_inner) & (r <= r_outer)
    map_x = np.where(inside, src_x, -1).astype(np.float32)
    map_y = np.where(inside, src_y, -1).astype(np.float32)
    return geometry.remap(image, map_x, map_y)


def find_eye_center(landmarks: np.ndarray) -> Tuple[float, float]:
    """The midpoint of the two eye centroids (points 36:41 and 42:47)."""
    left = landmarks[36:41].mean(axis=0)
    right = landmarks[42:47].mean(axis=0)
    return (float((left[0] + right[0]) / 2.0),
            float((left[1] + right[1]) / 2.0))


def random_distort(image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One of the three radial distortions with the reference's parameter
    ranges."""
    kind = DISTORTIONS[rng.integers(0, len(DISTORTIONS))]
    if kind == "arc":
        return arc_distort(image, float(rng.integers(0, 31)))
    if kind == "barrel":
        a = rng.integers(0, 11) / 10
        b = rng.integers(2, 8) / 10
        c = rng.integers(0, 6) / 10
        return barrel_distort(image, a, b, c, 1.0)
    b = rng.integers(0, 3) / 10
    c = rng.integers(-5, 1) / 10
    return barrel_inverse_distort(image, 0.0, b, c, 1.0)


def perturb_image_composite(
    face_image: np.ndarray,
    landmarks: np.ndarray,
    rng: np.random.Generator,
    *,
    translation_range: int = TRANSLATION_RANGE,
    rotation_range: float = ROTATION_RANGE,
    scale_range: Tuple[int, int] = SCALE_RANGE,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Apply a random non-empty subset of the perturbations, in the order
    tx, ty, rot, scale, distort, to a segmented face; the rotation pivots
    on the eye centre. Returns (image, the ground-truth amounts
    translate_horizontal / translate_vertical / rotate_image)."""
    eye_center = find_eye_center(landmarks)
    gt = {"translate_horizontal": 0.0, "translate_vertical": 0.0,
          "rotate_image": 0.0}

    names = ["tx", "ty", "rot", "scale", "distort"]
    chosen = []
    while not chosen:
        chosen = [n for n in names if rng.integers(0, 2)]

    out = face_image
    for n in chosen:
        if n == "tx":
            v = float(rng.integers(-translation_range, translation_range + 1))
            gt["translate_horizontal"] = v
            out = translate(out, v, 0)
        elif n == "ty":
            v = float(rng.integers(-translation_range, translation_range + 1))
            gt["translate_vertical"] = v
            out = translate(out, 0, v)
        elif n == "rot":
            v = float(rng.integers(-int(rotation_range),
                                   int(rotation_range) + 1))
            gt["rotate_image"] = v
            out = rotate(out, v, center=eye_center)
        elif n == "scale":
            v = float(rng.integers(scale_range[0], scale_range[1] + 1)) / 100.0
            out = rescale(out, v)
        else:
            out = random_distort(out, rng)
    return out, gt
