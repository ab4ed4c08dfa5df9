"""Face detection and 68-point landmarks for offline preprocessing,
counterpart of `faceoff_tpu/preprocess/detectors.py` without OpenCV.

The two protocols are the JAX package's:

  FaceDetector.detect(frame) -> (x1, y1, x2, y2) | None
  Landmarker.landmarks(frames) -> list[(68, 2) array | None]

What the port computes is what the JAX package computes on a machine
without mediapipe and face_alignment and with OpenCV 5 (no Haar runtime):
`default_detector()` is `HeuristicDetector` and `default_landmarker()` is
`FlowTrackingLandmarker`, seeded by `ImageEvidenceLandmarker`'s valley
path. The learned and Haar backends (`MediapipeDetector`, `YunetDetector`,
`CascadeDetector`, the Haar eye and smile finders,
`FaceAlignmentLandmarker`) need packages, cv2's runtime, data files or an
ONNX model that the repository does not hold; they are not ported
(ROADMAP.md, Queue 1 item 7b).

The image work runs in torch on the frames' device: the colour
conversions and morphology of `preprocess/imgproc.py`, connected
components through `ops/ccl_cuda.py` (kernel A on CUDA) and the pyramidal
Lucas-Kanade tracker through `ops/lk_cuda.py` (kernel B on CUDA). The
small per-frame decisions (percentiles, centroids, the similarity fit)
run in numpy on the host, as in the JAX package. Frames are uint8 RGB
(H, W, 3): numpy arrays (moved to the detector's device) or tensors
(used where they lie).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from faceoff_tpu_torch.data.geometry import umeyama_similarity
from faceoff_tpu_torch.data.synthetic import face_landmarks
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.ops import ccl_cuda, lk_cuda
from faceoff_tpu_torch.preprocess import imgproc

Box = Tuple[int, int, int, int]
Frame = Union[np.ndarray, torch.Tensor]

# the classic skin cluster in YCrCb (detectors.py:53)
SKIN_LO, SKIN_HI = (0, 133, 77), (255, 180, 135)
# frames a detection launch takes at 1280 x 720 (about 1 GB of temporaries)
DETECT_BATCH = 16
# frames whose LK pyramids the tracker builds at once (about 0.7 MB each at
# 256 px)
PYRAMID_BATCH = 64


def _frames_tensor(frames, device: torch.device) -> torch.Tensor:
    """A sequence of (H, W, 3) uint8 frames as one (N, H, W, 3) tensor on
    `device` (a tensor keeps its own device)."""
    if isinstance(frames, torch.Tensor):
        return frames
    return torch.from_numpy(np.stack([np.asarray(f) for f in frames])).to(
        device)


def skin_mask(frames: torch.Tensor) -> torch.Tensor:
    """255 where (N, H, W, 3) RGB frames fall in the skin cluster."""
    return imgproc.in_range(imgproc.rgb_to_ycrcb(frames), SKIN_LO, SKIN_HI)


class HeuristicDetector:
    """Skin-prior face detector: YCrCb skin mask, closed with a 7 x 7
    square, then the largest 8-connected blob's box; None when there is
    no blob or it covers less than `min_area_frac` of the frame.

    `detect_batch` detects a stack of frames in launches of at most
    DETECT_BATCH frames of one size (device memory stays bounded whatever
    the stack's length) and gives the same boxes as `detect` frame by
    frame. Numpy frames go to `device` (CUDA unless named)."""

    def __init__(self, min_area_frac: float = 0.005, *,
                 device: DeviceLike = None):
        self.min_area_frac = min_area_frac
        self.device = resolve_device(device)

    def detect(self, frame_rgb: Frame) -> Optional[Box]:
        return self.detect_batch(
            frame_rgb[None] if isinstance(frame_rgb, torch.Tensor)
            else [frame_rgb])[0]

    def detect_batch(self, frames: Union[torch.Tensor, Sequence[Frame]]
                     ) -> List[Optional[Box]]:
        out: List[Optional[Box]] = []
        lo, n = 0, len(frames)
        while lo < n:
            hi = min(n, lo + DETECT_BATCH)
            # a launch takes frames of one size
            while hi > lo + 1 and frames[hi - 1].shape != frames[lo].shape:
                hi -= 1
            out += self._detect_chunk(
                _frames_tensor(frames[lo:hi], self.device))
            lo = hi
        return out

    def _detect_chunk(self, frames: torch.Tensor) -> List[Optional[Box]]:
        n, h, w = frames.shape[:3]
        mask = imgproc.morph_close(skin_mask(frames), 7)
        comps = ccl_cuda.connected_components(mask)
        if comps.stats.shape[0] == 0:
            return [None] * n
        best = ccl_cuda.largest(comps, n)
        stats = comps.stats[best.clamp(min=0)]
        rows = torch.cat([best[:, None], stats], 1).cpu().tolist()
        boxes: List[Optional[Box]] = []
        for row, x, y, bw, bh, area in rows:
            if row < 0 or area < self.min_area_frac * h * w:
                boxes.append(None)
            else:
                boxes.append((int(x), int(y), int(x + bw), int(y + bh)))
        return boxes


def default_detector(device: DeviceLike = None) -> HeuristicDetector:
    """The detector the JAX package picks without mediapipe."""
    return HeuristicDetector(device=device)


def _box_layout(box: Box) -> np.ndarray:
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    scale = max(x2 - x1, y2 - y1) / 2.2
    return face_landmarks((cx, cy), scale)


class BoxLandmarker:
    """68 landmarks synthesized from the detected face box in the
    canonical iBUG layout (jaw 0-16, brows 17-26, nose 27-35, eyes 36-47,
    mouth 48-67)."""

    def __init__(self, detector=None):
        self.detector = detector or default_detector()

    def landmarks(self, frames_rgb) -> List[Optional[np.ndarray]]:
        return [None if b is None else _box_layout(b)
                for b in self.detector.detect_batch(frames_rgb)]


class ImageEvidenceLandmarker:
    """The box layout similarity-warped onto three anchors found in the
    image: the eye centres (dark blobs of the upper face next to skin,
    the valley path of the JAX package, which is what it takes without a
    Haar runtime) and the mouth (the darkest row band below the eyes).
    Falls back to the box layout where the evidence is missing or
    implausible."""

    def __init__(self, detector=None):
        self.detector = detector or default_detector()
        canon = face_landmarks((0.0, 0.0), 1.0)
        self._canon = canon
        self._canon_anchors = np.stack([
            canon[36:42].mean(axis=0),   # left eye centre
            canon[42:48].mean(axis=0),   # right eye centre
            canon[48:68].mean(axis=0),   # mouth centre
        ]).astype(np.float32)

    # -- anchor finders ---------------------------------------------------

    @staticmethod
    def _find_eyes_valley(gray_roi: torch.Tensor, skin_roi: torch.Tensor):
        """Dark-blob eye centres in ROI coordinates: in each horizontal
        half of the upper face band, the centroid of the darkest 5 % of
        the skin-adjacent pixels (blurred at sigma 2)."""
        h, w = gray_roi.shape
        y0, y1 = int(h * 0.18), int(h * 0.55)
        x0, x1 = int(w * 0.12), int(w * 0.88)
        band = gray_roi[y0:y1, x0:x1]
        if band.shape[0] < 6 or band.shape[1] < 12:
            return None
        r = max(int(min(h, w) * 0.06), 3)
        near_skin = imgproc.dilate(skin_roi, 2 * r + 1)[y0:y1, x0:x1] > 0
        sm = imgproc.gaussian_blur(band.to(torch.float32), 2.0)
        sm = torch.where(near_skin, sm, torch.full_like(sm, np.inf))
        sm = sm.cpu().numpy()
        mid = sm.shape[1] // 2

        def centroid(half, ox):
            finite = half[np.isfinite(half)]
            if finite.size < 10:
                return None
            thr = np.percentile(finite, 5.0)
            ys, xs = np.nonzero(half <= thr)
            if len(ys) == 0:
                return None
            return np.array(
                [x0 + ox + xs.mean(), y0 + ys.mean()], np.float32)

        le = centroid(sm[:, :mid], 0)
        re_ = centroid(sm[:, mid:], mid)
        if le is None or re_ is None:
            return None
        if abs(le[1] - re_[1]) > 0.18 * h:
            return None
        return le, re_

    @staticmethod
    def _find_mouth(gray_roi: torch.Tensor, eye_y: float,
                    skin_roi: torch.Tensor):
        """Mouth centre in ROI coordinates: the darkest row (5-row moving
        mean) of the central columns below the eye line, pixels away from
        the skin counted as the ROI's brightest."""
        h, w = gray_roi.shape
        r = max(int(min(h, w) * 0.06), 3)
        near = (imgproc.dilate(skin_roi, 2 * r + 1) > 0).cpu().numpy()
        gray = gray_roi.cpu().numpy()
        gray = np.where(near, gray, gray.max()).astype(gray.dtype)
        y0 = int(min(max(eye_y + 0.15 * h, h * 0.45), h - 2))
        band = gray[y0:]
        cols = band[:, int(w * 0.3): int(w * 0.7)]
        if cols.size == 0:
            return None
        rows = cols.mean(axis=1)
        if rows.shape[0] >= 5:
            k = np.ones(5, np.float32) / 5.0
            rows = np.convolve(rows, k, mode="same")
        my = int(np.argmin(rows))
        return np.array([w / 2.0, y0 + my], np.float32)

    def _seed_one(self, frame: torch.Tensor, box: Optional[Box]
                  ) -> Optional[np.ndarray]:
        if box is None:
            return None
        x1, y1, x2, y2 = box
        x1, y1 = max(x1, 0), max(y1, 0)
        bw, bh = x2 - x1, y2 - y1
        gray = imgproc.rgb_to_gray(frame)
        roi = gray[y1:y2, x1:x2]
        if roi.numel() == 0 or bw < 8 or bh < 8:
            return _box_layout(box)
        skin = skin_mask(frame)[y1:y2, x1:x2].contiguous()
        # keep only the largest skin component
        comps = ccl_cuda.connected_components(skin[None])
        best = int(ccl_cuda.largest(comps, 1)[0])
        if best >= 0:
            keep = ccl_cuda.component_mask(comps, 0, best)
            skin = torch.where(keep, skin, torch.zeros_like(skin))

        eyes = self._find_eyes_valley(roi, skin)
        anchors = None
        if eyes is not None:
            le, re_ = eyes
            dist = float(np.linalg.norm(re_ - le))
            if 0.2 * bw <= dist <= 0.75 * bw:
                eye_y = float((le[1] + re_[1]) / 2.0)
                mouth = self._find_mouth(roi, eye_y, skin)
                if mouth is not None and mouth[1] > eye_y + 0.1 * bh:
                    off = np.array([x1, y1], np.float32)
                    anchors = np.stack([le, re_, mouth]) + off
        if anchors is None:
            return _box_layout(box)
        M = umeyama_similarity(self._canon_anchors,
                               anchors.astype(np.float32))
        pts = self._canon @ M[:, :2].T + M[:, 2]
        return pts.astype(np.float32)

    def landmarks(self, frames_rgb) -> List[Optional[np.ndarray]]:
        boxes = self.detector.detect_batch(frames_rgb)
        dev = self.detector.device
        return [self._seed_one(f if isinstance(f, torch.Tensor) else
                               torch.from_numpy(np.asarray(f)).to(dev), b)
                for f, b in zip(frames_rgb, boxes)]


class FlowTrackingLandmarker:
    """Landmarks detected once (the image-evidence seed), then tracked
    frame to frame with pyramidal Lucas-Kanade and a forward-backward
    check, re-detected on track loss or drift.

    Per frame: track all 68 points forward, track the results backward,
    keep points whose round trip lands within `fb_thresh` px. Lost points
    are re-anchored by the similarity transform fitted on the surviving
    points. When fewer than `min_valid_frac` survive, or the tracked
    centre drifts more than half a box size from the detector's box, the
    layout re-detects from scratch.

    Each frame pair is one `lk_cuda.pyr_lk` call (one kernel launch on
    CUDA) over pyramids built once per frame, PYRAMID_BATCH frames at a
    time; the drift check takes its
    boxes from one `detect_batch` over the clip (detection is a pure
    function of the frame, so the boxes are those the JAX package gets
    frame by frame)."""

    # the landmark stage feeds trackers whole clips (no chunk resets)
    tracks_across_frames = True

    def __init__(self, detector=None, *, seed_landmarker=None,
                 fb_thresh: float = 1.5, min_valid_frac: float = 0.6,
                 win_size: int = 21, max_level: int = 3):
        self.detector = detector or default_detector()
        if seed_landmarker is None:
            seed_landmarker = ImageEvidenceLandmarker(self.detector)
        self._base = seed_landmarker
        self.fb_thresh = fb_thresh
        self.min_valid_frac = min_valid_frac
        self.win_size = win_size
        self.max_level = max_level

    def _track(self, prev_pyr, pyr, prev_pts: np.ndarray):
        """One forward-backward LK step: (points (68, 2) float32, valid
        (68,) bool)."""
        p0 = torch.from_numpy(np.ascontiguousarray(prev_pts, np.float32))
        tr = lk_cuda.pyr_lk(prev_pyr, pyr, p0.to(prev_pyr.img.device))
        p1 = tr.fwd.cpu().numpy()
        st, st_back = tr.st_fwd.cpu().numpy(), tr.st_back.cpu().numpy()
        fb = np.linalg.norm(tr.back.cpu().numpy() - prev_pts.astype(
            np.float32), axis=1)
        valid = st & st_back & (fb < self.fb_thresh)
        return p1.astype(np.float32), valid

    @staticmethod
    def _fill_lost(prev_pts, pts, valid):
        """Re-anchor lost points with the similarity transform fitted on
        the surviving ones."""
        if valid.all():
            return pts
        if valid.sum() >= 3:
            M = umeyama_similarity(prev_pts[valid], pts[valid])
            moved = prev_pts[~valid] @ M[:, :2].T + M[:, 2]
            pts = pts.copy()
            pts[~valid] = moved.astype(np.float32)
        else:
            pts = pts.copy()
            pts[~valid] = prev_pts[~valid]
        return pts

    @staticmethod
    def _drifted(pts, box: Optional[Box]) -> bool:
        """Tracked centre against the detector's box centre."""
        if box is None:
            return False  # no detection to anchor against: trust the track
        x1, y1, x2, y2 = box
        cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        half = max(x2 - x1, y2 - y1) / 2.0
        center = pts.mean(axis=0)
        return bool(
            np.hypot(center[0] - cx, center[1] - cy) > max(half, 1.0))

    def landmarks(self, frames_rgb) -> List[Optional[np.ndarray]]:
        frames = _frames_tensor(frames_rgb, self.detector.device)
        if len(frames) == 0:
            return []
        boxes = self.detector.detect_batch(frames)
        grays = imgproc.rgb_to_gray(frames)
        out: List[Optional[np.ndarray]] = []
        prev_pyr = None
        prev_pts: Optional[np.ndarray] = None
        for i in range(len(frames)):
            if i % PYRAMID_BATCH == 0:
                pyramids = lk_cuda.build_pyramids(
                    grays[i: i + PYRAMID_BATCH], self.win_size,
                    self.max_level)
            pyr = pyramids[i % PYRAMID_BATCH]
            pts: Optional[np.ndarray] = None
            if prev_pts is not None:
                cand, valid = self._track(prev_pyr, pyr, prev_pts)
                if (valid.mean() >= self.min_valid_frac
                        and not self._drifted(cand, boxes[i])):
                    pts = self._fill_lost(prev_pts, cand, valid)
            if pts is None:  # first frame, track loss or drift: re-detect
                pts = self._base.landmarks(frames[i: i + 1])[0]
            out.append(pts)
            prev_pyr = pyr
            prev_pts = pts
        return out


def default_landmarker(device: DeviceLike = None) -> FlowTrackingLandmarker:
    """The landmarker the JAX package picks without face_alignment."""
    return FlowTrackingLandmarker(default_detector(device))
