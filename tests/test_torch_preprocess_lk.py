"""Offline preprocessing of the port against cv2 and the JAX package, on
the CPU, continued from `tests/test_torch_preprocess.py`: pyramidal
Lucas-Kanade (plain version of kernel B) against cv2 and the
flow-tracking landmarker against the JAX package. Inputs are made with
numpy from a seed, or drawn as the JAX package's preprocessing tests
draw them (`tests/test_preprocess.py`)."""

import cv2
import numpy as np
import pytest
import torch

from faceoff_tpu.data import synthetic as jsyn
from faceoff_tpu.data.geometry import umeyama_similarity
from faceoff_tpu.preprocess import detectors as jdet
from faceoff_tpu_torch.ops import lk_cuda
from faceoff_tpu_torch.preprocess import detectors as tdet

CPU = "cpu"
SKIN = (200, 160, 140)
LK = dict(winSize=(21, 21), maxLevel=3,
          criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30,
                    0.01))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _face_frame(size, center, scale, skin=SKIN, bg=40):
    img = np.full((size, size, 3), bg, np.uint8)
    lms = jsyn.face_landmarks(center, scale)
    jsyn.draw_face(img, lms, skin)
    return img, lms


def _mouth_opening_frames(n_frames=12, size=160):
    """The JAX test's clip: the lower half of the mouth ring opens
    downward while the head stays put."""
    frames = []
    for f in range(n_frames):
        img = np.full((size, size, 3), 40, np.uint8)
        lms = jsyn.face_landmarks((size / 2, size / 2), size * 0.25)
        mouth = lms[48:68]
        lower = mouth[:, 1] > mouth[:, 1].mean()
        mouth[lower, 1] += 1.2 * f
        jsyn.draw_face(img, lms, (200, 160, 140))
        frames.append(img)
    return frames


# -- (f) pyramidal Lucas-Kanade ---------------------------------------------


def _lk_against_cv2(a, b, pts):
    """(share of points whose two statuses equal cv2's, max |fwd - cv2|
    over points both track, max |back - cv2| over points both track both
    ways)."""
    p1, st1, _ = cv2.calcOpticalFlowPyrLK(a, b, pts.reshape(-1, 1, 2), None,
                                          **LK)
    p0b, st2, _ = cv2.calcOpticalFlowPyrLK(b, a, p1, None, **LK)
    tr = lk_cuda.pyr_lk_plain(lk_cuda.build_pyramid(_t(a)),
                              lk_cuda.build_pyramid(_t(b)), _t(pts))
    s1, s2 = st1.ravel() == 1, st2.ravel() == 1
    same = (tr.st_fwd.numpy() == s1) & (tr.st_back.numpy() == s2)
    both = s1 & tr.st_fwd.numpy()
    fwd = np.abs(tr.fwd.numpy() - p1.reshape(-1, 2))[both]
    both2 = both & s2 & tr.st_back.numpy()
    back = np.abs(tr.back.numpy() - p0b.reshape(-1, 2))[both2]
    # the round trip's length: float32, within an ulp of numpy's norm
    np.testing.assert_allclose(
        tr.fb.numpy(), np.linalg.norm(tr.back.numpy() - pts, axis=1),
        rtol=1e-6, atol=0)
    return same.mean(), fwd.max(initial=0), back.max(initial=0)


@pytest.mark.parametrize("shift", [(0.37, -1.62), (2.91, 1.08),
                                   (-0.5, 0.25)])
def test_pyr_lk_plain_against_cv2_on_shifted_texture(shift):
    """pyr_lk_plain against cv2.calcOpticalFlowPyrLK (winSize 21,
    maxLevel 3, 30 / 0.01) on a textured 256x256 frame and its sub-pixel
    shift, 160 points (some near and beyond the borders): equal statuses
    on >= 99 % of points and <= 0.02 px on points both track, forward and
    back (cv2 sums its 2x2 system in float32 in another order than the
    exact integer sums here; 1e-3 px measured)."""
    rng = np.random.default_rng(int(abs(shift[0]) * 100))
    base = rng.integers(0, 256, (34, 34)).astype(np.float32)
    a = cv2.resize(base, (256, 256), interpolation=cv2.INTER_CUBIC)
    a = np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.uint8)
    m = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    b = cv2.warpAffine(a, m, (256, 256), flags=cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REFLECT_101)
    pts = rng.uniform(-15, 270, (160, 2)).astype(np.float32)
    same, fwd, back = _lk_against_cv2(a, b, pts)
    assert same >= 0.99 and fwd <= 0.02 and back <= 0.02, (same, fwd, back)


def test_pyr_lk_plain_against_cv2_on_the_mouth_clip():
    """The same on the mouth-opening clip, frame pair by frame pair, at
    the 68 drawn landmarks (most lie on flat colour: statuses and the
    points cv2 keeps)."""
    frames = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY)
              for f in _mouth_opening_frames()]
    pts = jsyn.face_landmarks((80, 80), 40).astype(np.float32)
    for a, b in zip(frames, frames[1:]):
        same, fwd, back = _lk_against_cv2(a, b, pts)
        assert same >= 0.99 and fwd <= 0.02 and back <= 0.02, (
            same, fwd, back)


# -- (g) the flow-tracking landmarker ----------------------------------------


def _rigid_residual(a, b):
    m = umeyama_similarity(a, b)
    return float(np.linalg.norm(a @ m[:, :2].T + m[:, 2] - b, axis=1).mean())


def test_flow_tracker_against_jax_on_the_mouth_clip():
    """FlowTrackingLandmarker against the JAX one on the mouth-opening
    clip: every frame within 0.05 px (the LK tolerance above, carried
    through the forward-backward check and the similarity fill; 0.0025
    measured)."""
    frames = _mouth_opening_frames()
    got = tdet.FlowTrackingLandmarker(
        tdet.HeuristicDetector(device=CPU)).landmarks(frames)
    want = jdet.FlowTrackingLandmarker(jdet.HeuristicDetector()).landmarks(
        frames)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=0.05)


def test_flow_tracker_behaviour_as_the_jax_tests():
    """The JAX file's three behaviour tests on the port: the tracked
    layout deforms where the box layout does not, the mouth moves down
    while the eyes stay, and a static clip stays put; the tracker seeds
    from the image evidence."""
    frames = _mouth_opening_frames()
    det = tdet.HeuristicDetector(device=CPU)
    tracker = tdet.FlowTrackingLandmarker(det)
    assert isinstance(tracker._base, tdet.ImageEvidenceLandmarker)
    tracked = tracker.landmarks(frames)
    boxed = tdet.BoxLandmarker(det).landmarks(frames)
    assert all(p is not None for p in tracked + boxed)
    assert _rigid_residual(boxed[0], boxed[-1]) < 0.3
    assert _rigid_residual(tracked[0], tracked[-1]) > 1.5
    mouth_dy = tracked[-1][48:68, 1].max() - tracked[0][48:68, 1].max()
    eye_dy = abs(tracked[-1][36:48, 1].mean() - tracked[0][36:48, 1].mean())
    assert mouth_dy > 3.0 and eye_dy < 3.0

    img, _ = _face_frame(160, (80, 80), 40)
    still = tracker.landmarks([img.copy() for _ in range(6)])
    assert np.linalg.norm(still[-1] - still[0], axis=1).max() < 1.0
