"""Offline preprocessing of the port against cv2 and the JAX package, on
the CPU: the image operations, connected components (plain version of
kernel A), the skin detector, the crop track, the image-evidence seed,
both stages and the command line, and the motion-JPEG AVI container.
Pyramidal Lucas-Kanade (plain version of kernel B) and the flow-tracking
landmarker are in `tests/test_torch_preprocess_lk.py`. Inputs are made
with numpy from a seed, or drawn as the JAX package's preprocessing
tests draw them (`tests/test_preprocess.py`)."""

import glob
import os.path as osp

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from faceoff_tpu.data import dataset as jds
from faceoff_tpu.data import synthetic as jsyn
from faceoff_tpu.io import video as jvideo
from faceoff_tpu.preprocess import detectors as jdet
from faceoff_tpu.preprocess import face_crop as jcrop
from faceoff_tpu.preprocess import landmarks as jlms
from faceoff_tpu_torch.cli import preprocess as tcli
from faceoff_tpu_torch.data import dataset as tds
from faceoff_tpu_torch.io import mpeg4 as tmpeg4
from faceoff_tpu_torch.io import video as tvideo
from faceoff_tpu_torch.ops import ccl_cuda
from faceoff_tpu_torch.preprocess import detectors as tdet
from faceoff_tpu_torch.preprocess import face_crop as tcrop
from faceoff_tpu_torch.preprocess import imgproc
from faceoff_tpu_torch.preprocess import landmarks as tlms

CPU = "cpu"
SKIN = (200, 160, 140)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _face_frame(size, center, scale, skin=SKIN, bg=40):
    img = np.full((size, size, 3), bg, np.uint8)
    lms = jsyn.face_landmarks(center, scale)
    jsyn.draw_face(img, lms, skin)
    return img, lms


def _raw_frames(n_frames=40, size=160, cut=None):
    """The JAX test's raw footage (a drawn face drifting on a plain
    background); from frame `cut` on, the face jumps to the other side."""
    frames = []
    for f in range(n_frames):
        cx = size / 2 + 3 * np.sin(0.2 * f)
        if cut is not None and f >= cut:
            cx = size * 0.3
        frames.append(_face_frame(size, (cx, size / 2), size * 0.25)[0])
    return frames


# -- (a) the image operations ----------------------------------------------


def test_colour_conversions_bit_exact_on_every_colour():
    """rgb_to_ycrcb and rgb_to_gray equal cv2.cvtColor on all 2^24 RGB
    colours (one 4096 x 4096 image), and in_range equals cv2.inRange on
    the skin cluster bounds."""
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    ycc = imgproc.rgb_to_ycrcb(_t(img)).numpy()
    want = cv2.cvtColor(img, cv2.COLOR_RGB2YCrCb)
    np.testing.assert_array_equal(ycc, want)
    np.testing.assert_array_equal(imgproc.rgb_to_gray(_t(img)).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(
        imgproc.in_range(_t(want), tdet.SKIN_LO, tdet.SKIN_HI).numpy(),
        cv2.inRange(want, np.array(tdet.SKIN_LO), np.array(tdet.SKIN_HI)))


@pytest.mark.parametrize("h,w", [(37, 53), (64, 64), (5, 7), (2, 9),
                                 (180, 320)])
def test_integer_image_ops_bit_exact(h, w):
    """morph_close 7x7, dilate (9x9 and 13x13), pyr_down and the Scharr
    derivatives equal cv2 bit for bit, odd and even sizes."""
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = (rng.random((h, w)) < 0.3).astype(np.uint8) * 255
    np.testing.assert_array_equal(
        imgproc.morph_close(_t(mask), 7).numpy(),
        cv2.morphologyEx(mask, cv2.MORPH_CLOSE, np.ones((7, 7), np.uint8)))
    for k in (9, 13):
        np.testing.assert_array_equal(
            imgproc.dilate(_t(mask), k).numpy(),
            cv2.dilate(mask, np.ones((k, k), np.uint8)))
    np.testing.assert_array_equal(imgproc.pyr_down(_t(img)).numpy(),
                                  cv2.pyrDown(img))
    d = imgproc.scharr_deriv(_t(img)).numpy()
    np.testing.assert_array_equal(d[..., 0],
                                  cv2.Scharr(img, cv2.CV_16S, 1, 0))
    np.testing.assert_array_equal(d[..., 1],
                                  cv2.Scharr(img, cv2.CV_16S, 0, 1))


def test_gaussian_blur_within_float_tolerance():
    """gaussian_blur at sigma 2 against cv2.GaussianBlur(..., (0, 0), 2)
    on float32 images of 0..255: both sum 17 float32 taps a pass, in
    other orders; |diff| <= 1e-3 (about 20 float32 ulps at 255; 7.6e-5
    measured)."""
    rng = np.random.default_rng(3)
    for h, w in ((19, 23), (60, 90), (9, 200)):
        img = rng.integers(0, 256, (h, w)).astype(np.float32)
        got = imgproc.gaussian_blur(_t(img), 2.0).numpy()
        np.testing.assert_allclose(got, cv2.GaussianBlur(img, (0, 0), 2.0),
                                   rtol=0, atol=1e-3)


# -- (b) connected components --------------------------------------------


def _assert_components_equal_cv2(masks):
    comps = ccl_cuda.connected_components_plain(_t(np.stack(masks)))
    best = ccl_cuda.largest(comps, len(masks))
    for f, m in enumerate(masks):
        n, labels, stats, _ = cv2.connectedComponentsWithStats(m)
        assert int(comps.counts[f]) == n - 1
        np.testing.assert_array_equal(
            comps.stats[comps.frame == f].numpy(), stats[1:])
        if n > 1:
            want = int(np.argmax(stats[1:, cv2.CC_STAT_AREA])) + 1
            np.testing.assert_array_equal(
                ccl_cuda.component_mask(comps, f, int(best[f])).numpy(),
                labels == want)
        else:
            assert int(best[f]) == -1


def test_components_tie_follows_cv2_block_order():
    """Two equal-area blobs whose first pixels and first 2x2 blocks come
    in opposite raster orders: cv2 numbers them by the block, and the
    largest on a tie is the first in that order."""
    m = np.zeros((4, 20), np.uint8)
    m[1, 0:2] = 255  # first block (0, 0); first pixel in row 1
    m[0, 10:12] = 255  # first pixel in row 0; block (0, 5)
    comps = ccl_cuda.connected_components_plain(_t(m[None]))
    np.testing.assert_array_equal(comps.stats[:, 0].numpy(), [0, 10])
    _assert_components_equal_cv2([m, np.zeros((4, 20), np.uint8)])


def test_components_equal_cv2_on_dense_random_masks():
    """Areas, boxes and label order of every component equal cv2's on
    dense random 720x1280 masks (about 6,800 and 540 components) and on a
    small ragged one; the chosen component's pixels equal cv2's label."""
    rng = np.random.default_rng(1)
    masks = [(rng.random((720, 1280)) < p).astype(np.uint8) * 255
             for p in (0.45, 0.6)]
    _assert_components_equal_cv2(masks)
    _assert_components_equal_cv2(
        [(rng.random((13, 31)) < 0.5).astype(np.uint8) for _ in range(3)])


# -- (c) the skin detector ---------------------------------------------------


def test_heuristic_detector_equals_jax(monkeypatch):
    """HeuristicDetector.detect and detect_batch (in launches of 3
    frames) give the JAX detector's boxes exactly: drawn faces, a frame
    with no skin, noise with scattered skin-toned blobs."""
    monkeypatch.setattr(tdet, "DETECT_BATCH", 3)
    rng = np.random.default_rng(0)
    frames = _raw_frames(6, 160) + [np.full((90, 120, 3), 40, np.uint8)]
    frames += [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
               for _ in range(2)]
    img, _ = _face_frame(200, (70, 120), 40, skin=(210, 170, 140), bg=90)
    frames.append(img)
    ref = jdet.HeuristicDetector()
    det = tdet.HeuristicDetector(device=CPU)
    want = [ref.detect(f) for f in frames]
    assert [det.detect(f) for f in frames] == want
    same = [f for f in frames if f.shape == frames[0].shape]
    assert det.detect_batch(same) == want[: len(same)]
    assert det.detect_batch(_t(np.stack(same))) == want[: len(same)]
    assert any(b is None for b in want) and any(b is not None for b in want)


# -- (d) the crop track --------------------------------------------------------

_box = st.tuples(st.integers(0, 60), st.integers(0, 60), st.integers(1, 40),
                 st.integers(1, 40)).map(
    lambda b: (b[0], b[1], b[0] + b[2], b[1] + b[3]))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.none(), _box, _box.map(
    lambda b: (b[0] + 1, b[1], b[2] + 1, b[3]))), min_size=0, max_size=40),
       st.integers(1, 6), st.floats(0.3, 0.95))
def test_crop_track_functions_equal_jax(boxes, min_frames, thr):
    """iou, square_crop_box and segment_stable_boxes equal the JAX
    functions on drawn tracks (runs of near-equal boxes, jumps, losses)."""
    # repeat each draw a few times so that stable runs occur
    track = [b for b in boxes for _ in range(3)]
    assert tcrop.segment_stable_boxes(track, thr, min_frames) == \
        jcrop.segment_stable_boxes(track, thr, min_frames)
    for a, b in zip(boxes, boxes[1:]):
        if a is not None and b is not None:
            assert tcrop.iou(a, b) == jcrop.iou(a, b)
            assert tcrop.square_crop_box(a, (80, 70, 3)) == \
                jcrop.square_crop_box(a, (80, 70, 3))


# -- (e) the image-evidence seed ------------------------------------------


def _face_crops(n_videos=3, n_frames=3, size=256, margin=30):
    """Synthetic frames cropped to the face and a margin (the JAX test's
    regime: the crop stage runs first)."""
    frames = []
    for seed in range(n_videos):
        rng = np.random.default_rng(seed)
        bg = jsyn.textured_background(rng, size)
        cx0, cy0 = size / 2 + rng.uniform(-20, 20), size / 2 + rng.uniform(
            -20, 20)
        scale = size * rng.uniform(0.22, 0.3)
        for f in range(n_frames):
            lms = jsyn.face_landmarks((cx0 + 4 * f, cy0), scale, 3.0 * f)
            img = bg.copy()
            jsyn.draw_face(img, lms, (210, 170, 140))
            x1, y1 = np.maximum(lms.min(0) - margin, 0).astype(int)
            x2, y2 = np.minimum(lms.max(0) + margin, size).astype(int)
            frames.append(np.ascontiguousarray(img[y1:y2, x1:x2]))
    return frames


def test_image_evidence_seed_within_tolerance_of_jax():
    """ImageEvidenceLandmarker (valley path) against the JAX one on face
    crops and on a featureless skin ellipse (its box fallback): the blur
    is float32 in another order than cv2's, which can move a pixel across
    the 5th-percentile threshold of the eye search; landmarks within
    0.5 px of the JAX seed's (0.0 measured: the same pixels pass)."""
    frames = _face_crops()
    img = np.full((160, 160, 3), 40, np.uint8)
    cv2.ellipse(img, (80, 90), (40, 52), 0, 0, 360, (210, 170, 140), -1)
    frames.append(img)
    got = tdet.ImageEvidenceLandmarker(
        tdet.HeuristicDetector(device=CPU)).landmarks(frames)
    want = jdet.ImageEvidenceLandmarker(jdet.HeuristicDetector()).landmarks(
        frames)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=0.5)
    box = tdet.BoxLandmarker(tdet.HeuristicDetector(device=CPU)).landmarks(
        [img])[0]
    np.testing.assert_allclose(
        box, jdet.BoxLandmarker(jdet.HeuristicDetector()).landmarks([img])[0],
        rtol=0, atol=1e-4)


# -- (h) stage 1 ------------------------------------------------------------


def test_stage1_on_the_cpu_equals_jax(tmp_path, monkeypatch):
    """process_video on the port's raw AVI (40 frames, a jump at frame
    22): the JAX stage, reading the same file through cv2, finds the same
    segments and crop boxes (both write mp4, lossy, so the JAX clip
    lengths are compared); the frames the port hands its writer are
    cv2.resize of those crops bit for bit, and its clips hold the port's
    mp4v reconstruction of those frames bit for bit."""
    raw = str(tmp_path / "raw.avi")
    frames = _raw_frames(40, 160, cut=22)
    tvideo.save_frames_as_video(frames, raw)
    cap = cv2.VideoCapture(raw)
    read = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        read.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(np.stack(read), np.stack(frames))

    boxes = [jdet.HeuristicDetector().detect(f) for f in frames]
    segments = jcrop.segment_stable_boxes(boxes, min_frames=10)
    assert len(segments) == 2
    handed = {}

    def save(clip, path, *args, **kwargs):
        handed[path] = np.stack([np.asarray(f) for f in clip])
        return save_frames(clip, path, *args, **kwargs)

    save_frames = tcrop.save_frames_as_video
    monkeypatch.setattr(tcrop, "save_frames_as_video", save)
    written = tcrop.process_video(raw, str(tmp_path / "t"), min_frames=10,
                                  resolution=64, chunk_frames=25,
                                  device=CPU)
    jax_written = jcrop.process_video(raw, str(tmp_path / "j"),
                                      detector=jdet.HeuristicDetector(),
                                      min_frames=10, resolution=64,
                                      chunk_frames=25)
    # chunks of 25 frames: [0, 22) and [22, 25) in the first, [25, 40)
    # in the second; the 3-frame piece is too short
    want = [s for lo, hi in ((0, 25), (25, 40)) for s in
            jcrop.segment_stable_boxes(boxes[lo:hi], min_frames=10)]
    assert len(written) == len(jax_written) == len(want) == 2
    lo_of = [0, 25]
    for path, jpath, (start, end, mean_box), lo in zip(
            written, jax_written, want, lo_of):
        assert path.endswith(".mp4") and jpath.endswith(".mp4")
        got = tvideo.read_video_frames(path, device=CPU)
        assert len(got) == len(jvideo.read_video_frames(jpath)) == end - start
        x1, y1, x2, y2 = jcrop.square_crop_box(mean_box, frames[0].shape)
        ref = [cv2.resize(f[y1:y2, x1:x2], (64, 64))
               for f in frames[lo + start: lo + end]]
        np.testing.assert_array_equal(handed[path], np.stack(ref))
        *_, recon = tmpeg4.encode(torch.from_numpy(np.stack(ref)), 25,
                                  return_recon=True)
        np.testing.assert_array_equal(got.numpy(), recon.numpy())


# -- (i) stage 2 and the command line -------------------------------------------


def test_cli_all_on_the_cpu_writes_the_contract_both_datasets_read(tmp_path):
    """cli.preprocess.main(["all", ...], device="cpu") on two raw AVIs:
    PNG frames and landmark files in the contract; the JAX stage 2 on the
    same clips keeps the same frames, and its first frame's landmarks (the
    image-evidence seed) agree within the seed's 0.5 px. Later frames are
    not compared: on these flat-coloured 64 px clips the tracker is
    chaotic (sub-millipixel LK differences from cv2's float32 sums flip
    forward-backward decisions, and the two tracks part by up to 3.4 px
    by frame 20; the mouth clip above stays within 0.05 px). The JAX and
    the port datasets read the output with equal items."""
    raw = tmp_path / "raw"
    tvideo.save_frames_as_video(_raw_frames(24, 160), str(raw / "a.avi"))
    tvideo.save_frames_as_video(
        [np.ascontiguousarray(f[:, ::-1]) for f in _raw_frames(20, 160)],
        str(raw / "b.avi"))
    out = tmp_path / "clips"
    res = tcli.main(["all", "--videos", str(raw), "--out", str(out),
                     "--resolution", "64", "--min_frames", "10",
                     "--bad_list", str(tmp_path / "bad.json")], device=CPU)
    assert len(res["clips"]) == len(res["ok"]) == 2 and not res["quarantined"]
    for clip in res["ok"]:
        d = osp.splitext(clip)[0]
        pngs = sorted(glob.glob(osp.join(d, "*.png")))
        npzs = sorted(glob.glob(osp.join(d, "*_landmarks.npz")))
        assert len(pngs) == len(npzs) == len(
            tvideo.read_video_frames(clip, device=CPU))
        jdir = tmp_path / "j" / osp.relpath(d, out)
        ok, n, _ = jlms.generate_landmarks_for_video(clip, str(jdir),
                                                     resolution=64)
        assert ok and n == len(npzs)
        assert [osp.basename(p) for p in npzs] == sorted(
            osp.basename(p) for p in glob.glob(osp.join(jdir, "*.npz")))
        for p in npzs:
            got = np.load(p)["landmark"]
            assert got.shape == (68, 2) and got.dtype == np.float32
        np.testing.assert_allclose(
            np.load(npzs[0])["landmark"],
            np.load(osp.join(jdir, osp.basename(npzs[0])))["landmark"],
            rtol=0, atol=0.5)
    t_ds = tds.TemporalAlignmentDataset(str(out), "train", 4, resolution=64)
    j_ds = jds.TemporalAlignmentDataset(str(out), "train", 4, resolution=64)
    assert t_ds.videos == j_ds.videos and len(t_ds) == 2
    for i in range(len(t_ds)):
        got = t_ds.get_item(i, np.random.default_rng(i))
        want = j_ds.get_item(i, np.random.default_rng(i))
        np.testing.assert_array_equal(got["gt"], want["gt"])
        np.testing.assert_array_equal(got["background"], want["background"])


def test_entry_points_need_cuda_or_the_cpu_named(tmp_path, monkeypatch):
    """Without CUDA and without a named device the entry points raise,
    an .mp4 read or write among them; an H.264 mp4 (an avc1 sample entry)
    raises naming its codec; motion JPEG on the CPU raises naming the
    ROADMAP entry."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = str(tmp_path / "raw.avi")
    tvideo.save_frames_as_video(_raw_frames(4, 64), raw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcrop.process_video(raw, str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlms.generate_landmarks_for_video(raw, str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["crop", "--videos", str(tmp_path), "--out",
                   str(tmp_path / "o")])
    mp4 = str(tmp_path / "x.mp4")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvideo.save_frames_as_video(_raw_frames(2, 64), mp4)
    tvideo.save_frames_as_video(_raw_frames(2, 64), mp4, device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvideo.read_video_frames(mp4)
    avc = str(tmp_path / "h264.mp4")
    with open(mp4, "rb") as src, open(avc, "wb") as dst:
        dst.write(src.read().replace(b"mp4v", b"avc1"))
    with pytest.raises(ValueError, match=r"H\.264 \(avc1\)"):
        tvideo.read_video_frames(avc, device=CPU)
    with pytest.raises(RuntimeError, match="item 7b"):
        tvideo.save_frames_as_video(_raw_frames(2, 64),
                                    str(tmp_path / "x.avi"), codec="mjpg",
                                    device=CPU)


# -- (j) the motion-JPEG container ---------------------------------------------


def test_mjpeg_avi_container_read_by_cv2(tmp_path):
    """An MJPEG AVI written from the committed JPEG fixtures' bytes is read
    by cv2.VideoCapture (OpenCV's own MJPEG reader, which decodes with
    libjpeg as cv2.imdecode does; FFmpeg's decoder upsamples chroma
    otherwise) into the frames cv2.imdecode gives for those files, and
    the port's reader gives back the same bytes; decoding them needs
    CUDA."""
    files = sorted(glob.glob(osp.join(osp.dirname(__file__), "data_torch",
                                      "face256_*.jpg")))
    bodies = [open(f, "rb").read() for f in files] * 2
    refs = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
            for b in bodies]
    h, w = refs[0].shape[:2]
    path = str(tmp_path / "m.avi")
    tvideo.write_avi(path, bodies, w, h, 25, "mjpg")
    cap = cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(f)
    assert len(got) == len(refs)
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(g, r)
    cap = cv2.VideoCapture(path)  # the default backend counts them too
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(refs)
    codec, width, height, back = tvideo.read_avi(path)
    assert (codec, width, height) == ("mjpg", w, h) and back == bodies
    with pytest.raises(RuntimeError, match="item 7b"):
        tvideo.read_video_frames(path, device=CPU)
