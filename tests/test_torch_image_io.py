"""The port's image and video files against cv2 and the JAX package, on
the CPU: PNG decoding (every row filter) and encoding, the AVI sample
streams, image grids, and `resize_frame`. Inputs are made with numpy from
a seed."""

import zlib

import cv2
import numpy as np
import pytest

from faceoff_tpu.data import dataset as jds
from faceoff_tpu.data import geometry as jgeom
from faceoff_tpu_torch.data import dataset as tds
from faceoff_tpu_torch.data import geometry as tgeom
from faceoff_tpu_torch.io import image as timage
from faceoff_tpu_torch.io import video as tvideo


def _picture(rng, shape):
    """Noise in the top third (None/Sub rows win there), smooth below
    (Up/Average/Paeth rows win)."""
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    img = cv2.GaussianBlur(noise, (5, 5), 1.5)
    img[: shape[0] // 3] = noise[: shape[0] // 3]
    return img


def _row_filters(path, shape):
    data = open(path, "rb").read()
    raw = zlib.decompress(b"".join(
        body for kind, body in timage._chunks(data) if kind == b"IDAT"))
    stride = shape[1] * (shape[2] if len(shape) == 3 else 1) + 1
    return {raw[i * stride] for i in range(shape[0])}


@pytest.mark.parametrize("shape,row_filter", [
    ((31, 17, 3), "sub"), ((20, 33), "sub"), ((16, 24, 3), "none"),
    ((9, 5), "none")])
def test_png_round_trip_is_bit_exact(tmp_path, shape, row_filter):
    """write_png then read_png gives the image back bit for bit, and cv2
    reads the same pixels (the file is a valid PNG)."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(
        np.uint8)
    path = tmp_path / "x.png"
    timage.write_png(path, img, row_filter=row_filter)
    np.testing.assert_array_equal(timage.read_png(path), img)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(ref if ref.ndim == 2 else ref[..., ::-1],
                                  img)


@pytest.mark.parametrize("flag,shape", [
    ("IMWRITE_PNG_ALL_FILTERS", (48, 40, 3)),
    ("IMWRITE_PNG_ALL_FILTERS", (30, 21)),
    ("IMWRITE_PNG_FILTER_PAETH", (24, 20, 3)),
    ("IMWRITE_PNG_FILTER_AVG", (24, 20, 3)),
    ("IMWRITE_PNG_FILTER_UP", (24, 20, 3))])
def test_read_png_equals_cv2_imread(tmp_path, flag, shape):
    """PNGs that cv2.imwrite wrote with libpng's filters (all five row
    types occur across the cases) decode bit-exactly: read_png equals
    cv2.imread, and the port's load_frame equals the JAX package's (both
    at the file's own size, where resize_frame is the identity)."""
    rng = np.random.default_rng(len(flag) + shape[0])
    img = _picture(rng, shape)
    square = shape[0] == shape[1]
    path = tmp_path / "00000.png"
    cv2.imwrite(str(path), img if img.ndim == 2 else img[..., ::-1],
                [cv2.IMWRITE_PNG_FILTER, getattr(cv2, flag)])
    if flag == "IMWRITE_PNG_ALL_FILTERS" and len(shape) == 3:
        assert _row_filters(path, shape) == {0, 1, 2, 3, 4}
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(
        timage.read_png(path), ref if ref.ndim == 2 else ref[..., ::-1])
    lm = tmp_path / "00000_landmarks.npz"
    np.savez(lm, landmark=rng.uniform(0, 20, (68, 2)).astype(np.float32))
    size = shape[0] if square else max(shape[:2])
    got, got_l = tds.load_frame(str(lm), size)
    want, want_l = jds.load_frame(str(lm), size)
    np.testing.assert_array_equal(got_l, want_l)
    if square:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["uint8", "float"])
def test_avi_round_trip(tmp_path, dtype):
    """save_frames_as_video then read_video_frames gives the frames back
    bit for bit (uint8 as is; [0, 1] floats rounded to uint8 first), with
    odd widths whose rows are padded to four bytes."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (5, 18, 21, 3)).astype(np.uint8)
    given = list(frames) if dtype == "uint8" else [f / 255.0 for f in frames]
    path = tmp_path / "1_0_0_source.avi"
    tvideo.save_frames_as_video(given, str(path))
    back = tvideo.read_video_frames(str(path))
    assert len(back) == 5
    for a, b in zip(back, frames):
        np.testing.assert_array_equal(a, b)
    assert len(tvideo.read_video_frames(str(path), max_frames=2)) == 2


def test_save_image_grid_is_a_png(tmp_path):
    """Grids tile the frames row-major into a PNG that cv2 reads."""
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (4, 8, 6, 3)).astype(np.uint8)
    path = tmp_path / "grid.png"
    tvideo.save_image_grid(list(frames), str(path))
    grid = cv2.imread(str(path))[..., ::-1]
    assert grid.shape == (16, 12, 3)
    np.testing.assert_array_equal(grid[8:16, 0:6], frames[2])


def test_resize_frame_matches_jax():
    """At the target size resize_frame is the identity (bit-exact, as
    cv2.resize). A 320x192 frame is padded to 320x320 and shrunk to 256:
    cv2 blends two taps a side with 11-bit fixed-point weights and its
    vector path shifts the row sums right by 4 and rounds twice; the port
    repeats that arithmetic, and a value may still round the other way
    where cv2's scalar tail takes over, so |diff| <= 1 level and at most
    2 % of the values differ."""
    rng = np.random.default_rng(5)
    same = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tgeom.resize_frame(same, 64), same)
    np.testing.assert_array_equal(tgeom.resize_frame(same, 64),
                                  jgeom.resize_frame(same, 64))
    wide = cv2.GaussianBlur(
        rng.integers(0, 256, (192, 320, 3)).astype(np.uint8), (5, 5), 2)
    got = tgeom.resize_frame(wide, 256).astype(np.int64)
    want = jgeom.resize_frame(wide, 256).astype(np.int64)
    assert got.shape == want.shape == (256, 256, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.02


def test_read_image_replicates_grey_and_jpeg_needs_cuda(tmp_path):
    """A grey PNG reads as three equal channels; a JPEG on a machine
    without CUDA raises, naming why (there is no JPEG decoder on the
    CPU)."""
    grey = np.arange(12 * 7, dtype=np.uint8).reshape(12, 7)
    path = tmp_path / "g.png"
    timage.write_png(path, grey)
    rgb = timage.read_image(path)
    assert rgb.shape == (12, 7, 3)
    for c in range(3):
        np.testing.assert_array_equal(rgb[..., c], grey)
    with pytest.raises(RuntimeError, match="nvJPEG"):
        timage.decode_jpeg_batch([tmp_path / "x.jpg"], device="cpu")
