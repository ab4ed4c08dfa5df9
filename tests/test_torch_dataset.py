"""The port's host data path against the JAX package on the CPU: video
discovery and clip windows on a PNG dataset, hull and box masks, every
perturbation and the composite, the self-supervised items, the loaders
and the resident corpus decoded from disk. Both packages get the same
numpy seeds.

Tolerances of the resampled images, in uint8 levels, from the arithmetic
(`faceoff_tpu_torch/data/geometry.py`): integer translations and
same-size resizes are exact. The rotation and remaps blend four taps in
float32 as cv2 does and the zoom sums cv2's float32 cubic weights; a
value whose blend lands within a float32 rounding of a half can round
the other way, so one operation differs by at most 1 level, in few
values (<= 0.1 %). A composite chains at most three such resamplings
(rotation, zoom, distortion): a later bilinear blend passes an earlier
difference of d on as at most d, the cubic zoom as at most its weights'
absolute sum (1.375 a side, 1.89 in 2-D) times d, each plus its own
rounding, so a composite differs by at most 3 levels, again in <= 0.1 %
of the values."""

import numpy as np
import pytest
import torch

from faceoff_tpu.data import dataset as jds
from faceoff_tpu.data import device_pipeline as jdp
from faceoff_tpu.data import geometry as jgeom
from faceoff_tpu.data import perturbations as jpert
from faceoff_tpu.data import pipeline as jpipe
from faceoff_tpu.data import resident as jres
from faceoff_tpu_torch.data import dataset as tds
from faceoff_tpu_torch.data import device_pipeline as tdp
from faceoff_tpu_torch.data import geometry as tgeom
from faceoff_tpu_torch.data import perturbations as tpert
from faceoff_tpu_torch.data import pipeline as tpipe
from faceoff_tpu_torch.data import resident as tres
from faceoff_tpu_torch.data import synthetic as tsyn

ONE_OP = dict(max_levels=1, max_share=1e-3)
COMPOSITE = dict(max_levels=3, max_share=1e-3)
SIZE = 64


def _close(got, want, max_levels, max_share):
    diff = np.abs(np.asarray(got).astype(np.int64)
                  - np.asarray(want).astype(np.int64))
    assert diff.max() <= max_levels, diff.max()
    assert (diff > 0).mean() <= max_share, (diff > 0).mean()


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngds")
    tsyn.generate_dataset(str(root), n_videos=3, n_frames=8, size=SIZE,
                          seed=2)
    return str(root)


@pytest.fixture(scope="module")
def face():
    """A textured 64x64 frame, its landmarks and the face inside the hull."""
    rng = np.random.default_rng(7)
    lms = tsyn.face_landmarks((33.0, 31.5), 16.0, 4.0)
    noise = rng.integers(0, 256, (SIZE, SIZE, 3)).astype(np.int64)
    img = ((noise + np.roll(noise, 1, 0) + np.roll(noise, 1, 1)) // 3
           ).astype(np.uint8)
    mask = jgeom.convex_hull_mask(img.shape, lms[17:67])
    return img, lms, jgeom.apply_mask(mask, img)


def test_synthetic_dataset_on_disk_is_the_corpus(png_root):
    """generate_dataset writes the frames and landmarks of
    synthetic_corpus with the same arguments, as PNG."""
    frames, lms, _ = tsyn.synthetic_corpus(3, 8, SIZE, seed=2)
    got, got_l = tds.load_window_frames(
        tds._landmark_paths(png_root + "/video_001"), SIZE)
    np.testing.assert_array_equal(got, frames[1].numpy())
    np.testing.assert_array_equal(got_l, lms[1])


def test_videos_and_windows_equal_jax(png_root):
    """list_videos and load_window_frames equal the JAX package's bit for
    bit (PNG decoding is exact; the frames are at the target size)."""
    assert tds.list_videos(png_root) == jds.list_videos(png_root)
    for vdir in tds.list_videos(png_root):
        paths = tds._landmark_paths(vdir)
        assert paths == jds._landmark_paths(vdir)
        got, got_l = tds.load_window_frames(paths[2:6], SIZE)
        want, want_l = jds.load_window_frames(paths[2:6], SIZE)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_l, want_l)


@pytest.mark.parametrize("case", ["face", "inside", "crossing"])
def test_convex_hull_mask_equals_cv2(case):
    """cv2's convexHull + fillConvexPoly rule for integer vertices (edge
    lines, 16.16 scanline fill, clipped lines): the masks are equal, also
    for hulls that leave the image."""
    rng = np.random.default_rng(len(case))
    for _ in range(25):
        if case == "face":
            pts = tsyn.face_landmarks(tuple(rng.uniform(20, 44, 2)),
                                      rng.uniform(8, 20),
                                      rng.uniform(-10, 10))[17:67]
        elif case == "inside":
            pts = rng.uniform(0, SIZE - 1, (int(rng.integers(3, 12)), 2))
        else:
            pts = rng.uniform(-20, SIZE + 20, (int(rng.integers(3, 12)), 2))
        for shape in ((SIZE, SIZE), (SIZE, SIZE, 3)):
            np.testing.assert_array_equal(
                tgeom.convex_hull_mask(shape, pts),
                jgeom.convex_hull_mask(shape, pts))


def test_box_mask_and_apply_mask_equal_jax(face):
    img, lms, _ = face
    box = tgeom.bounding_box_mask(img.shape, lms[17:67])
    np.testing.assert_array_equal(box,
                                  jgeom.bounding_box_mask(img.shape,
                                                          lms[17:67]))
    np.testing.assert_array_equal(tgeom.apply_mask(box, img),
                                  jgeom.apply_mask(box, img))


@pytest.mark.parametrize("name", [
    "translate", "rotate", "rescale_in", "rescale_out", "barrel",
    "barrel_inverse", "arc"])
def test_each_perturbation_matches_jax(face, name):
    """Each perturbation alone, within the one-operation tolerance (the
    translation exactly)."""
    _, lms, img = face
    eye = tpert.find_eye_center(lms)
    assert eye == jpert.find_eye_center(lms)
    calls = {
        "translate": lambda m: m.translate(img, -3, 2),
        "rotate": lambda m: m.rotate(img, 3.0, center=eye),
        "rescale_in": lambda m: m.rescale(img, 1.07),
        "rescale_out": lambda m: m.rescale(img, 0.91),
        "barrel": lambda m: m.barrel_distort(img, 0.3, 0.5, 0.2),
        "barrel_inverse": lambda m: m.barrel_inverse_distort(img, 0.0, 0.1,
                                                              -0.3),
        "arc": lambda m: m.arc_distort(img, 17.0),
    }
    got, want = calls[name](tpert), calls[name](jpert)
    assert got.shape == want.shape
    if name == "translate":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, **ONE_OP)


@pytest.mark.parametrize("seed", range(4))
def test_perturb_image_composite_matches_jax(face, seed):
    """The same Generator picks the same perturbations and amounts (the
    ground-truth dicts are equal, the streams end in the same state); the
    images agree within the composite tolerance."""
    _, lms, img = face
    for k in range(6):
        r_t = np.random.default_rng(100 * seed + k)
        r_j = np.random.default_rng(100 * seed + k)
        got, gt_t = tpert.perturb_image_composite(img, lms, r_t)
        want, gt_j = jpert.perturb_image_composite(img, lms, r_j)
        assert gt_t == gt_j
        assert r_t.integers(0, 1 << 30) == r_j.integers(0, 1 << 30)
        _close(got, want, **COMPOSITE)


@pytest.mark.parametrize("jitter,bb", [("", False), ("random", False),
                                       ("const", True)])
def test_get_item_jitter_and_pack_batch_match_jax(png_root, jitter, bb):
    """Items of the train mode: background and target exact, the perturbed
    source within the composite tolerance (in [-1, 1]: 3 levels are
    3 / 127.5), for colour jitter off, per frame and per clip, hull and
    box masks; pack_batch stacks both alike."""
    kw = dict(resolution=SIZE, color_jitter_type=jitter, use_bb_mask=bb)
    t_ds = tds.TemporalAlignmentDataset(png_root, "train", 4, **kw)
    j_ds = jds.TemporalAlignmentDataset(png_root, "train", 4, **kw)
    items_t, items_j = [], []
    for index in range(len(t_ds)):
        items_t.append(t_ds.get_item(index, np.random.default_rng(index)))
        items_j.append(j_ds.get_item(index, np.random.default_rng(index)))
    got, want = tds.pack_batch(items_t), jds.pack_batch(items_j)
    assert sorted(got) == sorted(want) == ["gt", "input"]
    np.testing.assert_array_equal(got["gt"], want["gt"])
    np.testing.assert_array_equal(got["input"][..., 3:], want["input"][..., 3:])
    _close(tds.denormalize(got["input"][..., :3]),
           jds.denormalize(want["input"][..., :3]), **COMPOSITE)


def test_loaders_match_jax(png_root):
    """The DataLoader's seeded epoch order and per-clip Generators, and
    RawClipLoader's windows, are the JAX package's: the same clips in the
    same batches (targets and raw frames exact)."""
    t_ds = tds.TemporalAlignmentDataset(png_root, "train", 4,
                                        resolution=SIZE)
    j_ds = jds.TemporalAlignmentDataset(png_root, "train", 4,
                                        resolution=SIZE)
    t_loader = tpipe.DataLoader(t_ds, 1, num_workers=2, seed=3)
    j_loader = jpipe.DataLoader(j_ds, 1, num_workers=2, seed=3)
    assert len(t_loader) == len(j_loader) == 3
    for got, want in zip(t_loader, j_loader):
        np.testing.assert_array_equal(got["gt"], want["gt"])
    t_raw = tdp.RawClipLoader(t_ds, 3, num_workers=2, seed=4)
    j_raw = jdp.RawClipLoader(j_ds, 3, num_workers=2, seed=4)
    got, want = next(iter(t_raw)), next(iter(j_raw))
    np.testing.assert_array_equal(got["frames"], want["frames"])
    np.testing.assert_array_equal(got["landmarks"], want["landmarks"])


def test_prefetch_to_device_on_the_cpu():
    """On the CPU the staged batches are the host arrays as tensors, in
    order, and an error of the loader reaches the consumer."""
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(4)]
    got = list(tpipe.prefetch_to_device(iter(batches), "cpu"))
    assert [int(b["x"][0, 0]) for b in got] == [0, 1, 2, 3]
    assert isinstance(got[0]["x"], torch.Tensor)

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(tpipe.prefetch_to_device(broken(), "cpu"))


def test_build_resident_corpus_matches_jax(png_root):
    """The corpus decoded from disk equals the JAX package's (frames,
    landmarks and frame counts as numpy arrays), with a frame cap; the
    budget guard raises before staging."""
    t_ds = tds.TemporalAlignmentDataset(png_root, "train", 4,
                                        resolution=SIZE)
    j_ds = jds.TemporalAlignmentDataset(png_root, "train", 4,
                                        resolution=SIZE)
    got = tres.build_resident_corpus(t_ds, max_frames_per_video=6,
                                     device="cpu")
    want = jres.build_resident_corpus(j_ds, max_frames_per_video=6)
    np.testing.assert_array_equal(got.frames.numpy(), np.asarray(want.frames))
    np.testing.assert_array_equal(got.landmarks.numpy(),
                                  np.asarray(want.landmarks))
    np.testing.assert_array_equal(got.n_frames.numpy(),
                                  np.asarray(want.n_frames))
    with pytest.raises(MemoryError):
        tres.build_resident_corpus(t_ds, hbm_budget_bytes=1000, device="cpu")


@pytest.mark.parametrize("kw", [{"cross_identity": True},
                                {"custom_validation_source": "."},
                                {"alignment": True},
                                {"naive_blend": "paste"}])
def test_dataset_refuses_unported_items(png_root, kw):
    """These item kinds were refused until the port had the host swap
    geometry; now none is, and each builds its item with its own streams
    (naive_blend alone leaves the self-supervised item as it is, as in
    the JAX package). "." stands for the dataset's own root; an unknown
    naive_blend is still refused."""
    kw = {k: png_root if v == "." else v for k, v in kw.items()}
    ds = tds.TemporalAlignmentDataset(png_root, "val", 4, **kw)
    item = ds.get_item(0, np.random.default_rng(0))
    extra = {"cross_identity": {"source_original"},
             "custom_validation_source": {"source_original"},
             "alignment": {"transforms"}}.get(next(iter(kw)), set())
    assert set(item) == {"source", "background", "gt"} | extra
    with pytest.raises(ValueError, match="naive_blend"):
        tds.TemporalAlignmentDataset(png_root, "val", 4, naive_blend="soft")


@pytest.mark.parametrize("kw", [
    {"cross_identity": True},
    {"cross_identity": True, "naive_blend": "paste"},
    {"cross_identity": True, "naive_blend": "poisson"},
    {"custom_validation_source": "."},
    {"alignment": True}])
def test_swap_and_alignment_items_match_jax(png_root, kw):
    """Cross-identity (with no naive stream, a paste or a Poisson blend),
    custom-validation and alignment items from the same seeds as the JAX
    package's: the same windows and target videos (the targets' frames
    and the source frames equal), the regressed transforms equal, the
    other streams within one resampling's tolerance (the host geometry's,
    tests/test_torch_swap.py); the alignment item's perturbed source
    within the composite tolerance. Colour jitter is off for
    cross-identity items."""
    kw = {k: png_root if v == "." else v for k, v in kw.items()}
    kw = dict(kw, resolution=SIZE, color_jitter_type="random")
    t_ds = tds.TemporalAlignmentDataset(png_root, "val", 3, **kw)
    j_ds = jds.TemporalAlignmentDataset(png_root, "val", 3, **kw)
    assert t_ds.color_jitter_type == j_ds.color_jitter_type
    for index in range(len(t_ds)):
        r_t, r_j = (np.random.default_rng(10 + index) for _ in range(2))
        got, want = t_ds.get_item(index, r_t), j_ds.get_item(index, r_j)
        assert list(got) == list(want)
        assert r_t.integers(0, 1 << 30) == r_j.integers(0, 1 << 30)
        for k in want:
            if k in ("gt", "source_original", "transforms"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            elif k == "source" and "alignment" in kw:
                _close(tds.denormalize(got[k]), jds.denormalize(want[k]),
                       **COMPOSITE)
            else:
                _close(tds.denormalize(got[k]), jds.denormalize(want[k]),
                       **ONE_OP)
