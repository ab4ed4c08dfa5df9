"""The port's cross-identity swap against the JAX package on the CPU: the
host swap geometry against cv2 (which the JAX host geometry calls), the
Poisson blend on the device and on the host, and the swap command line
as a whole against the JAX functions it twins. Inputs are made with numpy
from seeds; the JAX side is jitted.

Tolerances:
  * `enlarge_mask` is cv2's thick contour bit for bit: the quadrilaterals
    with 16.16 fixed-point corners, the fill rule, the integer circles;
  * the cubic `warp_affine` blends sixteen taps in float32 as cv2 does,
    in its order of rows where measured equal; a value whose blend lands
    within a float32 rounding of a half may round the other way, so at
    most 1 level, in at most 0.1 % of the values. Bilinear warps of the
    swap (`generate_warped_image`) are held the same way, as in
    tests/test_torch_dataset.py;
  * the Poisson blend: 2e-4 at 48 iterations, as the JAX package holds
    its device blend to its host blend (tests/test_swap_device.py). Where
    the iteration diverges (the mask above about 0.73) both sides run
    past [0, 1] and clip to the same bound;
  * the swap's frames (uint8) against the JAX model's on the same
    weights, float32: the model inputs agree to 1e-4 (the geometry above,
    or `prepare_swap_batch`'s parity in tests/test_torch_warp.py), the
    convolutions sum in other orders (about 1e-6), so a frame's rounding
    to a level flips by at most 1 level, in at most 1 % of the values;
  * streamed against chunked frames: STREAM_TOL (atol 2e-4 of the
    [-1, 1] output) moves a rounding to a level by at most one level, on
    the frames that both compute from the same neighbours.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.cli import swap as jcli_swap
from faceoff_tpu.data import geometry as jgeom
from faceoff_tpu.data import synthetic as jsyn
from faceoff_tpu.data.dataset import normalize as jnormalize
from faceoff_tpu.models import VQVAE as JaxVQVAE
from faceoff_tpu.ops import swap as jswap
from faceoff_tpu_torch.cli import swap as tcli
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data import geometry as tgeom
from faceoff_tpu_torch.data import synthetic as tsyn
from faceoff_tpu_torch.data.dataset import (_landmark_paths, denormalize,
                                            load_frame)
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.io.convert import from_jax_variables
from faceoff_tpu_torch.io.video import read_video_frames
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.ops import swap as tswap
from faceoff_tpu_torch.train.state import create_train_state

ONE_OP = dict(max_levels=1, max_share=1e-3)
FRAMES = dict(max_levels=1, max_share=1e-2)
WIDTHS = dict(channel=16, n_res_block=2, n_res_channel=8, embed_dim=8,
              n_embed=16)
NARROW = ["--channel", "16", "--n_res_channel", "8", "--embed_dim", "8",
          "--n_embed", "16"]
SIZE, N_FRAMES, CHUNK = 32, 12, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, max_levels, max_share):
    diff = np.abs(np.asarray(got).astype(np.int64)
                  - np.asarray(want).astype(np.int64))
    assert diff.max() <= max_levels, diff.max()
    assert (diff > 0).mean() <= max_share, (diff > 0).mean()


def _jax_pair(size):
    """tests/test_swap_device.py's pair, scaled from its 128 px."""
    k = size / 128

    def frame(center, scale, color):
        img = np.zeros((size, size, 3), np.uint8)
        lms = jsyn.face_landmarks(center, scale)
        jsyn.draw_face(img, lms, color)
        return img, lms.astype(np.float32)

    s_img, s_lms = frame((60 * k, 64 * k), 30 * k, (205, 165, 135))
    t_img, t_lms = frame((70 * k, 60 * k), 24 * k, (150, 180, 120))
    return s_img, s_lms, t_img, t_lms


def _textured_pair(size, seed):
    """Two textured frames with faces that differ in place, size and roll."""
    rng = np.random.default_rng(seed)
    out = []
    for c, s, a in (((0.45, 0.5), 0.22, 6.0), ((0.55, 0.47), 0.18, -5.0)):
        noise = rng.integers(0, 256, (size, size, 3)).astype(np.int64)
        img = ((noise + np.roll(noise, 1, 0) + np.roll(noise, 1, 1)) // 3
               ).astype(np.uint8)
        lms = tsyn.face_landmarks((c[0] * size, c[1] * size), s * size, a)
        out += [img, lms.astype(np.float32)]
    return out


# -- the host geometry against cv2 ------------------------------------------


@pytest.mark.parametrize("enlargement", [1, 5, 10])
@pytest.mark.parametrize("case", ["face", "inside", "crossing"])
def test_enlarge_mask_equals_cv2(case, enlargement):
    """Bit for bit on seeded hulls of face landmarks, of random points
    inside the frame and of random points well past its edges (the hull
    then clipped by the frame, with the holes near the edge that cv2's
    fill leaves), in one and three channels and at two sizes; the thin
    pen (1) and the thick ones the swap uses (5, 10)."""
    rng = np.random.default_rng(10 * len(case) + enlargement)
    for i in range(16):
        size = (64, 128)[i % 2]
        if case == "face":
            pts = tsyn.face_landmarks(tuple(rng.uniform(0.2, 0.8, 2) * size),
                                      rng.uniform(0.12, 0.4) * size,
                                      rng.uniform(-20, 20))[17:67]
        elif case == "inside":
            pts = rng.uniform(0, size - 1, (int(rng.integers(3, 12)), 2))
        else:
            pts = rng.uniform(-size / 3, size * 4 / 3,
                              (int(rng.integers(3, 12)), 2))
        shape = (size, size, 3) if i % 4 < 2 else (size, size)
        mask = jgeom.convex_hull_mask(shape, pts)
        np.testing.assert_array_equal(tgeom.enlarge_mask(mask, enlargement),
                                      jgeom.enlarge_mask(mask, enlargement))
    empty = np.zeros((16, 16), np.uint8)
    np.testing.assert_array_equal(tgeom.enlarge_mask(empty, 10), empty)


def test_cubic_warp_affine_within_a_level_of_cv2():
    import cv2

    rng = np.random.default_rng(4)
    for i in range(8):
        size = (48, 64)[i % 2]
        img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        if i % 3 == 0:
            img = img[..., 0].copy()
        m = cv2.getRotationMatrix2D(
            tuple(float(v) for v in rng.uniform(8, size - 8, 2)),
            float(rng.uniform(-30, 30)), float(rng.uniform(0.6, 1.5)))
        m[:, 2] += rng.uniform(-10, 10, 2)
        want = cv2.warpAffine(img, m, (size, size), flags=cv2.INTER_CUBIC)
        _close(tgeom.warp_affine(img, m, interpolation="cubic"), want,
               **ONE_OP)


@pytest.mark.parametrize("poisson", [False, True])
def test_generate_warped_image_matches_jax(poisson):
    s_img, s_lms, t_img, t_lms = _textured_pair(64, 1)
    got = tgeom.generate_warped_image(s_lms, t_lms, s_img, t_img,
                                      poisson=poisson)
    want = jgeom.generate_warped_image(s_lms, t_lms, s_img, t_img,
                                       poisson=poisson)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["transform"], want["transform"],
                               rtol=1e-12, atol=1e-9)
    for k in want:
        if k != "transform":
            _close(got[k], want[k], **ONE_OP)


@pytest.mark.parametrize("require_full_mask", [False, True])
def test_generate_aligned_image_matches_jax(require_full_mask):
    s_img, s_lms, t_img, t_lms = _textured_pair(64, 2)
    got = tgeom.generate_aligned_image(s_lms, t_lms, s_img, t_img,
                                       require_full_mask=require_full_mask)
    want = jgeom.generate_aligned_image(s_lms, t_lms, s_img, t_img,
                                        require_full_mask=require_full_mask)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["transform"], want["transform"],
                               rtol=1e-12, atol=1e-9)
    for k in want:
        if k != "transform":
            _close(got[k], want[k], **ONE_OP)


def test_host_helpers_match_jax():
    """umeyama_similarity (float64, SVD), eye_geometry, combine_images."""
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 100, (5, 2))
    dst = src @ np.array([[0.9, -0.3], [0.3, 0.9]]) + rng.normal(0, 2, (5, 2))
    np.testing.assert_allclose(tgeom.umeyama_similarity(src, dst),
                               jgeom.umeyama_similarity(src, dst),
                               rtol=1e-12, atol=1e-12)
    lms = tsyn.face_landmarks((40.3, 37.9), 21.0, 7.0)
    assert tgeom.eye_geometry(lms) == jgeom.eye_geometry(lms)
    bg = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    fg = (rng.integers(0, 256, (16, 16, 3))
          * (rng.uniform(size=(16, 16, 1)) > 0.5)).astype(np.uint8)
    np.testing.assert_array_equal(tgeom.combine_images(bg, fg),
                                  jgeom.combine_images(bg, fg))


# -- the Poisson blend ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_blend():
    return jax.jit(jswap.poisson_blend, static_argnames="iters")


def _blend_inputs(size):
    s_img, s_lms, t_img, t_lms = _jax_pair(size)
    face = jgeom.generate_warped_image(s_lms, t_lms, s_img, t_img)[
        "source_face_transformed"]
    return t_img / 255.0, s_img / 255.0, face / 255.0


def test_poisson_blend_matches_jax_at_48_iterations(jax_blend):
    """The device blend against the JAX device blend, and the host blend
    against the JAX host blend (scipy), on the JAX test's 128 px pair."""
    t01, s01, m01 = _blend_inputs(128)
    want = np.asarray(jax_blend(*(jnp.asarray(a, jnp.float32)
                                  for a in (t01, s01, m01)), iters=48))
    got = tswap.poisson_blend(*(torch.from_numpy(a).to(torch.float32)
                                for a in (t01, s01, m01)), iters=48)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(tgeom.poisson_blend(t01, s01, m01, iters=48),
                               jgeom.poisson_blend(t01, s01, m01, iters=48),
                               atol=2e-4)


def test_poisson_blend_diverges_in_both_packages(jax_blend):
    """A fault of the JAX package that the port keeps (ROADMAP.md, Queue
    3): the explicit step is unstable where the mask exceeds about 0.73,
    and at the default 1024 iterations on a 256 px pair (the JAX test's,
    scaled) neither device blend has a finite value left. The 128 px
    pair stays finite (its mask is too small a region to grow)."""
    t01, s01, m01 = _blend_inputs(256)
    want = np.asarray(jax_blend(*(jnp.asarray(a, jnp.float32)
                                  for a in (t01, s01, m01)), iters=1024))
    got = tswap.poisson_blend(*(torch.from_numpy(a).to(torch.float32)
                                for a in (t01, s01, m01)), iters=1024)
    assert not np.isfinite(want).any()
    assert not torch.isfinite(got).any()
    small = np.asarray(jax_blend(*(jnp.asarray(a, jnp.float32)
                                   for a in _blend_inputs(128)), iters=1024))
    assert np.isfinite(small).all()


@pytest.mark.parametrize("iters", [8, 32])
def test_prepare_swap_batch_poisson_matches_jax(iters):
    """The Poisson composite of `prepare_swap_batch` against the JAX
    package's on a batch of two (the other streams are held by
    tests/test_torch_warp.py)."""
    s_img, s_lms, t_img, t_lms = _jax_pair(64)
    args = [np.stack([a, a]) for a in (s_img, s_lms, t_img, t_lms)]
    want = jswap.prepare_swap_batch(*(jnp.asarray(a) for a in args),
                                    poisson=True, poisson_iters=iters)
    got = tswap.prepare_swap_batch(*(torch.from_numpy(a) for a in args),
                                   poisson=True, poisson_iters=iters)
    np.testing.assert_allclose(got["combined"].numpy(),
                               np.asarray(want["combined"]), atol=4e-4)
    paste = tswap.prepare_swap_batch(*(torch.from_numpy(a) for a in args))
    assert not torch.allclose(got["combined"], paste["combined"])


# -- the swap command line against the JAX functions -------------------------


@pytest.fixture(scope="module")
def swap_setup(tmp_path_factory):
    """A dataset of two 12-frame videos at 32 px, the JAX model's weights
    at narrow widths saved as a port checkpoint, and the JAX model's
    jitted forward."""
    root = tmp_path_factory.mktemp("swap")
    tsyn.generate_dataset(str(root / "data"), 2, N_FRAMES, SIZE, seed=3)
    jmodel = JaxVQVAE(in_channels=6, **WIDTHS, dtype=jnp.float32,
                      use_pallas=False)
    variables = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, 2, SIZE, SIZE, 6)), train=False))(
            jax.random.key(0))
    model = VQVAE(ModelConfig(**WIDTHS), dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(variables["params"],
                                             variables["vq"]), strict=True)
    state = create_train_state(model)
    state.step = 5
    CheckpointManager(str(root / "ckpt")).save(5, state)

    @jax.jit
    def forward(x):
        return jmodel.apply(variables, x, train=False)[0][..., :3]

    return root, forward


def _swap(root, name, *extra):
    argv = ["--source", str(root / "data" / "video_000"),
            "--target", str(root / "data" / "video_001"),
            "--checkpoint_dir", str(root / "ckpt"),
            "--out", str(root / f"{name}.avi"), "--size", str(SIZE),
            "--chunk", str(CHUNK), *NARROW, *extra]
    return tcli.main(argv, device="cpu")


def _jax_streams(root, device_pipeline):
    """The JAX package's source and background streams of the two videos:
    `prepare_swap_batch` in chunks of CHUNK (the tail padded with zeros),
    or `generate_warped_image` per frame pair."""
    frames = [[load_frame(p, SIZE) for p in
               _landmark_paths(str(root / "data" / v))]
              for v in ("video_000", "video_001")]
    (s_img, s_lms), (t_img, t_lms) = (
        (np.stack([f[0] for f in v]), np.stack([f[1] for f in v]))
        for v in frames)
    if not device_pipeline:
        outs = [jgeom.generate_warped_image(s_lms[i], t_lms[i], s_img[i],
                                            t_img[i]) for i in range(N_FRAMES)]
        return (np.stack([jnormalize(o["source_face_transformed"])
                          for o in outs]),
                np.stack([jnormalize(o["target_without_face_features"])
                          for o in outs]))
    src, bg = [], []
    for i in range(0, N_FRAMES, CHUNK):
        args = [a[i: i + CHUNK] for a in (s_img, s_lms, t_img, t_lms)]
        keep = len(args[0])
        args = [np.pad(a, ((0, CHUNK - keep),) + ((0, 0),) * (a.ndim - 1))
                for a in args]
        out = jswap.prepare_swap_batch(*(jnp.asarray(a) for a in args))
        src.append(np.asarray(out["source"])[:keep])
        bg.append(np.asarray(out["background"])[:keep])
    return np.concatenate(src), np.concatenate(bg)


def _jax_chunked(forward, sources, backgrounds):
    """The JAX eval forward over chunks of CHUNK frames, as the JAX CLI's
    `_run_chunked`."""
    frames = []
    for i in range(0, N_FRAMES, CHUNK):
        x = np.concatenate([sources[i: i + CHUNK], backgrounds[i: i + CHUNK]],
                           axis=-1)
        keep = len(x)
        x = np.pad(x, ((0, CHUNK - keep), (0, 0), (0, 0), (0, 0)))
        out = np.asarray(forward(jnp.asarray(x[None])))[0, :keep]
        frames += [denormalize(f) for f in out]
    return frames


@pytest.mark.parametrize("device_pipeline", [False, True])
def test_swap_cli_matches_jax(swap_setup, device_pipeline):
    """The CLI's streams against the JAX package's (host geometry, or
    `prepare_swap_batch` in chunks), and its swapped frames against the
    JAX eval forward of the JAX streams on the same weights."""
    root, forward = swap_setup
    extra = ["--device_pipeline"] if device_pipeline else []
    res = _swap(root, "dp" if device_pipeline else "host", *extra)
    want_src, want_bg = _jax_streams(root, device_pipeline)
    np.testing.assert_allclose(np.stack(res["sources"]), want_src, atol=1e-4)
    np.testing.assert_allclose(np.stack(res["backgrounds"]), want_bg,
                               atol=1e-4)
    assert res["step"] == 5 and len(res["frames"]) == N_FRAMES
    _close(np.stack(res["frames"]),
           np.stack(_jax_chunked(forward, want_src, want_bg)), **FRAMES)


def test_swap_cli_streaming_matches_chunked(swap_setup):
    """--streaming, one frame a call and four, against the chunked frames
    on the frames with the same temporal neighbours in both (the first
    chunk's, away from its end: the chunked run sees each chunk as a clip
    of its own); the latencies are recorded per emitted frame."""
    root, _ = swap_setup
    chunked = _swap(root, "c")["frames"]
    same = [f for f in range(CHUNK) if f + 3 < CHUNK]  # the postnets' reach
    for extra in ([], ["--frames_per_call", "4"]):
        res = _swap(root, "s", "--streaming", *extra)
        assert len(res["frames"]) == N_FRAMES
        assert len(res["latency_ms"]) == N_FRAMES - 3  # less the delay
        _close(np.stack([res["frames"][f] for f in same]),
               np.stack([chunked[f] for f in same]), max_levels=1,
               max_share=1.0)


def test_swap_cli_writes_streams_and_refuses_mp4(swap_setup, capsys):
    """The .mp4 names of the JAX CLI: the swapped video and its three
    streams are mp4v that the JAX package (cv2) reads as the port decodes
    them, bit for bit, and the swapped video is the port's encoder's
    reconstruction of the swapped frames bit for bit; another suffix is
    refused."""
    from faceoff_tpu.io.video import read_video_frames as jread
    from faceoff_tpu_torch.io import mpeg4
    root, _ = swap_setup
    res = _swap(root, "streams", "--device_pipeline", "--blend", "poisson",
                "--poisson_iters", "4", "--save_streams", "--max_frames", "10",
                "--out", str(root / "streams.mp4"))
    for suffix in ("", "_composite", "_background", "_naive_poisson"):
        path = str(root / f"streams{suffix}.mp4")
        frames = read_video_frames(path, device="cpu")
        assert frames.shape == (10, SIZE, SIZE, 3)
        cv = np.stack(jread(path))
        assert cv.shape == (10, SIZE, SIZE, 3)
        np.testing.assert_array_equal(cv, frames.numpy())
    *_, recon = mpeg4.encode(torch.from_numpy(np.stack(res["frames"])), 25,
                             return_recon=True)
    assert torch.equal(read_video_frames(str(root / "streams.mp4"),
                                         device="cpu"), recon)
    assert res["naive_nonfinite_share"] == 0.0  # 4 iterations stay finite
    with pytest.raises(SystemExit) as exc:
        _swap(root, "x", "--out", str(root / "x.mkv"))
    assert exc.value.code == 2
    assert ".mp4" in capsys.readouterr().err
    assert not os.path.exists(root / "x.mkv")


def test_swap_parser_matches_jax_but_the_video_name():
    def options(parser):
        return {s: a.default for a in parser._actions for s in
                a.option_strings if s not in ("-h", "--help")}

    got, want = options(tcli.build_parser()), options(jcli_swap.build_parser())
    assert want["--out"] == "swapped.mp4"
    assert got == want
