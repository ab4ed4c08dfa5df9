"""The port's training input against the JAX package, float32 on the CPU:
the perturbation grid build given the same draws, the draw's own
distribution, `prepare_train_batch` and `sample_clip_windows` given the
same draws, the resident corpus and the warp's gradients.

JAX's PRNG cannot be replayed in torch, so each test draws with JAX's
keys exactly as the JAX function does and hands the draws to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.data import device_pipeline as jdp
from faceoff_tpu.data import resident as jres
from faceoff_tpu.ops import warp as JW
from faceoff_tpu_torch.data import device_pipeline as tdp
from faceoff_tpu_torch.data import resident as tres
from faceoff_tpu_torch.data.synthetic import synthetic_corpus
from faceoff_tpu_torch.ops import warp as TW


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_perturb_draws(key, t, translation_range=3, rotation_range=3.0,
                      scale_range=(90, 110)):
    """The draws of faceoff_tpu.ops.warp.perturb_clip for `key`, in the
    port's naming (the same keys, calls and order as that function)."""
    keys = jax.random.split(key, 11)
    ri = jax.random.randint
    tr, rr = translation_range, int(rotation_range)
    draws = {
        "subset": ri(keys[0], (t,), 1, 32),
        "tx": ri(keys[1], (t,), -tr, tr + 1).astype(jnp.float32),
        "ty": ri(keys[2], (t,), -tr, tr + 1).astype(jnp.float32),
        "rot": ri(keys[3], (t,), -rr, rr + 1).astype(jnp.float32),
        "scale": ri(keys[4], (t,), scale_range[0], scale_range[1] + 1)
        .astype(jnp.float32) / 100.0,
        "kind": ri(keys[5], (t,), 0, 3),
        "arc_angle": ri(keys[6], (t,), 0, 31).astype(jnp.float32),
        "barrel_a": ri(keys[7], (t,), 0, 11).astype(jnp.float32) / 10,
        "barrel_b": ri(keys[8], (t,), 2, 8).astype(jnp.float32) / 10,
        "barrel_c": ri(keys[9], (t,), 0, 6).astype(jnp.float32) / 10,
        "inverse_bc": ri(keys[10], (t, 2), jnp.array([0, -5]),
                         jnp.array([3, 1])).astype(jnp.float32) / 10,
    }
    return {k: _t(v) for k, v in draws.items()}


def _coordinate_image(t, h, w):
    """Frames whose channels are x, y and 1: bilinear sampling returns the
    sampling coordinates themselves, so the warp shows its grid."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x, y, np.ones_like(x)], -1)
    return np.broadcast_to(img, (t, h, w, 3)).copy()


# one compile of the JAX perturbation per shape, not one per operation
_jax_perturb_clip = jax.jit(
    lambda key, faces, eyes: JW.perturb_clip(key, faces, eyes,
                                             use_pallas=False))


def _mismatch_share(got, ref, atol):
    return float(np.mean(np.abs(got - ref) > atol))


@pytest.mark.parametrize("seed", [0, 1])
def test_perturbation_grid_matches_jax(seed):
    """Given JAX's draws, the port warps coordinate images to the JAX
    output: 256 frames at 40x48 cover every subset and distortion kind.
    The grids come from cos, sin, atan2 and sqrt in float32 on both sides,
    which may round one ulp apart; tolerance 2e-3 px on coordinates up to
    ~50 px (a few ulps through the affine stack). A coordinate within
    rounding of an image edge can flip an inside test and change that
    pixel completely, so up to 0.1% of the values may differ beyond it."""
    t, h, w = 256, 40, 48
    key = jax.random.key(seed)
    faces = _coordinate_image(t, h, w)
    rng = np.random.default_rng(seed)
    eyes = np.stack([rng.uniform(15, 33, t), rng.uniform(12, 28, t)],
                    -1).astype(np.float32)
    ref = np.asarray(_jax_perturb_clip(key, jnp.asarray(faces),
                                       jnp.asarray(eyes)))
    draws = jax_perturb_draws(key, t)
    got = TW.perturb_clip(None, _t(faces), _t(eyes), params=draws).numpy()
    assert got.shape == ref.shape
    assert _mismatch_share(got, ref, 2e-3) <= 1e-3
    assert len(set(draws["subset"].tolist())) == 31
    assert set(draws["kind"].tolist()) == {0, 1, 2}


def test_perturb_clip_matches_jax_on_faces():
    """Random images in [0, 1], the same draws: 1e-5 on all but 0.1% of
    the values (inside tests flipped at an edge, as above)."""
    t, h, w = 64, 32, 32
    key = jax.random.key(3)
    rng = np.random.default_rng(3)
    faces = rng.uniform(0, 1, (t, h, w, 3)).astype(np.float32)
    eyes = rng.uniform(10, 22, (t, 2)).astype(np.float32)
    ref = np.asarray(_jax_perturb_clip(key, jnp.asarray(faces),
                                       jnp.asarray(eyes)))
    got = TW.perturb_clip(None, _t(faces), _t(eyes),
                          params=jax_perturb_draws(key, t)).numpy()
    assert _mismatch_share(got, ref, 1e-5) <= 1e-3


def test_draw_perturbation_distribution():
    """All 31 non-empty subsets occur, each member about half the time,
    and every parameter lies on its integer grid and covers it."""
    d = TW.draw_perturbation(torch.Generator().manual_seed(0), 20000)
    subset = d["subset"]
    assert set(subset.tolist()) == set(range(1, 32))
    for k in range(5):
        share = ((subset >> k) & 1).float().mean().item()
        assert abs(share - 16 / 31) < 0.02

    def grid(v, scale, lo, hi):
        ints = torch.round(v * scale)
        assert torch.allclose(ints, v * scale, atol=1e-4)
        assert set(ints.long().tolist()) == set(range(lo, hi + 1))

    grid(d["tx"], 1, -3, 3)
    grid(d["ty"], 1, -3, 3)
    grid(d["rot"], 1, -3, 3)
    grid(d["scale"], 100, 90, 110)
    grid(d["arc_angle"], 1, 0, 30)
    grid(d["barrel_a"], 10, 0, 10)
    grid(d["barrel_b"], 10, 2, 7)
    grid(d["barrel_c"], 10, 0, 5)
    grid(d["inverse_bc"][:, 0], 10, 0, 2)
    grid(d["inverse_bc"][:, 1], 10, -5, 0)
    assert set(d["kind"].tolist()) == {0, 1, 2}


def test_affine_helpers_match_jax():
    rng = np.random.default_rng(4)
    ang, s = np.float32(2.0), np.float32(1.07)
    c = rng.uniform(5, 20, 2).astype(np.float32)
    m = JW.compose_affine(JW.scale_about_center(s, 30, 40),
                          JW.compose_affine(JW.rotation_about(ang, c),
                                            JW.translation(1.0, -2.0)))
    got = TW.compose_affine(
        TW.scale_about_center(_t(s), 30, 40),
        TW.compose_affine(TW.rotation_about(_t(ang), _t(c)),
                          TW.translation(_t(np.float32(1.0)),
                                         _t(np.float32(-2.0)))))
    np.testing.assert_allclose(got.numpy(), np.asarray(m), rtol=1e-6,
                               atol=1e-5)
    for inverse in (False, True):
        ref = JW.barrel_grid(30, 40, 0.1, 0.3, 0.2, 1.0, inverse=inverse)
        got = TW.barrel_grid(30, 40, 0.1, 0.3, 0.2, 1.0, inverse=inverse)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    ref = JW.arc_grid(30, 40, jnp.float32(17.0))
    got = TW.arc_grid(30, 40, _t(np.float32(17.0)))
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    assert np.mean(got[2].numpy() != np.asarray(ref[2])) <= 1e-3


def _jax_batch_draws(key, b, t, color_jitter):
    """The draws of faceoff_tpu.data.device_pipeline.prepare_train_batch."""
    k_perturb, k_jit = jax.random.split(key)
    draws = {"perturb": jax_perturb_draws(k_perturb, b * t)}
    if color_jitter:
        shape = (b, 1, 1, 1, 1) if color_jitter == "const" else (
            b * t, 1, 1, 1)
        kb, ks = jax.random.split(k_jit)
        draws["brightness"] = _t(jax.random.uniform(kb, shape, minval=1.0,
                                                    maxval=1.5))
        draws["saturation"] = _t(jax.random.uniform(ks, shape, minval=1.0,
                                                    maxval=1.5))
    return draws


@pytest.mark.parametrize("color_jitter", ["", "const", "frame"])
def test_prepare_train_batch_matches_jax(color_jitter):
    """Synthetic faces, the same draws. gt to 1e-6 (XLA turns the division
    by 127.5 into a product with its reciprocal, one ulp apart). The input agrees to 1e-5
    except where the hull masks differ: the port tests each pixel against
    the hull elementwise and JAX as a matmul, which may flip a pixel
    within 1e-4 px of the hull's edge (tests/test_torch_warp.py); each
    flip also moves the warped face there, so up to 0.5% of the values
    may differ beyond 1e-5."""
    b, t, size = 2, 3, 48
    frames, lms, _ = synthetic_corpus(b, t, size, seed=5)
    key = jax.random.key(11)
    ref = jdp.prepare_train_batch(key, jnp.asarray(frames.numpy()),
                                  jnp.asarray(lms),
                                  color_jitter=color_jitter)
    got = tdp.prepare_train_batch(
        None, frames, _t(lms), color_jitter=color_jitter,
        draws=_jax_batch_draws(key, b, t, color_jitter))
    np.testing.assert_allclose(got["gt"].numpy(), np.asarray(ref["gt"]),
                               rtol=0, atol=1e-6)
    assert got["input"].shape == (b, t, size, size, 6)
    assert _mismatch_share(got["input"].numpy(), np.asarray(ref["input"]),
                           1e-5) <= 5e-3


def test_eye_centers_match_jax():
    lms = np.random.default_rng(6).uniform(0, 64, (3, 68, 2)).astype(
        np.float32)
    np.testing.assert_allclose(
        tdp.eye_centers_from_landmarks(_t(lms)).numpy(),
        np.asarray(jdp.eye_centers_from_landmarks(jnp.asarray(lms))),
        rtol=1e-6)


def test_sample_clip_windows_matches_jax():
    """The same video and start draws give the same windows, exactly,
    including a video shorter than the clip (its last frame repeats)."""
    rng = np.random.default_rng(7)
    v, fmax, size = 4, 9, 8
    frames = rng.integers(0, 255, (v, fmax, size, size, 3), dtype=np.uint8)
    lms = rng.uniform(0, size, (v, fmax, 68, 2)).astype(np.float32)
    n_frames = np.array([9, 3, 7, 5], np.int32)
    key = jax.random.key(8)
    clips, clms = jres.sample_clip_windows(
        key, jnp.asarray(frames), jnp.asarray(lms), jnp.asarray(n_frames),
        16, 4)
    kv, ks = jax.random.split(key)
    vids = _t(jax.random.randint(kv, (16,), 0, v))
    u = _t(jax.random.uniform(ks, (16,)))
    assert 1 in vids.tolist()  # the short video is sampled
    got, got_l = tres.sample_clip_windows(
        None, _t(frames), _t(lms), _t(n_frames), 16, 4, vids=vids, u=u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(clips))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(clms))


def test_resident_corpus_and_batches():
    frames, lms, n = synthetic_corpus(3, 5, 32, seed=1)
    corpus = tres.corpus_from_arrays(frames, lms, n, device="cpu")
    assert corpus.n_videos == 3
    assert corpus.nbytes == frames.numel() + lms.size * 4
    assert tres.estimate_corpus_bytes(3, 5, 32) == corpus.nbytes
    with pytest.raises(MemoryError):
        tres.corpus_from_arrays(frames, lms, n, device="cpu",
                                   budget_bytes=1000)
    prep = tres.make_resident_prepare(corpus, 2, 4, color_jitter="const")
    batch = prep(torch.Generator().manual_seed(0), corpus.frames,
                 corpus.landmarks)
    assert batch["input"].shape == (2, 4, 32, 32, 6)
    assert batch["gt"].shape == (2, 4, 32, 32, 3)
    again = prep(torch.Generator().manual_seed(0), corpus.frames,
                 corpus.landmarks)
    assert torch.equal(batch["input"], again["input"])
    loader = tres.ResidentBatches(corpus, steps_per_epoch=7,
                                  steps_per_call=3)
    assert len(loader) == 6 and len(list(loader)) == 2


def test_warp_gradients_match_jax():
    """Gradients of the plain warp as autograd takes them equal JAX's VJP
    of _bilinear_sample (floor flat), the oracle of the backward kernel:
    1e-5."""
    rng = np.random.default_rng(9)
    n, h, w, oh, ow = 2, 10, 12, 7, 9
    imgs = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    xs = rng.uniform(-2, w + 1, (n, oh, ow)).astype(np.float32)
    ys = rng.uniform(-2, h + 1, (n, oh, ow)).astype(np.float32)
    g = rng.normal(size=(n, oh, ow, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: JW.batched_bilinear_warp(
        a, b, c, use_pallas=False), *map(jnp.asarray, (imgs, xs, ys)))
    ref = vjp(jnp.asarray(g))
    args = [_t(a).requires_grad_(True) for a in (imgs, xs, ys)]
    TW.batched_bilinear_warp(*args).backward(_t(g))
    for a, r in zip(args, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), atol=1e-5)
