"""The port's Fréchet distances and evaluation command line against the
JAX package on the CPU (`faceoff_tpu/evaluation/frechet.py`,
`faceoff_tpu/cli/evaluate.py`), float32, the LPIPS weights carried across
by `io.convert.lpips_from_jax_variables`.

Tolerances:
  * features: the VGG16 trunk in float32 on both sides, convolutions
    summed in other orders: 1e-5 of values up to about 2;
  * distances of clouds with more points than dimensions (N > D): two
    float32 eigendecompositions (LAPACK on both sides) of well-conditioned
    covariances, each eigenvalue within a few D u of the largest
    (u = 2^-24): 1e-4 relative;
  * `make_fd_video` on clips of fewer frames than D = 320 dimensions
    (max_dim 64): the covariances have rank N - 1, and the D - N + 1
    eigenvalues that are zero come out of each eigendecomposition as
    rounding noise of about D u |A| (A the matrix whose root is taken),
    whose square roots, clipped at 0, enter the trace. Each such root is
    at most sqrt(D u |A|), and the distance takes two roots (sqrt(cov1),
    then the cross term's, weighted 2), so the two packages may differ by
    up to 2 (D - N + 1) sqrt(D u |A|) with |A| = |cov1| |cov2|; the test
    computes that bound from the covariances.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.cli import evaluate as jcli_eval
from faceoff_tpu.evaluation import frechet as jf
from faceoff_tpu.models.lpips import LPIPS as JaxLPIPS
from faceoff_tpu_torch.cli import evaluate as tcli_eval
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data.synthetic import generate_dataset
from faceoff_tpu_torch.evaluation import frechet as tf
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.io.convert import lpips_from_jax_variables
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models.lpips import LPIPS
from faceoff_tpu_torch.train.state import create_train_state

U32 = 2.0 ** -24
NARROW = ["--channel", "16", "--n_res_channel", "8", "--embed_dim", "8",
          "--n_embed", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lpips_pair():
    """The JAX package's random LPIPS variables and the port's LPIPS with
    the same weights, float32."""
    # init_lpips's variables, the init jitted (eager init takes seconds)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = jax.jit(lambda key: JaxLPIPS().init(key, dummy, dummy))(
        jax.random.key(0))
    model = LPIPS()
    model.load_state_dict(lpips_from_jax_variables(variables["params"]),
                          strict=False)
    return variables, model.eval()


def _clips(seed, b=4, t=8, hw=32):
    """Smooth synthetic clips in [-1, 1]: a drifting gradient and noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.5, 0.5, (b, 1, hw, hw, 3))
    drift = np.linspace(0, 0.4, t)[None, :, None, None, None]
    return np.clip(base + drift + 0.02 * rng.normal(size=(b, t, hw, hw, 3)),
                   -1, 1).astype(np.float32)


def test_distances_match_jax_with_more_points_than_dimensions():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 64)).astype(np.float32)
    y = (1.3 * x + 0.2 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    got = float(tf.fid(torch.from_numpy(x), torch.from_numpy(y)))
    want = float(jf.fid(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    mu_t, cov_t = tf.feature_stats(torch.from_numpy(x))
    mu_j, cov_j = jf.feature_stats(jnp.asarray(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-6)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), atol=1e-5)
    a = rng.normal(size=(12, 12))
    b = rng.normal(size=(12, 12))
    c1 = (a @ a.T / 12).astype(np.float32)
    c2 = (b @ b.T / 12).astype(np.float32)
    m1, m2 = rng.normal(size=(2, 12)).astype(np.float32)
    got = float(tf.frechet_distance(*(torch.from_numpy(v)
                                      for v in (m1, c1, m2, c2))))
    want = float(jf.frechet_distance(*(jnp.asarray(v)
                                       for v in (m1, c1, m2, c2))))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_properties_of_the_jax_tests():
    """tests/test_frechet.py's: identical Gaussians give 0, the diagonal
    case its closed form, a larger mean shift a larger distance."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(500, 8)).astype(np.float32))
    assert abs(float(tf.fid(x, x))) < 1e-3
    mu1, mu2 = torch.zeros(4), torch.full((4,), 2.0)
    v1 = torch.tensor([1.0, 2.0, 3.0, 4.0])
    v2 = torch.tensor([4.0, 3.0, 2.0, 1.0])
    got = float(tf.frechet_distance(mu1, torch.diag(v1), mu2, torch.diag(v2)))
    want = float(torch.sum((mu1 - mu2) ** 2)
                 + torch.sum((v1.sqrt() - v2.sqrt()) ** 2))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert float(tf.fid(x, x + 0.5)) < float(tf.fid(x, x + 3.0))


def test_vgg_features_match_jax_in_float32(lpips_pair):
    """The features of the float32 trunk against the JAX package's, in
    chunks and whole; an LPIPS module held in bf16 gives the features of
    a float32 trunk with its (rounded) weights, not bf16 features."""
    variables, model = lpips_pair
    frames = torch.from_numpy(_clips(1).reshape(-1, 32, 32, 3))
    want = np.asarray(jax.jit(lambda v: jf.vgg_features(variables, v))(
        jnp.asarray(frames.numpy())))
    got = tf.vgg_features(model, frames)
    assert got.shape == (32, 64 + 64 + 64 + 64 + 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tf.vgg_features(model, frames, chunk=5).numpy(),
                               want, atol=1e-5)
    assert tf.vgg_features(model, frames, max_dim=8).shape == (32, 40)

    half = LPIPS(torch.bfloat16)
    half.load_state_dict(model.state_dict())
    rounded = LPIPS()
    rounded.load_state_dict(half.state_dict())
    out = tf.vgg_features(half, frames)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  tf.vgg_features(rounded, frames).numpy())


def test_make_fd_video_matches_jax(lpips_pair):
    """fd_vgg and fd_vgg_motion on 4 clips of 8 frames (32 frames, 28
    differences, fewer than D = 320), within the derived bound (module
    docstring); the accumulated form over two batches equals one batch
    (the JAX package's multi-batch property)."""
    variables, model = lpips_pair
    real, fake = _clips(2), _clips(3)
    fake = np.clip(fake + 0.3 * np.random.default_rng(4).normal(
        size=fake.shape), -1, 1).astype(np.float32)
    want = {k: float(v) for k, v in jax.jit(jf.make_fd_video(variables))(
        jnp.asarray(real), jnp.asarray(fake)).items()}
    t_real, t_fake = torch.from_numpy(real), torch.from_numpy(fake)
    got = {k: float(v) for k, v in tf.make_fd_video(model)(t_real,
                                                          t_fake).items()}
    assert sorted(got) == sorted(want) == ["fd_vgg", "fd_vgg_motion"]
    feats = {"fd_vgg": (tf.vgg_features(model, t_real.reshape(-1, 32, 32, 3)),
                        tf.vgg_features(model, t_fake.reshape(-1, 32, 32, 3))),
             "fd_vgg_motion": (tf.motion_features(model, t_real),
                               tf.motion_features(model, t_fake))}
    for k, (fr, ff) in feats.items():
        n, d = fr.shape
        norms = [np.linalg.eigvalsh(np.cov(f.numpy().T.astype(np.float64)))
                 .max() for f in (fr, ff)]
        bound = 2 * (d - n + 1) * np.sqrt(d * U32 * norms[0] * norms[1])
        assert abs(got[k] - want[k]) <= bound, (k, got[k], want[k], bound)

    feat_fn, finalize = tf.make_fd_video_features(model)
    chunks = [feat_fn(t_real[:2], t_fake[:2]), feat_fn(t_real[2:], t_fake[2:])]
    split = {k: float(v) for k, v in finalize(chunks).items()}
    whole = {k: float(v) for k, v in finalize([feat_fn(t_real,
                                                       t_fake)]).items()}
    assert split == whole == got


def test_motion_distance_detects_temporal_corruption(lpips_pair):
    """tests/test_frechet.py's: shuffled frames leave the per-frame
    distance at its noise floor and move the motion distance."""
    _, model = lpips_pair
    real = _clips(3)
    shuffled = real[:, np.random.default_rng(3).permutation(8)]
    fd = tf.make_fd_video(model)
    same = {k: float(v) for k, v in fd(torch.from_numpy(real),
                                       torch.from_numpy(real)).items()}
    assert abs(same["fd_vgg"]) < 0.05 and abs(same["fd_vgg_motion"]) < 0.05
    shuf = {k: float(v) for k, v in fd(torch.from_numpy(real),
                                       torch.from_numpy(shuffled)).items()}
    assert abs(shuf["fd_vgg"]) < 0.05
    assert shuf["fd_vgg_motion"] > 0.2
    assert shuf["fd_vgg_motion"] > 10 * abs(shuf["fd_vgg"])


# -- the evaluation command line on the CPU ------------------------------


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    generate_dataset(str(root / "data"), 3, 6, 32, seed=5)
    model = VQVAE(ModelConfig(channel=16, n_res_channel=8, embed_dim=8,
                              n_embed=16), dtype=torch.float32, device="cpu")
    state = create_train_state(model)
    state.step = 3
    CheckpointManager(str(root / "ckpt")).save(3, state)
    return root


def _evaluate(root, *extra):
    return tcli_eval.main(["--data_root", str(root / "data"),
                           "--checkpoint_dir", str(root / "ckpt"),
                           "--size", "32", "--frames", "4",
                           "--num_workers", "2", *NARROW, *extra],
                          device="cpu")


@pytest.mark.parametrize("extra,keys", [
    ([], ["mse", "l1", "psnr", "ssim", "lpips_random_vgg"]),
    (["--crossid"], ["fd_vgg_random_vgg", "fd_vgg_motion_random_vgg"]),
    (["--crossid", "--naive_baseline", "poisson"],
     ["fd_vgg_random_vgg", "fd_vgg_motion_random_vgg",
      "fd_vgg_naive_poisson_random_vgg",
      "fd_vgg_motion_naive_poisson_random_vgg"])])
def test_evaluate_cli_reports(eval_setup, capsys, extra, keys):
    """One JSON line with the JAX CLI's keys, tagged _random_vgg without
    LPIPS weights, every value finite."""
    rep = _evaluate(eval_setup, *extra)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == rep
    assert sorted(rep) == sorted(keys + ["n_clips", "checkpoint_step"])
    assert rep["n_clips"] == 3 and rep["checkpoint_step"] == 3
    assert all(np.isfinite(rep[k]) for k in keys)


def test_evaluate_cli_tags_trunk_only_weights_and_refuses_auto(
        eval_setup, lpips_pair, capsys, monkeypatch):
    """An .npz with the VGG trunk and no lin heads tags the metric
    _untrained_lin; --lpips_weights auto exits naming its ROADMAP item;
    the parser has the options and defaults of the JAX CLI's (which
    builds it inside main: caught at its parse)."""
    import argparse

    variables, _ = lpips_pair
    arrays = {f"vgg/{name}/{leaf}": np.asarray(v)
              for name, conv in variables["params"]["vgg"].items()
              for leaf, v in conv.items()}
    npz = eval_setup / "trunk.npz"
    np.savez(npz, **arrays)
    rep = _evaluate(eval_setup, "--lpips_weights", str(npz))
    assert "lpips_untrained_lin" in rep and "lpips_random_vgg" not in rep
    with pytest.raises(SystemExit) as exc:
        _evaluate(eval_setup, "--lpips_weights", "auto")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and "Queue 1 item 7" in err

    caught = []

    def catch(parser, args=None, namespace=None):
        caught.append(parser)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(SystemExit):
        jcli_eval.main([])
    monkeypatch.undo()

    def options(parser):
        return {s: a.default for a in parser._actions for s in
                a.option_strings if s not in ("-h", "--help")}

    assert options(tcli_eval.build_parser()) == options(caught[0])
