"""The port's small model-side modules against the JAX package's, float32
on the CPU, from the same weights (carried by `io.convert`'s bridges,
which must carry them back unchanged) and inputs made with numpy from a
seed: `l1_loss`, the contrastive loss and `SiameseFaceEmbedder` (train
and eval, BatchNorm averages after a train call), `textured_background`,
`discover_lpips_weights` over monkeypatched paths, `AlignmentNet`, three
alignment steps, and the alignment CLI.

Tolerances: the losses within 1e-6 relative (one float32 mean); the
embedder's distance and the alignment outputs within 1e-5 of their
largest magnitude (float32 convolutions and Dense layers summed in
another order); BatchNorm averages rtol 1e-5 atol 1e-6; three Adam steps'
parameters within 1e-5 absolute (a parameter moves by at most lr per
step; what differs is rounding that Adam's normalised update can
magnify to a fraction of lr where a gradient is near zero: 1e-5 = lr /
30 at lr 3e-4); textured_background within 1 level, on at most 1e-4
of the values (the port's INTER_CUBIC resize rounds as cv2 does, but a
sum can land on the other side of a half: 0-4 values of 196,608 at
256 px over seeds 0-7, none at 32 and 64 px)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faceoff_tpu.data import synthetic as jsyn
from faceoff_tpu.losses import contrastive as JC
from faceoff_tpu.losses.reconstruction import l1_loss as j_l1
from faceoff_tpu.models import lpips as JL
from faceoff_tpu.models.alignment import AlignmentNet as JAlign
from faceoff_tpu.train.alignment import (create_alignment_state as j_state,
                                         make_alignment_step as j_step)
from faceoff_tpu_torch.data import synthetic as tsyn
from faceoff_tpu_torch.io.convert import (alignment_from_jax_variables,
                                          alignment_to_jax_variables,
                                          contrastive_from_jax_variables,
                                          contrastive_to_jax_variables)
from faceoff_tpu_torch.losses import contrastive as TC
from faceoff_tpu_torch.losses import l1_loss
from faceoff_tpu_torch.models import lpips as TL
from faceoff_tpu_torch.models.alignment import AlignmentNet
from faceoff_tpu_torch.train.alignment import (create_alignment_state,
                                               make_alignment_step)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, rel=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _tree_close(a, b, **kw):
    fa = jax.tree_util.tree_leaves_with_path(a)
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(fa) == len(fb)
    for path, v in fa:
        np.testing.assert_allclose(np.asarray(v), np.asarray(fb[path]), **kw)


def test_l1_loss_matches_jax():
    a, b = _x((2, 3, 8, 8, 3), 1), _x((2, 3, 8, 8, 3), 2)
    got = float(l1_loss(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(j_l1(jnp.asarray(a), jnp.asarray(b)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("margin", [2.0, 0.5])
def test_contrastive_loss_matches_jax(margin):
    e1, e2 = _x((6, 5), 3), _x((6, 5), 4)
    label = (np.arange(6) % 2).astype(np.float32)
    got = float(TC.contrastive_loss(torch.from_numpy(e1), torch.from_numpy(e2),
                                    torch.from_numpy(label), margin))
    want = float(JC.contrastive_loss(jnp.asarray(e1), jnp.asarray(e2),
                                     jnp.asarray(label), margin))
    assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(
        TC.pairwise_distance(torch.from_numpy(e1), torch.from_numpy(e2)),
        JC.pairwise_distance(jnp.asarray(e1), jnp.asarray(e2)), rtol=1e-6)


@pytest.mark.parametrize("channels", [None, 3])
def test_siamese_embedder_matches_jax(channels):
    """Eval and train mode; in train mode the two tower calls each advance
    the BatchNorm averages, which must end as Flax's batch_stats."""
    size, shape = 12, (4, 12, 12) + ((channels,) if channels else ())
    x1, x2 = _x(shape, 5), _x(shape, 6)
    jm = JC.SiameseFaceEmbedder(features=(3, 4, 4), embed_dim=5, hidden=16)
    variables = jax.jit(lambda k, a, b: jm.init(k, a, b))(
        jax.random.key(1), jnp.asarray(x1), jnp.asarray(x2))
    tm = TC.SiameseFaceEmbedder((3, 4, 4), 5, 16, image_size=size,
                                in_channels=channels or 1, device="cpu")
    sd = contrastive_from_jax_variables(variables)
    tm.load_state_dict(sd, strict=True)
    _tree_close(contrastive_to_jax_variables(tm.state_dict()),
                jax.tree_util.tree_map(np.asarray, dict(variables)),
                rtol=0, atol=0)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    with torch.no_grad():
        _close(tm(t1, t2), jm.apply(variables, jnp.asarray(x1),
                                    jnp.asarray(x2)))
        got = tm(t1, t2, train=True)
    want, upd = jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2),
                         train=True, mutable=["batch_stats"])
    _close(got, want)
    stats = contrastive_to_jax_variables(tm.state_dict())["batch_stats"]
    _tree_close(stats, jax.tree_util.tree_map(np.asarray,
                                              dict(upd["batch_stats"])),
                rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size,seed", [(32, 0), (64, 7), (256, 3)])
def test_textured_background_matches_jax(size, seed):
    got = tsyn.textured_background(np.random.default_rng(seed), size)
    want = jsyn.textured_background(np.random.default_rng(seed), size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


# -- LPIPS weight discovery ------------------------------------------------


@pytest.fixture
def probe_env(tmp_path, monkeypatch):
    """HOME, TORCH_HOME, the cwd and FACEOFF_LPIPS_WEIGHTS under tmp."""
    home, torch_home, cwd = (tmp_path / n for n in ("home", "th", "cwd"))
    for d in (home, torch_home / "hub" / "checkpoints", cwd):
        d.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("TORCH_HOME", str(torch_home))
    monkeypatch.delenv("FACEOFF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.chdir(cwd)
    return home, torch_home / "hub" / "checkpoints", cwd


def _fake_checkpoint(path, lin=True, seed=0):
    """A small LPIPS-layout (or bare VGG16) state dict of random tensors."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for idx, name in TL._VGG16_CONV_IDS:
        b, _ = name[4:].split("_")
        cout = TL._CHNS[int(b) - 1]
        cin = 3 if idx == 0 else (TL._CHNS[int(b) - 2] if name.endswith("_1")
                                  else cout)
        w, bias = torch.randn(cout, cin, 3, 3, generator=g), torch.randn(cout)
        if lin:
            key = f"net.slice{TL._slice_of(idx)}.{idx}"
        else:
            key = f"features.{idx}"
        sd[f"{key}.weight"], sd[f"{key}.bias"] = w, bias
    if lin:
        for k, c in enumerate(TL._CHNS):
            sd[f"lin{k}.model.1.weight"] = torch.randn(1, c, 1, 1, generator=g)
    torch.save(sd, path)
    return sd


def test_discover_lpips_weights_none_found(probe_env, capsys):
    assert TL.discover_lpips_weights() is None
    assert JL.discover_lpips_weights() is None
    out = capsys.readouterr().out
    assert out.count("RANDOM VGG") == 2
    assert TL.resolve_lpips_weights("auto") is None
    assert TL.resolve_lpips_weights("w.npz") == "w.npz"


def test_discover_lpips_weights_search_order(probe_env, monkeypatch):
    """The env variable beats the cwd, which beats the cache, which beats
    the torch cache; both packages pick the same file."""
    home, hub, cwd = probe_env
    cache = home / ".cache" / "faceoff_tpu"
    cache.mkdir(parents=True)
    for d in (hub, cache, cwd):
        np.savez(d / ("vgg.npz" if d == hub else "lpips_weights.npz"), a=0)
    np.savez(hub.parent.parent / "env.npz", a=0)
    monkeypatch.setenv("FACEOFF_LPIPS_WEIGHTS", str(hub.parent.parent / "env.npz"))
    order = [str(hub.parent.parent / "env.npz"), str(cwd / "lpips_weights.npz"),
             str(cache / "lpips_weights.npz")]
    for want in order:
        assert TL.discover_lpips_weights(verbose=False) == want
        assert JL.discover_lpips_weights(verbose=False) == want
        os.remove(want)
        if want.endswith("env.npz"):
            monkeypatch.delenv("FACEOFF_LPIPS_WEIGHTS")
    assert TL.discover_lpips_weights(verbose=False) is None


@pytest.mark.parametrize("lin,where", [(True, "cwd"), (False, "torch_hub")])
def test_discover_lpips_weights_converts_pth(probe_env, lin, where):
    """A fake vgg.pth (full LPIPS) in the cwd or a bare VGG16 in the torch
    cache is converted, cached under ~/.cache/faceoff_tpu, and matches the
    JAX package's converter array for array; the trunk-only one is
    reported as such."""
    home, hub, cwd = probe_env
    path = (cwd / "vgg.pth") if where == "cwd" else (hub / "vgg16-397923af.pth")
    _fake_checkpoint(path, lin=lin)
    got = TL.discover_lpips_weights(verbose=False)
    cache = home / ".cache" / "faceoff_tpu" / "lpips_weights.npz"
    assert got == str(cache)
    assert TL.lpips_weights_trunk_only(got) is (not lin)
    mine = dict(np.load(got))
    os.remove(got)
    assert JL.discover_lpips_weights(verbose=False) == str(cache)
    theirs = dict(np.load(cache))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k
    model = TL.init_lpips(weights_npz=got, device="cpu")
    assert torch.equal(model.vgg.convs["conv1_1"].weight,
                       torch.from_numpy(mine["vgg/conv1_1/kernel"]
                                        ).permute(3, 2, 0, 1))


def test_discover_lpips_weights_skips_unreadable(probe_env, capsys):
    _, _, cwd = probe_env
    (cwd / "vgg.pth").write_bytes(b"not a checkpoint")
    assert TL.discover_lpips_weights() is None
    assert "could not convert" in capsys.readouterr().out


# -- the alignment network -------------------------------------------------


WIDTHS = (4, 8, 8)


def _alignment_pair(size=16, seed=0):
    x = _x((2, size, size, 6), seed)
    jm = JAlign(widths=WIDTHS, dtype=jnp.float32)
    variables = jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(x))
    tm = AlignmentNet(widths=WIDTHS, device="cpu")
    tm.load_state_dict(alignment_from_jax_variables(variables["params"]),
                       strict=True)
    return jm, variables, tm, x


def test_alignment_net_matches_jax():
    jm, variables, tm, x = _alignment_pair()
    assert tm.dtype == torch.float32  # the CPU's compute dtype
    _tree_close(alignment_to_jax_variables(tm.state_dict()),
                jax.tree_util.tree_map(np.asarray, dict(variables["params"])),
                rtol=0, atol=0)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    _close(got, jm.apply(variables, jnp.asarray(x)))


def test_alignment_steps_match_jax():
    """Three MSE + Adam steps on (B 2, T 2) clips folded into the batch."""
    jm, variables, tm, x = _alignment_pair(seed=1)
    rng = np.random.default_rng(9)
    batches = [{"input": rng.normal(size=(2, 2, 16, 16, 6)).astype(np.float32),
                "transforms": (rng.normal(size=(2, 2, 3)) * 5).astype(np.float32)}
               for _ in range(3)]
    jstate = j_state(jm, jax.random.key(1), jnp.asarray(x))
    jstate = jstate.replace(params=variables["params"],
                            opt_state=jstate.tx.init(variables["params"]))
    jfn = j_step(jm, donate=False)
    tstate = create_alignment_state(tm)
    tfn = make_alignment_step(tm)
    for b in batches:
        jstate, jm_ = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm_ = tfn(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "mae_rotation", "mae_tx", "mae_ty"):
            assert float(tm_[k]) == pytest.approx(float(jm_[k]), rel=1e-5)
    assert tstate.step == int(jstate.step) == 3
    _tree_close(alignment_to_jax_variables(tm.state_dict()),
                jax.tree_util.tree_map(np.asarray, dict(jstate.params)),
                rtol=0, atol=1e-5)
    assert isinstance(jstate.tx, optax.GradientTransformation)


def test_train_alignment_cli_two_steps(tmp_path):
    from faceoff_tpu_torch.cli import train_alignment
    from faceoff_tpu_torch.io.checkpoint import CheckpointManager

    root = tsyn.generate_dataset(str(tmp_path / "ds"), n_videos=2,
                                 n_frames=6, size=32)
    metrics = tmp_path / "m.jsonl"
    out = train_alignment.main(
        ["--data_root", root, "--size", "32", "--frames", "2", "--steps", "2",
         "--log_every", "1", "--num_workers", "1", "--widths", "4", "8",
         "--checkpoint_dir", str(tmp_path / "ck"), "--metrics_path",
         str(metrics)], device="cpu")
    assert out["steps"] == 2 and out["state"].step == 2
    assert np.isfinite(out["first"]["loss"]) and np.isfinite(out["last"]["loss"])
    ck = CheckpointManager(str(tmp_path / "ck"))
    assert ck.latest_step() == 2
    payload = ck.restore_tree()
    assert payload["step"] == 2 and "convs.0.weight" in payload["model"]
    assert len(metrics.read_text().splitlines()) == 2
