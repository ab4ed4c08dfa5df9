"""Compute over a clip sharded in time: the port's time-sharded forward,
halo exchange, revive and train step over torch.distributed's gloo
backend on the CPU, against one process and against the JAX package's
time-sharded programs (`tests/test_sharding.py`) on the conftest's
virtual CPU devices, from the same weights (`io/convert.to_jax_variables`).
Narrow widths (channel 16), 32 px; two launches in all.

Launch 1 (`_worker_time2`), two ranks on `make_mesh(data=1, time=2)`:
  * the eval forward at T=2 (one frame a rank) and T=8;
  * the halo exchange's gradient: a postnet on each rank's frame block,
    with and without remat, against autograd through the whole clip;
  * two `make_shardmap_train_step` steps at b1, T=16;
  * `revive_codes` on a b2, T4 batch (each rank 2 clips x 2 frames).
Launch 2 (`_worker_data_time`), four ranks on `make_mesh(data=2, time=2)`:
  * the eval forward of `test_sharding.py:153`'s shape (4, 4, 32, 32, 6);
  * one step with a resident `prepare_fn` and a random-VGG LPIPS: the
    time ranks of a data group prepare the same clips (their data
    group's stream), and the step equals one process's on the two data
    groups' clips.

Tolerances. Forward outputs against JAX rtol 1e-4 atol 1e-4, `diff`
rtol 1e-4 (`test_sharding.py:44`). Gradients through the postnet 1e-5
(float32, the same products summed in another order). Across ranks
bitwise (the same averaged gradients and the same Adam update). Steps
against JAX and one process: losses rtol 1e-5, codebooks rtol 1e-4 atol
1e-5, parameters within 2 lr and 99 % within 1e-6 (the rule of
tests/test_torch_parallel.py). The revive equals one process's on the
global batch within rtol 1e-5 atol 1e-6, as data parallelism's does."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
LR = 1e-3
WIDTHS = dict(channel=16, n_res_channel=8, embed_dim=8, n_embed=16)
STEP_T = 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(worker: str, out: Path, world: int, timeout: float = 240):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(TESTS)!r}); "
         f"import test_torch_time_parallel as t; "
         f"t.{worker}({r}, {world}, {port}, {str(out)!r})"],
        cwd=str(out), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    return [torch.load(out / f"{worker}_{r}.pt", weights_only=False)
            for r in range(world)]


def _join(rank, world, port):
    from faceoff_tpu_torch.parallel import collectives

    torch.set_num_threads(1)
    collectives.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       device="cpu")
    return collectives


def _video(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _batch(seed, b, t, size):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (b, t, size, size, 3)).astype(np.float32)
    bg = rng.uniform(-1, 1, (b, t, size, size, 3)).astype(np.float32)
    return {"input": torch.from_numpy(np.concatenate([gt, bg], -1)),
            "gt": torch.from_numpy(gt)}


def _model(seed=0):
    from faceoff_tpu_torch.config import ModelConfig
    from faceoff_tpu_torch.models import VQVAE

    return VQVAE(ModelConfig(**WIDTHS), dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(seed))


def _state(seed=0):
    from faceoff_tpu_torch.train.state import create_train_state, make_optimizer

    model = _model(seed)
    return create_train_state(model, make_optimizer(model.parameters(), LR))


def _np_sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _forward(model, video):
    with torch.no_grad():
        out, diff = model(torch.from_numpy(video))
    return out.numpy(), float(diff)


def _steps(step, state, batch, n):
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return [_np_sd(state.model), metrics]


def _kill_codes(model):
    """Every top code dead, half of the bottom's."""
    with torch.no_grad():
        model.quantize_t.cluster_size.zero_()
        n = model.quantize_b.cluster_size.numel()
        model.quantize_b.cluster_size[: n // 2] = 0.0


# -- launch 1: two ranks, time=2 ---------------------------------------------


def _worker_time2(rank, world, port, out):
    col = _join(rank, world, port)
    from faceoff_tpu_torch.parallel.mesh import frame_block, make_mesh, shard_batch
    from faceoff_tpu_torch.train.shardmap_step import make_shardmap_train_step
    from faceoff_tpu_torch.train.train_step import make_train_step

    mesh = make_mesh(data=1, time=2)
    assert (mesh.data_index, mesh.time_index) == (0, rank)
    time_group, _ = col.mesh_groups(mesh)
    res = {}
    model = _model()
    res["init"] = _np_sd(model)
    ref = _model() if rank == 0 else None
    model.set_time_group(time_group)

    # the eval forward: one frame a rank, then four
    for t in (2, 8):
        video = _video(t, (1, t, 32, 32, 6))
        res[f"fwd{t}"] = _forward(model, frame_block(
            torch.from_numpy(video), mesh).numpy())
        if rank == 0:
            res[f"fwd{t}_ref"] = _forward(ref, video)

    # the halo exchange's gradient through a postnet's frame block
    post = model.conv3d_encoded_b
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 16, 8, 6, 6), generator=gen)
    g = torch.randn((2, 16, 8, 6, 6), generator=gen)
    grads = []
    for remat in (False, True):
        xl = frame_block(x, mesh, 2).clone().requires_grad_()
        y = post(xl, remat=remat)
        (y * frame_block(g, mesh, 2)).sum().backward()
        grads.append((y.detach().numpy(), xl.grad.numpy()))
    res["halo"] = grads
    if rank == 0:
        post.time_group = None
        xr = x.clone().requires_grad_()
        y = post(xr)
        (y * g).sum().backward()
        res["halo_ref"] = (y.detach().numpy(), xr.grad.numpy())
        post.time_group = time_group

    # two time-sharded steps at T=16
    batch = _batch(1, 1, STEP_T, 32)
    local = shard_batch(batch, mesh, time_axis=1)
    assert local["input"].shape[1] == STEP_T // 2
    state = _state()
    step = make_shardmap_train_step(state.model, mesh,
                                    perceptual_loss_weight=0.0)
    res["steps"] = _steps(step, state, local, 2)
    if rank == 0:
        one = _state()
        res["steps_ref"] = _steps(make_train_step(
            one.model, perceptual_loss_weight=0.0), one, batch, 2)

    # revive: each rank 2 clips x 2 frames of a b2, T4 batch
    rbatch = _batch(5, 2, 4, 32)["input"]
    _kill_codes(state.model)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state.model.revive_codes(frame_block(rbatch, mesh),
                             torch.Generator().manual_seed(5))
    res["revived"] = _np_sd(state.model)
    res["revived_before"] = {k: v.numpy() for k, v in before.items()}
    if rank == 0:
        one = _model()
        one.load_state_dict(before)
        one.revive_codes(rbatch, torch.Generator().manual_seed(5))
        res["revived_ref"] = _np_sd(one)
    torch.save(res, os.path.join(out, f"_worker_time2_{rank}.pt"))
    col.destroy()


# -- launch 2: four ranks, data=2 x time=2 ----------------------------------


DT_CLIP_T = 4


def _worker_data_time(rank, world, port, out):
    col = _join(rank, world, port)
    from faceoff_tpu_torch.data.resident import (corpus_from_arrays,
                                                 make_resident_prepare)
    from faceoff_tpu_torch.data.synthetic import synthetic_corpus
    from faceoff_tpu_torch.models.lpips import init_lpips
    from faceoff_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from faceoff_tpu_torch.train.shardmap_step import make_shardmap_train_step
    from faceoff_tpu_torch.train.train_step import (make_train_step,
                                                    rank_seed, step_seed)

    mesh = make_mesh(data=2, time=2)
    time_group, _ = col.mesh_groups(mesh)
    res = {}
    model = _model()
    res["init"] = _np_sd(model)
    model.set_time_group(time_group)
    video = torch.from_numpy(_video(2, (4, 4, 32, 32, 6)))
    res["fwd"] = _forward(model, shard_batch({"v": video}, mesh,
                                             time_axis=1)["v"].numpy())

    # one step with a prepare function: each data group prepares 1 clip
    frames, lms, n = synthetic_corpus(4, 8, 32, seed=3, device="cpu")
    corpus = corpus_from_arrays(frames, lms, n, device="cpu")
    prepare = make_resident_prepare(corpus, 1, DT_CLIP_T)
    prepared = []

    def recording(gen, f, lm):
        b = prepare(gen, f, lm)
        prepared.append(b["input"].clone())
        return b

    lpips = init_lpips(torch.Generator().manual_seed(1), device="cpu")
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}
    state = _state()
    step = make_shardmap_train_step(state.model, mesh, lpips=lpips,
                                    prepare_fn=recording)
    res["step"] = _steps(step, state, raw, 1)
    res["prepared"] = prepared[0].numpy()
    if rank == 0:
        clips = []
        for d in range(mesh.data):
            gen = torch.Generator().manual_seed(step_seed(rank_seed(0, d), 0))
            with torch.no_grad():
                clips.append(prepare(gen, corpus.frames, corpus.landmarks))
        batch = {k: torch.cat([c[k] for c in clips]) for k in ("input", "gt")}
        one = _state()
        res["step_ref"] = _steps(make_train_step(one.model, lpips=lpips),
                                 one, batch, 1)
    torch.save(res, os.path.join(out, f"_worker_data_time_{rank}.pt"))
    col.destroy()


# -- checks -------------------------------------------------------------------


def _assert_adam_close(got, want, lr, steps, what):
    """Parameters after Adam steps: within 2 lr a step everywhere and 1e-6
    on 99 % of the entries."""
    diffs = []
    for k in want:
        d = np.abs(got[k] - want[k]).ravel()
        assert d.max() <= 2 * lr * steps * (1 + 1e-3) + 1e-6, (what, k,
                                                                d.max())
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d <= 1e-6).mean() >= 0.99, (what, (d <= 1e-6).mean())


def _split(sd):
    """(parameters, codebook buffers) of a VQVAE state dict."""
    cb = ("embed", "cluster_size", "embed_avg")
    return ({k: v for k, v in sd.items() if k.split(".")[-1] not in cb},
            {k: v for k, v in sd.items() if k.split(".")[-1] in cb})


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def _assert_steps_close(got, want, steps, what):
    for mg, mw in zip(got[1], want[1]):
        for k in ("loss", "mse", "latent", "perceptual"):
            assert mg[k] == pytest.approx(mw[k], rel=1e-5, abs=1e-12), (
                what, k)
    gp, gc = _split(got[0])
    wp, wc = _split(want[0])
    _assert_adam_close(gp, wp, LR, steps, what)
    for k in wc:
        np.testing.assert_allclose(gc[k], wc[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {k}")


def _jax_model_vars(init):
    from faceoff_tpu.models import VQVAE as JVQVAE
    from faceoff_tpu.ops.vq import VQCodebook
    from faceoff_tpu_torch.io.convert import to_jax_variables

    params, vq = to_jax_variables({k: torch.from_numpy(v)
                                   for k, v in init.items()})
    vq = {lvl: {"codebook": VQCodebook(**{k: jnp.asarray(v) for k, v in
                                          d["codebook"].items()})}
          for lvl, d in vq.items()}
    jm = JVQVAE(in_channels=6, n_res_block=2, dtype=jnp.float32, **WIDTHS)
    return jm, params, vq


def _jax_forward(init, video, mesh, spec):
    jm, params, vq = _jax_model_vars(init)
    sharded = jax.device_put(jnp.asarray(video), NamedSharding(mesh, spec))
    out, diff = jax.jit(lambda v: jm.apply({"params": params, "vq": vq}, v,
                                           train=False))(sharded)
    return np.asarray(out), float(diff)


@pytest.fixture(scope="module")
def time2(tmp_path_factory):
    return _launch("_worker_time2", tmp_path_factory.mktemp("time2"), 2)


@pytest.fixture(scope="module")
def data_time(tmp_path_factory):
    return _launch("_worker_data_time", tmp_path_factory.mktemp("dt"), 4)


@pytest.mark.parametrize("frames", [2, 8])
def test_time_sharded_forward_matches_jax(time2, devices, frames):
    """Each rank's frame block of the output and the clip's diff, against
    JAX's jit over make_mesh(data=1, time=2) with P(None, 'time') and
    against the port's unsharded forward."""
    from faceoff_tpu.parallel import make_mesh

    r0, r1 = time2
    got = np.concatenate([r0[f"fwd{frames}"][0], r1[f"fwd{frames}"][0]], 1)
    assert r0[f"fwd{frames}"][1] == r1[f"fwd{frames}"][1]
    want, want_diff = _jax_forward(r0["init"], _video(frames, (
        1, frames, 32, 32, 6)), make_mesh(data=1, time=2), P(None, "time"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r0[f"fwd{frames}"][1], want_diff, rtol=1e-4)
    ref, ref_diff = r0[f"fwd{frames}_ref"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r0[f"fwd{frames}"][1], ref_diff, rtol=1e-4)


def test_halo_exchange_gradient_matches_unsharded_postnet(time2):
    """Output and input gradient of the postnet on two frame blocks
    against autograd through the whole clip; remat recomputes the same
    values."""
    y_ref, g_ref = time2[0]["halo_ref"]
    for remat in (0, 1):
        y = np.concatenate([r["halo"][remat][0] for r in time2], 2)
        g = np.concatenate([r["halo"][remat][1] for r in time2], 2)
        np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, g_ref, rtol=1e-5, atol=1e-5)
    for r in time2:
        for a, b in zip(r["halo"][0], r["halo"][1]):
            assert np.array_equal(a, b)


def test_time_sharded_steps_match_jax_and_one_process(time2, devices):
    """Two steps at b1, T16 over two time ranks: bitwise equal across
    ranks, and against JAX's make_train_step on the same batch sharded
    P(None, 'time') over make_mesh(data=1, time=2), and the port's
    one-process step."""
    from faceoff_tpu.parallel import make_mesh
    from faceoff_tpu.train import state as jstate
    from faceoff_tpu.train.train_step import make_train_step
    from faceoff_tpu_torch.io.convert import to_jax_variables

    r0, r1 = time2
    _assert_same(r0["steps"][0], r1["steps"][0])
    assert r0["steps"][1] == r1["steps"][1]
    _assert_steps_close(r0["steps"], r0["steps_ref"], 2, "one process")

    jm, params, vq = _jax_model_vars(r0["init"])
    tx = jstate.make_optimizer(LR)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              vq=vq, opt_state=tx.init(params), tx=tx)
    sharding = NamedSharding(make_mesh(data=1, time=2), P(None, "time"))
    batch = {k: jax.device_put(jnp.asarray(v.numpy()), sharding)
             for k, v in _batch(1, 1, STEP_T, 32).items()}
    step = make_train_step(jm, perceptual_loss_weight=0.0, donate=False)
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    got_p, got_vq = to_jax_variables({k: torch.from_numpy(v) for k, v in
                                      r0["steps"][0].items()})
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(got_p)}
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(state.params)}
    for mg, mw in zip(r0["steps"][1], metrics):
        for k in ("loss", "mse", "latent"):
            assert mg[k] == pytest.approx(mw[k], rel=1e-5), k
    _assert_adam_close(flat, want, LR, 2, "jax")
    for lvl in ("quantize_t", "quantize_b"):
        for name in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(
                got_vq[lvl]["codebook"][name],
                np.asarray(getattr(state.vq[lvl]["codebook"], name)),
                rtol=1e-4, atol=1e-5, err_msg=f"{lvl}.{name}")


def test_time_sharded_revive_matches_one_process(time2):
    """Rows gathered over the time ranks go back to the one-process
    (B, T, h, w) order before the draw: the codebooks equal a
    one-process revive on the global b2, T4 batch, on both ranks."""
    r0, r1 = time2
    _assert_same(r0["revived"], r1["revived"])
    _, got = _split(r0["revived"])
    _, ref = _split(r0["revived_ref"])
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    _, before = _split(r0["revived_before"])
    assert not np.array_equal(got["quantize_t.embed"],
                              before["quantize_t.embed"])


def test_data_time_forward_matches_jax(data_time, devices):
    """test_sharding.py:153's clips (4, 4, 32, 32, 6) over data=2 x time=2
    ranks against JAX's jit with P('data', 'time') on make_mesh(data=2,
    time=2)."""
    from faceoff_tpu.parallel import make_mesh

    blocks = [r["fwd"][0] for r in data_time]
    got = np.concatenate([np.concatenate(blocks[0:2], 1),
                          np.concatenate(blocks[2:4], 1)], 0)
    want, _ = _jax_forward(data_time[0]["init"], _video(2, (4, 4, 32, 32, 6)),
                           make_mesh(data=2, time=2), P("data", "time"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # each diff is its data group's clips'
    assert data_time[0]["fwd"][1] == data_time[1]["fwd"][1]
    assert data_time[2]["fwd"][1] == data_time[3]["fwd"][1]


def test_data_time_step_with_prepare_matches_one_process(data_time):
    """The time ranks of a data group prepared the same clip, the two data
    groups different ones, and the step (LPIPS included) equals one
    process's on the two clips; bitwise equal on every rank."""
    p = [r["prepared"] for r in data_time]
    assert np.array_equal(p[0], p[1]) and np.array_equal(p[2], p[3])
    assert not np.array_equal(p[0], p[2])
    for r in data_time[1:]:
        _assert_same(r["step"][0], data_time[0]["step"][0])
        assert r["step"][1] == data_time[0]["step"][1]
    assert data_time[0]["step"][1][0]["perceptual"] != 0.0
    _assert_steps_close(data_time[0]["step"], data_time[0]["step_ref"], 1,
                        "one process")


def test_time1_mesh_step_is_the_plain_step_bit_for_bit():
    """One process on make_mesh(data=1, time=1): the shardmap step is the
    plain step, bit for bit."""
    from faceoff_tpu_torch.parallel.mesh import make_mesh
    from faceoff_tpu_torch.train.shardmap_step import make_shardmap_train_step
    from faceoff_tpu_torch.train.train_step import make_train_step

    batch = _batch(3, 2, 2, 32)
    a, b = _state(), _state()
    got = _steps(make_shardmap_train_step(a.model, make_mesh(data=1, time=1),
                                          perceptual_loss_weight=0.0),
                 a, batch, 2)
    want = _steps(make_train_step(b.model, perceptual_loss_weight=0.0), b,
                  batch, 2)
    _assert_same(got[0], want[0])
    assert got[1] == want[1]


def test_all_gather_clips_order_and_postnet_over_shards():
    """One process: `postnet_over_shards` on four blocks of a clip (one
    of a single frame) equals the whole clip's postnet, and
    `all_gather_clips` without a group is the identity."""
    from faceoff_tpu_torch.models.vqvae import postnet_over_shards
    from faceoff_tpu_torch.parallel import collectives as col

    post = _model().conv3d_encoded_t
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((1, 16, 7, 4, 4), generator=gen)
    with torch.no_grad():
        want = post(x)
        got = torch.cat(postnet_over_shards(
            post, torch.split(x, [2, 1, 2, 2], dim=2)), dim=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert col.all_gather_clips(x, None, 2) is x
