"""Multi-process data parallelism of the port over torch.distributed's gloo
backend on the CPU: two ranks in subprocesses on a free localhost port,
two launches in all.

Launch 1 (`_worker_steps`), at narrow widths (channel 16, 32 px):
  * `make_shardmap_train_step`, 2 ranks x 2 clips for 2 steps, against
    the one-process step on the 4 clips (rank 0 runs it too) and against
    JAX's `make_shardmap_train_step` on `make_mesh(data=2)` (two of the
    conftest's virtual CPU devices) from the same weights;
  * the codebooks after `revive_codes` identical on both ranks, and equal
    to a one-process revive on the global batch;
  * `PreemptionGuard.should_stop_global` when only rank 1 was signalled;
  * the GAN steps on the global batch: one mocogan step (the patch
    discriminators' BatchNorm in training mode), a mocoganhd gen and
    disc step (the RaLSGAN batch means) and a vqgan gen and disc step
    (the adaptive weight's gradients), 2 ranks x 1 clip against one
    process on the 2 clips; and ActNorm's data-dependent init, 2 ranks x
    2 images against one process on the 4.
Launch 2 (`_worker_clis`): the perceptual CLI (one epoch, 4 steps) and
the GAN CLI (2 steps) with --multihost: process 0 alone writes
checkpoints and sample streams, and the parameters end equal on both
ranks.

Tolerances: across ranks bitwise (the same averaged gradients and the
same Adam update). Ranks against one process, and against JAX: losses
rtol 1e-5; codebooks rtol 1e-4 atol 1e-5 (the same assignments; sums
added in another order); BatchNorm averages rtol 1e-5 atol 1e-6;
parameters after Adam within 2 lr everywhere and 1e-6 on 99 % of the
entries (Adam's first update is lr g/|g| per entry, so an entry whose
gradient is at rounding level may take either sign: the rule of
tests/test_torch_train.py)."""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
LR = 1e-3
WIDTHS = dict(channel=16, n_res_channel=8, embed_dim=8, n_embed=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(worker: str, out: Path, world: int = 2, timeout: float = 240):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(TESTS)!r}); "
         f"import test_torch_parallel as t; "
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
    return logs


def _join(rank, world, port):
    from faceoff_tpu_torch.parallel import collectives

    torch.set_num_threads(1)
    collectives.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       device="cpu")
    assert collectives.get_world_size() == world
    return collectives


def _batch(seed, b, t, size):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (b, t, size, size, 3)).astype(np.float32)
    bg = rng.uniform(-1, 1, (b, t, size, size, 3)).astype(np.float32)
    return {"input": torch.from_numpy(np.concatenate([gt, bg], -1)),
            "gt": torch.from_numpy(gt)}


def _gen_state(seed, group=None):
    from faceoff_tpu_torch.config import ModelConfig
    from faceoff_tpu_torch.models import VQVAE
    from faceoff_tpu_torch.train.state import create_train_state, make_optimizer

    model = VQVAE(ModelConfig(**WIDTHS), dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(seed),
                  process_group=group)
    return create_train_state(model, make_optimizer(model.parameters(), LR))


def _np_sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


# -- launch 1: the steps ----------------------------------------------------


def _worker_steps(rank, world, port, out):
    col = _join(rank, world, port)
    from faceoff_tpu_torch.models.discriminators import (
        MultiscaleDiscriminator2D, MultiscaleDiscriminator3D,
        NLayerDiscriminator, PatchImageDiscriminator, PatchVideoDiscriminator,
        init_actnorm_, set_process_group)
    from faceoff_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from faceoff_tpu_torch.train import gan, mocogan, vqgan
    from faceoff_tpu_torch.train.observability import PreemptionGuard
    from faceoff_tpu_torch.train.shardmap_step import make_shardmap_train_step
    from faceoff_tpu_torch.train.train_step import make_train_step

    group = col.default_group()
    mesh = make_mesh()
    res = {}
    batch = _batch(1, 4, 2, 32)
    local = shard_batch(batch, mesh)
    assert local["input"].shape[0] == 2

    # the shardmap step against one process on the global batch
    state = _gen_state(0)
    res["init"] = _np_sd(state.model)
    step = make_shardmap_train_step(state.model, mesh,
                                    perceptual_loss_weight=0.0)
    metrics = []
    for _ in range(2):
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    res["steps"] = [_np_sd(state.model), metrics]
    if rank == 0:
        ref = _gen_state(0)
        ref_step = make_train_step(ref.model, perceptual_loss_weight=0.0)
        ref_metrics = []
        for _ in range(2):
            ref, m = ref_step(ref, batch)
            ref_metrics.append({k: float(v) for k, v in m.items()})
        res["steps_ref"] = [_np_sd(ref.model), ref_metrics]

    # revive: every code of the top level dead, half of the bottom's
    with torch.no_grad():
        for q in (state.model.quantize_t, state.model.quantize_b):
            q.cluster_size[: q.cluster_size.numel() // (
                1 if q is state.model.quantize_t else 2)] = 0.0
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state.model.revive_codes(local["input"],
                             torch.Generator().manual_seed(5))
    res["revived"] = _np_sd(state.model)
    if rank == 0:
        ref = _gen_state(0)
        ref.model.load_state_dict(before)
        ref.model.revive_codes(batch["input"],
                               torch.Generator().manual_seed(5))
        res["revived_ref"] = _np_sd(ref.model)

    # preemption: only rank 1 gets the signal
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    if rank == 1:
        signal.raise_signal(signal.SIGUSR1)
    res["stop"] = [guard.should_stop, guard.should_stop_global()]
    guard.restore()

    # mocogan: BatchNorm in training mode over the global batch
    mbatch = _batch(6, 2, 16, 64)
    mlocal = shard_batch(mbatch, mesh)

    def moco(g, b):
        st = _gen_state(7, g)
        d_img = PatchImageDiscriminator(3, ndf=4, device="cpu",
                                        generator=torch.Generator()
                                        .manual_seed(8))
        d_vid = PatchVideoDiscriminator(3, ndf=4, device="cpu",
                                        generator=torch.Generator()
                                        .manual_seed(9))
        for d in (d_img, d_vid):
            set_process_group(d, g)
        s = mocogan.create_mocogan_state(st, d_img, d_vid, disc_lr=LR)
        s, m = mocogan.make_mocogan_step(st.model, d_img, d_vid,
                                         process_group=g)(s, b)
        return [_np_sd(st.model), _np_sd(d_img), _np_sd(d_vid),
                {k: float(v) for k, v in m.items()}]

    res["mocogan"] = moco(group, mlocal)
    if rank == 0:
        res["mocogan_ref"] = moco(None, mbatch)

    # mocoganhd: the RaLSGAN batch means over the global batch
    hbatch = _batch(11, 2, 6, 32)
    hlocal = shard_batch(hbatch, mesh)

    def hd(g, b):
        st = _gen_state(12, g)
        d_img = MultiscaleDiscriminator2D(6, ndf=8, n_layers=2, device="cpu",
                                          generator=torch.Generator()
                                          .manual_seed(13))
        d_3d = MultiscaleDiscriminator3D(6, ndf=8, n_layers=2, n_frames=4,
                                         device="cpu",
                                         generator=torch.Generator()
                                         .manual_seed(14))
        s = gan.create_gan_state(st, d_img, d_3d, disc_lr=LR)
        gen_step, disc_step = gan.make_gan_steps(
            st.model, d_img, d_3d, sample_frames=4, process_group=g)
        s, gm = gen_step(s, b, 0, 0.7)
        s, dm = disc_step(s, b, 0)
        return [_np_sd(st.model), _np_sd(d_img), _np_sd(d_3d),
                {k: float(v) for k, v in {**gm, **dm}.items()}]

    res["mocoganhd"] = hd(group, hlocal)
    if rank == 0:
        res["mocoganhd_ref"] = hd(None, hbatch)

    # vqgan: the adaptive weight from the global batch's gradients
    def vq(g, b):
        st = _gen_state(15, g)
        disc = NLayerDiscriminator(3, ndf=8, n_layers=2, device="cpu",
                                   generator=torch.Generator().manual_seed(16))
        s = vqgan.create_vqgan_state(st, disc, disc_lr=LR)
        gen_step, disc_step = vqgan.make_vqgan_steps(st.model, disc,
                                                     process_group=g)
        s, gm = gen_step(s, b, 0)
        s, dm = disc_step(s, b, 0)
        return [_np_sd(st.model), _np_sd(disc), {},
                {k: float(v) for k, v in {**gm, **dm}.items()}]

    res["vqgan"] = vq(group, hlocal)
    if rank == 0:
        res["vqgan_ref"] = vq(None, hbatch)

    # ActNorm's data-dependent init from the global batch
    def actnorm(g, x):
        disc = NLayerDiscriminator(3, ndf=8, n_layers=2, use_actnorm=True,
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(17))
        set_process_group(disc, g)
        init_actnorm_(disc, x)
        return _np_sd(disc)

    x = torch.from_numpy(np.random.default_rng(18).uniform(
        -1, 1, (4, 32, 32, 3)).astype(np.float32))
    res["actnorm"] = actnorm(group, x[2 * rank: 2 * rank + 2])
    if rank == 0:
        res["actnorm_ref"] = actnorm(None, x)
    torch.save(res, os.path.join(out, f"steps_{rank}.pt"))
    col.destroy()


def _assert_adam_close(got, want, lr, what):
    """Parameters after Adam steps: within 2 lr (times the steps taken)
    everywhere and 1e-6 on 99 % of the entries."""
    diffs = []
    for k in want:
        d = np.abs(got[k] - want[k]).ravel()
        assert d.max() <= 2 * lr * 2 * (1 + 1e-3) + 1e-6, (what, k, d.max())
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


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_steps")
    _launch("_worker_steps", out)
    return [torch.load(out / f"steps_{r}.pt", weights_only=False)
            for r in range(2)]


def test_shardmap_step_two_ranks_match_one_process(steps):
    r0, r1 = steps
    _assert_same(r0["steps"][0], r1["steps"][0])
    assert r0["steps"][1] == r1["steps"][1]
    got, ref = r0["steps"], r0["steps_ref"]
    for mg, mr in zip(got[1], ref[1]):
        for k in ("loss", "mse", "latent", "lr"):
            assert mg[k] == pytest.approx(mr[k], rel=1e-5), k
    gp, gc = _split(got[0])
    rp, rc = _split(ref[0])
    _assert_adam_close(gp, rp, LR, "shardmap")
    for k in rc:
        np.testing.assert_allclose(gc[k], rc[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_shardmap_step_matches_jax_on_two_devices(steps, devices):
    """JAX's explicit step on make_mesh(data=2) from the ranks' initial
    weights and the same 4 clips."""
    import jax
    import jax.numpy as jnp

    from faceoff_tpu.models import VQVAE as JVQVAE
    from faceoff_tpu.ops.vq import VQCodebook
    from faceoff_tpu.parallel import make_mesh
    from faceoff_tpu.train import state as jstate
    from faceoff_tpu.train.shardmap_step import make_shardmap_train_step
    from faceoff_tpu_torch.io.convert import to_jax_variables

    r0 = steps[0]
    params, vq = to_jax_variables({k: torch.from_numpy(v)
                                   for k, v in r0["init"].items()})
    vq = {lvl: {"codebook": VQCodebook(**{k: jnp.asarray(v) for k, v in
                                          d["codebook"].items()})}
          for lvl, d in vq.items()}
    jm = JVQVAE(in_channels=6, n_res_block=2, dtype=jnp.float32,
                axis_name="data", **WIDTHS)
    tx = jstate.make_optimizer(LR)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              vq=vq, opt_state=tx.init(params), tx=tx)
    step = make_shardmap_train_step(jm, make_mesh(data=2),
                                    perceptual_loss_weight=0.0)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(1, 4, 2, 32).items()}
    for k in range(2):
        state, m = step(state, batch, None)
        for name in ("loss", "mse", "latent"):
            assert r0["steps"][1][k][name] == pytest.approx(float(m[name]),
                                                            rel=1e-5), name
    got_p, got_vq = to_jax_variables({k: torch.from_numpy(v) for k, v in
                                      r0["steps"][0].items()})
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(got_p)}
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(state.params)}
    _assert_adam_close(flat, want, LR, "jax")
    for lvl in ("quantize_t", "quantize_b"):
        for name in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(
                got_vq[lvl]["codebook"][name],
                np.asarray(getattr(state.vq[lvl]["codebook"], name)),
                rtol=1e-4, atol=1e-5, err_msg=f"{lvl}.{name}")


def test_revive_leaves_identical_codebooks_on_every_rank(steps):
    r0, r1 = steps
    _assert_same(r0["revived"], r1["revived"])
    _, got = _split(r0["revived"])
    _, ref = _split(r0["revived_ref"])
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    _, before = _split(r0["steps"][0])
    assert not np.array_equal(got["quantize_t.embed"],
                              before["quantize_t.embed"])


def test_should_stop_global_when_one_rank_was_signalled(steps):
    assert steps[0]["stop"] == [False, True]
    assert steps[1]["stop"] == [True, True]


@pytest.mark.parametrize("recipe", ["mocogan", "mocoganhd", "vqgan"])
def test_gan_steps_use_the_global_batch(steps, recipe):
    """Generator, both discriminators (BatchNorm running averages
    included) and the metrics: bitwise equal across ranks, and as one
    process's step on the global batch."""
    r0, r1 = steps
    for a, b in zip(r0[recipe][:3], r1[recipe][:3]):
        _assert_same(a, b)
    got, ref = r0[recipe], r0[f"{recipe}_ref"]
    for k, v in ref[3].items():
        assert got[3][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    gp, gc = _split(got[0])
    rp, rc = _split(ref[0])
    _assert_adam_close(gp, rp, LR, f"{recipe} generator")
    for k in rc:
        np.testing.assert_allclose(gc[k], rc[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for gd, rd in zip(got[1:3], ref[1:3]):
        if not rd:
            continue  # vqgan has one discriminator
        # vqgan's BatchNorm runs on its running averages (train=False)
        stats = [k for k in rd if "running" in k and recipe != "vqgan"]
        assert (recipe == "mocogan") == bool(stats)
        for k in stats:
            np.testing.assert_allclose(gd[k], rd[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        _assert_adam_close({k: gd[k] for k in rd if k not in stats},
                           {k: rd[k] for k in rd if k not in stats}, LR,
                           f"{recipe} discriminator")


# -- launch 2: the command lines --------------------------------------------


CLI_NARROW = ["--channel", "16", "--n_res_channel", "8", "--embed_dim", "8",
              "--n_embed", "16", "--num_workers", "1", "--size", "32",
              "--seed", "3"]


def _worker_clis(rank, world, port, out):
    """Both CLIs under --multihost; every checkpoint and sample write is
    recorded with its rank."""
    torch.set_num_threads(1)
    from faceoff_tpu_torch.cli import train_faceoff_gan as gan_cli
    from faceoff_tpu_torch.cli import train_faceoff_perceptual as cli
    from faceoff_tpu_torch.io import checkpoint
    from faceoff_tpu_torch.train import trainer

    writes = []
    save_tree = checkpoint.CheckpointManager.save_tree

    def recording_save(self, step, payload):
        writes.append(["ckpt", os.path.basename(self.directory), step])
        save_tree(self, step, payload)

    checkpoint.CheckpointManager.save_tree = recording_save
    save_video = trainer.save_frames_as_video

    def recording_video(frames, path, fps=25):
        writes.append(["video", os.path.basename(path)])
        save_video(frames, path, fps)

    trainer.save_frames_as_video = recording_video
    mh = ["--multihost", "--coordinator_address", f"127.0.0.1:{port}",
          "--num_processes", str(world), "--process_id", str(rank)]
    t = cli.main(["--data_root", os.path.join(out, "ds"), "--resident_data",
                  "--batch_size", "1", "--train_frames", "2",
                  "--val_frames", "2", "--epoch", "1", "--validate_at", "2",
                  "--checkpoint_dir", os.path.join(out, "ck"),
                  "--sample_folder", os.path.join(out, "sm"), *mh,
                  *CLI_NARROW], device="cpu")
    res = {"steps": t.global_step, "ckpt_dir": t.ckpt.directory,
           "perceptual": _np_sd(t.model)}
    g = gan_cli.main(["--data_root", os.path.join(out, "ds"),
                      "--resident_data", "--train_frames", "4",
                      "--sample_frames", "4", "--val_frames", "4",
                      "--val_batches", "1", "--ndf", "8", "--steps", "2",
                      "--validate_at", "2", "--log_every", "1", "--ckpt",
                      "latest", "--gen_checkpoint_dir", t.ckpt.directory,
                      "--checkpoint_dir", os.path.join(out, "gan"),
                      "--sample_folder", os.path.join(out, "gan_sm"), *mh,
                      *CLI_NARROW], device="cpu")
    res.update(gan_step=g["step"], gan=_np_sd(g["state"].gen.model),
               d_img=_np_sd(g["state"].d_img), fd=g["fd"], writes=writes)
    torch.save(res, os.path.join(out, f"cli_{rank}.pt"))


def test_multihost_clis_two_ranks(tmp_path):
    from faceoff_tpu_torch.data.synthetic import generate_dataset

    generate_dataset(str(tmp_path / "ds"), n_videos=4, n_frames=6, size=32)
    _launch("_worker_clis", tmp_path)
    r0, r1 = (torch.load(tmp_path / f"cli_{r}.pt", weights_only=False)
              for r in range(2))
    assert r0["ckpt_dir"] == r1["ckpt_dir"]  # the broadcast run name
    assert os.path.basename(r0["ckpt_dir"]).startswith("ck_mh")
    # a resident corpus is each process's whole dataset: an epoch is
    # len(dataset) // clips a step = 4 steps, as the JAX CLI counts it
    assert r0["steps"] == r1["steps"] == 4
    assert r0["gan_step"] == r1["gan_step"] == 2
    for k in ("perceptual", "gan", "d_img"):
        _assert_same(r0[k], r1[k])
    assert r1["writes"] == []
    kinds = {w[0] for w in r0["writes"]}
    assert kinds == {"ckpt", "video"}
    assert sorted(os.listdir(r0["ckpt_dir"])) == ["ckpt_00000002.pt",
                                                  "ckpt_00000004.pt"]
    assert sorted(os.listdir(tmp_path / "gan" / "disc")) == [
        "ckpt_00000002.pt"]
    assert r0["fd"] == r1["fd"] and all(np.isfinite(list(r0["fd"].values())))


def test_actnorm_init_uses_the_global_batch(steps):
    r0, r1 = steps
    _assert_same(r0["actnorm"], r1["actnorm"])
    for k, v in r0["actnorm_ref"].items():
        np.testing.assert_allclose(r0["actnorm"][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# -- one process: the helpers without a process group ----------------------


def test_one_process_helpers(capsys):
    from faceoff_tpu_torch.parallel import collectives as col
    from faceoff_tpu_torch.parallel.mesh import make_mesh, shard_batch

    col.initialize_distributed(device="cpu")
    assert "single-process run" in capsys.readouterr().out
    assert (col.get_world_size(), col.get_rank(), col.is_primary()) == (
        1, 0, True)
    assert col.default_group() is None
    x = torch.arange(6.0)
    assert col.all_reduce_mean(x) is x and col.all_gather_rows(x) is x
    assert col.broadcast_object("nonce") == "nonce"
    col.synchronize("cpu")
    mesh = make_mesh()
    assert (mesh.data, mesh.time, mesh.rank) == (1, 1, 0)
    batch = {"input": torch.zeros((3, 2, 4))}
    assert shard_batch(batch, mesh)["input"].shape == (3, 2, 4)
    with pytest.raises(ValueError, match="missing: --num_processes, "
                                         "--process_id"):
        col.initialize_distributed("127.0.0.1:1", device="cpu")


def test_mesh_layout_and_errors_match_jax(devices):
    """The JAX mesh's errors over 8 devices, the port's over a world of 8;
    process r of a data axis of n holds the r-th block of the batch."""
    from faceoff_tpu.parallel import make_mesh as jax_mesh
    from faceoff_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                 shard_batch)

    for kwargs in (dict(time=3), dict(data=16), dict(data=3, time=3)):
        with pytest.raises(ValueError) as want:
            jax_mesh(**kwargs)
        with pytest.raises(ValueError) as got:
            make_mesh(**kwargs, world_size=8, rank=0)
        assert str(got.value) == str(want.value)
    x = torch.arange(8 * 4).reshape(8, 4)
    for r in range(4):
        mesh = make_mesh(world_size=4, rank=r)
        assert torch.equal(shard_batch({"x": x}, mesh)["x"], x[2 * r:2 * r + 2])
    mesh = make_mesh(data=2, time=2, world_size=4, rank=3)
    assert (mesh.data_index, mesh.time_index) == (1, 1)
    assert torch.equal(batch_sharding(mesh, time_axis=1)(x), x[4:, 2:])


def test_multihost_flags_partial_set_exits_as_jax():
    import argparse

    from faceoff_tpu.cli import common as jcommon
    from faceoff_tpu_torch.cli import common as tcommon

    args = argparse.Namespace(coordinator_address="h:1", num_processes=None,
                              process_id=0)
    with pytest.raises(SystemExit) as want:
        jcommon.multihost_kwargs(args)
    with pytest.raises(SystemExit) as got:
        tcommon.multihost_kwargs(args)
    assert str(got.value) == str(want.value)
    full = argparse.Namespace(coordinator_address="h:1", num_processes=2,
                              process_id=0)
    assert tcommon.multihost_kwargs(full) == jcommon.multihost_kwargs(full)
