"""The port's trainer on the CPU at narrow widths (channel 16, 32 px):
exact resume from a checkpoint, K steps in one call, the metric formats
and the reconstruction report against the JAX package, the trainer's
files through the command line, its resume accounting, the parser
against the JAX parser, and the flags it refuses. Inputs are made with
numpy from a seed; the CPU step is deterministic, so "exact" means
bitwise."""

import json
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.cli import train_faceoff_perceptual as jcli
from faceoff_tpu.evaluation import metrics as jmetrics
from faceoff_tpu.train import observability as jobs
from faceoff_tpu.train import trainer as jtrainer
from faceoff_tpu_torch.cli import train_faceoff_perceptual as tcli
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data.resident import (corpus_from_arrays,
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import generate_dataset, synthetic_corpus
from faceoff_tpu_torch.evaluation import metrics as tmetrics
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.io.video import read_video_frames
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models.lpips import init_lpips
from faceoff_tpu_torch.train import observability as tobs
from faceoff_tpu_torch.train import trainer as ttrainer
from faceoff_tpu_torch.train.state import create_train_state, make_optimizer
from faceoff_tpu_torch.train.train_step import make_multi_step, make_train_step

CFG = ModelConfig(channel=16, n_res_channel=8, embed_dim=8, n_embed=16)
NARROW = ["--channel", "16", "--n_res_channel", "8", "--embed_dim", "8",
          "--n_embed", "16", "--num_workers", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lpips():
    return init_lpips(torch.Generator().manual_seed(1), device="cpu")


@pytest.fixture(scope="module")
def corpus():
    frames, lms, n = synthetic_corpus(3, 6, 32, seed=2)
    return corpus_from_arrays(frames, lms, n, device="cpu")


def _state(seed, n_iter=8):
    model = VQVAE(CFG, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    return create_train_state(
        model, make_optimizer(model.parameters(), 3e-4, "cycle",
                              n_iter=n_iter))


def _assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:  # parameters and the EMA buffers (embed, cluster sizes, sums)
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["lr"] == ob["lr"]
    assert oa["adam"]["param_groups"] == ob["adam"]["param_groups"]
    for i, st in oa["adam"]["state"].items():
        for k, v in st.items():  # moments and per-parameter step counts
            assert torch.equal(v, ob["adam"]["state"][i][k]), (i, k)


def _raw(corpus):
    return {"frames": corpus.frames, "landmarks": corpus.landmarks}


def test_checkpoint_resume_is_exact(tmp_path, lpips, corpus):
    """2 steps + save + restore into a model built from another seed + 2
    steps equals 4 unbroken steps bitwise: parameters, EMA buffers, Adam's
    moments and step counts, the lr, the step and every metric."""
    prepare = make_resident_prepare(corpus, 2, 3)
    straight = _state(0)
    step = make_train_step(straight.model, lpips=lpips, prepare_fn=prepare)
    want = []
    for _ in range(4):
        straight, m = step(straight, _raw(corpus), 5)
        want.append({k: float(v) for k, v in m.items()})

    first = _state(0)
    step = make_train_step(first.model, lpips=lpips, prepare_fn=prepare)
    for _ in range(2):
        first, _ = step(first, _raw(corpus), 5)
    manager = CheckpointManager(str(tmp_path), keep=2)
    manager.save(2, first, seed=5)
    resumed = manager.restore(_state(9), seed=5)
    assert resumed.step == 2 and manager.latest_step() == 2
    step = make_train_step(resumed.model, lpips=lpips, prepare_fn=prepare)
    got = []
    for _ in range(2):
        resumed, m = step(resumed, _raw(corpus), 5)
        got.append({k: float(v) for k, v in m.items()})
    assert got == want[2:]
    _assert_states_equal(resumed, straight)

    with pytest.raises(ValueError, match="seed 5"):
        manager.restore(_state(9), seed=6)
    weights_only = manager.restore_weights(_state(9))
    assert weights_only.step == 2 and not weights_only.optimizer.optimizer.state


def test_multi_step_equals_single_steps(lpips, corpus):
    """make_multi_step(K=2) equals two single steps bitwise, on the
    resident corpus (one batch for both) and on stacked host batches;
    its metrics are the last step's with loss_mean over the two."""
    prepare = make_resident_prepare(corpus, 2, 3)
    single, multi = _state(0), _state(0)
    step = make_train_step(single.model, lpips=lpips, prepare_fn=prepare)
    losses = []
    for _ in range(2):
        single, m1 = step(single, _raw(corpus), 1)
        losses.append(float(m1["loss"]))
    k2 = make_multi_step(multi.model, 2, lpips=lpips, prepare_fn=prepare,
                         scan_batches=False)
    multi, m2 = k2(multi, _raw(corpus), 1)
    _assert_states_equal(multi, single)
    assert float(m2["loss"]) == losses[-1]
    assert float(m2["loss_mean"]) == pytest.approx(np.mean(losses), rel=1e-6)

    gen = torch.Generator().manual_seed(3)
    batches = [prepare(gen, corpus.frames, corpus.landmarks)
               for _ in range(2)]
    single, multi = _state(0), _state(0)
    step = make_train_step(single.model, lpips=lpips)
    for b in batches:
        single, _ = step(single, b)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    multi, _ = make_multi_step(multi.model, 2, lpips=lpips)(multi, stacked)
    _assert_states_equal(multi, single)


def test_metric_formats_match_jax(tmp_path):
    """MetricLogger.line and the MetricsWriter records are the JAX
    package's for the same values (the records' times aside)."""
    steps = [{"loss": 0.75, "mse": 0.25, "latent": 0.125,
              "perceptual": 0.375, "lr": 3e-4},
             {"loss": 0.5, "mse": 0.125, "latent": 0.0625,
              "perceptual": 0.3125, "lr": 2e-4}]
    t_log, j_log = ttrainer.MetricLogger(), jtrainer.MetricLogger()
    for i, m in enumerate(steps):
        t_log.update({k: torch.tensor(v) for k, v in m.items()}, 16 + i)
        j_log.update({k: jnp.asarray(v) for k, v in m.items()}, 16 + i)
    tm = {k: torch.tensor(v) for k, v in steps[-1].items()}
    jm = {k: jnp.asarray(v) for k, v in steps[-1].items()}
    assert t_log.line(1, tm, 2e-4) == j_log.line(1, jm, 2e-4)

    records = {}
    for name, mod, wrap in (("t", tobs, torch.tensor), ("j", jobs, jnp.asarray)):
        writer = mod.MetricsWriter(str(tmp_path / f"{name}.jsonl"))
        for i, m in enumerate(steps):
            writer.write(i + 1, {k: wrap(v) for k, v in m.items()}, epoch=0)
        writer.close()
        with open(tmp_path / f"{name}.jsonl") as f:
            records[name] = [json.loads(line) for line in f]
    for a, b in zip(records["t"], records["j"]):
        assert list(a) == list(b)
        a.pop("time"), b.pop("time")
        assert a == b


def test_evaluate_reconstruction_matches_jax():
    """mse, l1, psnr and ssim of the same clips agree with the JAX
    report to 1e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(0)
    pred = rng.uniform(-1, 1, (2, 3, 24, 20, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.2, pred.shape), -1, 1).astype(
        np.float32)
    got = tmetrics.evaluate_reconstruction(torch.from_numpy(pred),
                                           torch.from_numpy(target))
    want = jmetrics.evaluate_reconstruction(jnp.asarray(pred),
                                            jnp.asarray(target))
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                              abs=1e-5), k


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_ds")
    generate_dataset(str(root), n_videos=4, n_frames=6, size=32, seed=4)
    return str(root)


def _argv(root, work, *extra):
    return ["--data_root", root, "--size", "32", "--batch_size", "2",
            "--train_frames", "3", "--val_frames", "3", "--sched", "cycle",
            "--sample_folder", str(work / "samples"),
            "--checkpoint_dir", str(work / "ckpt"), *NARROW, *extra]


def _only(work, stem):
    found = sorted(work.glob(f"{stem}_*"))
    assert len(found) == 1, found
    return found[0]


def test_fit_writes_metrics_streams_and_keeps_checkpoints(tmp_path,
                                                          data_root):
    """A resident run of 3 epochs (2 steps each) validating every step:
    a metrics line per step, four AVI streams a validation batch with the
    frames written, and only the newest 5 checkpoints."""
    metrics = tmp_path / "m.jsonl"
    trainer = tcli.main(_argv(data_root, tmp_path, "--resident_data",
                              "--epoch", "3", "--validate_at", "1",
                              "--metrics_path", str(metrics)), device="cpu")
    assert trainer.global_step == 6
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r[k]) for r in records
               for k in ("loss", "mse", "latent", "perceptual", "lr"))
    assert CheckpointManager(str(_only(tmp_path, "ckpt"))).all_steps() == [
        2, 3, 4, 5, 6]
    streams = sorted(_only(tmp_path, "samples").glob("*.mp4"))
    assert len(streams) == 6 * 4 * 4  # validations x batches x streams
    assert {p.name.split("_", 3)[3] for p in streams} == {
        "source.mp4", "background.mp4", "prediction.mp4",
        "source_images.mp4"}
    frames = read_video_frames(str(streams[0]), device="cpu")
    assert len(frames) == 3 and frames[0].shape == (32, 32, 3)


@pytest.mark.parametrize("flag", ["--crossid", "--custom_validation"])
def test_cross_identity_validation_writes_its_streams(tmp_path, data_root,
                                                      flag):
    """With --crossid (another video's face on each validation clip) or
    --custom_validation (the videos paired with the training root's),
    validation writes the source_original stream beside the four, with
    the frames of the clip."""
    tcli.main(_argv(data_root, tmp_path, "--resident_data", "--epoch", "1",
                    "--validate_at", "2", flag), device="cpu")
    streams = sorted(_only(tmp_path, "samples").glob("*.mp4"))
    assert len(streams) == 4 * 5  # batches x streams
    assert {p.name.split("_", 3)[3] for p in streams} == {
        "source.mp4", "background.mp4", "prediction.mp4",
        "source_images.mp4", "source_original.mp4"}
    frames = read_video_frames(str(streams[-1]), device="cpu")
    assert len(frames) == 3 and frames[0].shape == (32, 32, 3)


@pytest.mark.parametrize("resume_from", [2, 4])
def test_resume_equals_unbroken_run_through_the_cli(tmp_path, data_root,
                                                    resume_from):
    """The command line resumed with --ckpt latest from a checkpoint of an
    unbroken run (every later one removed) ends in that run's state,
    bitwise, with the same metrics; fit credits the restored steps
    against the epoch budget."""
    work_u, work_r = tmp_path / "u", tmp_path / "r"
    run_u = tcli.main(_argv(data_root, work_u, "--resident_data",
                            "--epoch", "3", "--validate_at", "2",
                            "--metrics_path", str(work_u / "m.jsonl")),
                      device="cpu")
    ckpt_r = work_r / "ckpt"
    ckpt_r.mkdir(parents=True)
    shutil.copy(_only(work_u, "ckpt") / f"ckpt_{resume_from:08d}.pt", ckpt_r)
    run_r = tcli.main(_argv(data_root, work_r, "--resident_data",
                            "--epoch", "3", "--validate_at", "2", "--ckpt",
                            "latest", "--metrics_path",
                            str(work_r / "m.jsonl")), device="cpu")
    assert run_r.global_step == run_u.global_step == 6
    _assert_states_equal(run_r.state, run_u.state)

    def records(path):
        with open(path) as f:
            return {r["step"]: {k: v for k, v in r.items() if k != "time"}
                    for r in map(json.loads, f)}

    rec_u, rec_r = records(work_u / "m.jsonl"), records(work_r / "m.jsonl")
    assert sorted(rec_r) == list(range(resume_from + 1, 7))
    assert all(rec_r[s] == rec_u[s] for s in rec_r)

    # the whole budget is already spent: nothing more to train
    again = tcli.main(_argv(data_root, work_r, "--resident_data", "--epoch",
                            "3", "--ckpt", "latest"), device="cpu")
    assert again.global_step == 6


@pytest.mark.parametrize("mode", ["--device_pipeline", "host",
                                  "--steps_per_call"])
def test_other_loaders_train(tmp_path, data_root, mode):
    """--device_pipeline (host decode, preparation in the step), the
    default host loader (whole items on the host) and two steps a call on
    the host loader each train an epoch with finite metrics."""
    extra = {"--device_pipeline": ["--device_pipeline"], "host": [],
             "--steps_per_call": ["--steps_per_call", "2"]}[mode]
    metrics = tmp_path / "m.jsonl"
    trainer = tcli.main(_argv(data_root, tmp_path, "--epoch", "1",
                              "--metrics_path", str(metrics), *extra),
                        device="cpu")
    assert trainer.global_step == 2
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    assert records and all(np.isfinite(r["loss"]) for r in records)


def test_preemption_saves_and_stops(tmp_path, data_root):
    """A stop request (SIGTERM's flag) saves at the next step boundary and
    ends the run."""
    parser = tcli.build_parser()
    args = parser.parse_args(_argv(data_root, tmp_path, "--resident_data",
                                   "--epoch", "3"))
    trainer, _ = tcli.build_everything(args, device="cpu")
    trainer.preemption.should_stop = True
    trainer.fit()
    assert trainer.global_step == 1
    assert trainer.ckpt.all_steps() == [1]


def test_profiler_and_watchdog(tmp_path):
    """StepProfiler writes a trace of its window; the watchdog calls its
    stall handler once no beat came within the timeout, and not after
    stop()."""
    prof = tobs.StepProfiler(str(tmp_path), start=1, count=1)
    for step in range(4):
        prof.step(step)
        torch.ones(8).sum()
    prof.close()
    assert [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    stalls = []
    dog = tobs.StallWatchdog(0.05, on_stall=stalls.append, poll_interval=0.01)
    deadline = time.monotonic() + 5
    while not stalls and time.monotonic() < deadline:
        time.sleep(0.01)
    dog.stop()
    assert stalls and stalls[0] > 0.05
    assert tobs.STALL_EXIT_CODE == jobs.STALL_EXIT_CODE


def test_parser_matches_jax():
    """The same option strings, and the same default for every one."""
    t_parser, j_parser = tcli.build_parser(), jcli.build_parser()

    def options(parser):
        return {s: a.default for a in parser._actions for s in
                a.option_strings if s not in ("-h", "--help")}

    assert options(t_parser) == options(j_parser)


@pytest.mark.parametrize("flags,item", [
    (["--multihost"], "Queue 1 item 6"),
    (["--coordinator_address", "localhost:1"], "Queue 1 item 6"),
    (["--crossid"], "Queue 1 item 2"),
    (["--custom_validation"], "Queue 1 item 2"),
    (["--lpips_weights", "auto"], "Queue 1 item 7"),
    (["--no_pallas"], "North star")])
def test_refused_flags_exit_naming_their_item(capsys, flags, item):
    """Flags whose function the port lacks exit naming their item.
    --crossid and --custom_validation were refused until Queue 1 item 2
    was ported, --multihost and its coordination flags until item 6,
    --lpips_weights auto until item 7(a); now they pass the check (and
    train: the tests below and tests/test_torch_parallel.py)."""
    parser = tcli.build_parser()
    if item in ("Queue 1 item 2", "Queue 1 item 6", "Queue 1 item 7"):
        tcli.refuse_unported(parser, parser.parse_args(
            ["--data_root", "unused", *flags]))
        return
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--data_root", "unused", *flags], device="cpu")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err
