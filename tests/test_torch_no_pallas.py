"""--no_pallas in the port, on the CPU at narrow widths: the training
quantizer's plain route against the JAX package's `use_pallas=False`
quantizer, the routing (with the kernel route off, the CUDA kernels'
entries are never reached, whatever the device), the perceptual CLI with
the flag against the same run without it, every CLI's parser, and the
clip lengths the perceptual CLI reads from `cfg.data`. Inputs are made
with numpy from a seed."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.ops import vq as jvq
from faceoff_tpu_torch import config as tconfig
from faceoff_tpu_torch.cli import common
from faceoff_tpu_torch.cli import encode as encode_cli
from faceoff_tpu_torch.cli import evaluate as evaluate_cli
from faceoff_tpu_torch.cli import export as export_cli
from faceoff_tpu_torch.cli import swap as swap_cli
from faceoff_tpu_torch.cli import train_faceoff as vanilla_cli
from faceoff_tpu_torch.cli import train_faceoff_gan as gan_cli
from faceoff_tpu_torch.cli import train_faceoff_perceptual as tcli
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data.synthetic import generate_dataset
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.ops import vq as tvq
from faceoff_tpu_torch.ops import vq_cuda

NARROW = ["--channel", "16", "--n_res_channel", "8", "--embed_dim", "8",
          "--n_embed", "16", "--num_workers", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _codebooks(seed, d, k):
    rng = np.random.default_rng(seed)
    embed = rng.normal(size=(d, k)).astype(np.float32)
    size = rng.uniform(0, 3, k).astype(np.float32)
    avg = (embed * rng.uniform(0.5, 2, k)).astype(np.float32)
    return (jvq.VQCodebook(jnp.asarray(embed), jnp.asarray(size),
                           jnp.asarray(avg)),
            tvq.VQCodebook(_t(embed), _t(size), _t(avg)))


def test_plain_quantizer_matches_jax_without_pallas():
    """`vq_quantize_train(use_kernels=False)` against the JAX function
    with `use_pallas=False` (its XLA path: `nearest_code`, the one-hot
    `vq_stats`, `codebook_lookup`): indices equal, quantized values and
    the commitment diff to 1e-6 (copies of the same codes, a mean of the
    same squares), codebooks rtol 1e-5 atol 1e-6 (the statistics are
    float32 sums of the same rows in another order). With update=False
    the same quantized values and indices, the codebook unchanged."""
    jcb, tcb = _codebooks(11, 8, 24)
    x = np.random.default_rng(12).normal(size=(3, 4, 5, 8)).astype(
        np.float32)
    q_ref, i_ref, d_ref, cb_ref = jvq.vq_quantize_train(
        jcb, jnp.asarray(x), decay=0.99, eps=1e-5, use_pallas=False)
    for update in (True, False):
        q, i, d, cb = tvq.vq_quantize_train(tcb, _t(x), decay=0.99,
                                            eps=1e-5, update=update,
                                            use_kernels=False)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(d.item(), float(d_ref), rtol=1e-6)
        want = cb_ref if update else jcb
        for name in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(getattr(cb, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def _refuse_kernels(monkeypatch, calls):
    def entry(name):
        def record(*args, **kwargs):
            calls.append(name)
            raise AssertionError(f"vq_cuda.{name} reached")
        return record

    for name in ("vq_assign", "assign_rows", "assign_rows_flagged",
                 "code_stats"):
        monkeypatch.setattr(vq_cuda, name, entry(name))


@pytest.mark.parametrize("update", [True, False])
def test_kernel_entries_unreached_without_kernels_on_any_device(
        monkeypatch, update):
    """With the kernel route off no entry of `ops/vq_cuda.py` is called,
    on the CPU and on a device that is not the CPU (meta tensors, with
    the plain version stubbed to shape-only outputs, since the meta
    device has no bincount); with it on, the meta tensors go to the
    kernel entry: the flag, not the device, decides."""
    calls = []
    _refuse_kernels(monkeypatch, calls)
    _, tcb = _codebooks(13, 4, 10)
    x = torch.from_numpy(np.random.default_rng(14).normal(
        size=(2, 6, 4)).astype(np.float32))
    tvq.vq_quantize_train(tcb, x, update=update, use_kernels=False)
    assert calls == []

    def shapes_only(flat, embed):
        n, (d, k) = flat.shape[0], embed.shape
        return (torch.zeros(n, dtype=torch.int32, device=flat.device),
                torch.zeros(n, d, device=flat.device),
                torch.zeros(k, device=flat.device),
                torch.zeros(d, k, device=flat.device))

    monkeypatch.setattr(tvq, "vq_assign_plain", shapes_only)
    meta = tvq.VQCodebook(*(t.to("meta") for t in tcb))
    tvq.vq_quantize_train(meta, x.to("meta"), update=update,
                          use_kernels=False)
    assert calls == []
    with pytest.raises(AssertionError, match="reached"):
        tvq.vq_quantize_train(meta, x.to("meta"), update=update,
                              use_kernels=True)
    assert calls == ["vq_assign" if update else "assign_rows"]


def test_model_passes_the_route_to_both_quantizers(monkeypatch):
    """`ModelConfig.use_pallas_vq=False` reaches both quantizers of the
    VQVAE, in a training forward and in one that leaves the codebooks
    (the GAN disc steps'); the kernel entries are never called."""
    calls, routes = [], []
    _refuse_kernels(monkeypatch, calls)
    plain = tvq.vq_quantize_train

    def record(*args, **kwargs):
        routes.append(kwargs["use_kernels"])
        return plain(*args, **kwargs)

    monkeypatch.setattr(tvq, "vq_quantize_train", record)
    cfg = ModelConfig(channel=16, n_res_block=1, n_res_channel=8,
                      embed_dim=8, n_embed=16, use_pallas_vq=False)
    model = VQVAE(cfg, dtype=torch.float32, device="cpu")
    video = torch.from_numpy(np.random.default_rng(15).uniform(
        -1, 1, (1, 2, 16, 16, 6)).astype(np.float32))
    model(video, train=True)
    model(video, train=True, update_codebooks=False)
    assert routes == [False] * 4 and calls == []
    assert all(not q.use_kernels for q in (model.quantize_t,
                                           model.quantize_b))
    assert VQVAE(dataclasses.replace(cfg, use_pallas_vq=True),
                 dtype=torch.float32, device="cpu").quantize_b.use_kernels


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("no_pallas_ds")
    generate_dataset(str(root), n_videos=4, n_frames=6, size=32, seed=4)
    return str(root)


def _argv(root, work, *extra):
    return ["--data_root", root, "--size", "32", "--batch_size", "2",
            "--train_frames", "3", "--val_frames", "3", "--sched", "cycle",
            "--resident_data", "--epoch", "1", "--validate_at", "1000",
            "--metrics_path", str(work / "m.jsonl"),
            "--sample_folder", str(work / "samples"),
            "--checkpoint_dir", str(work / "ckpt"), *NARROW, *extra]


def test_perceptual_cli_no_pallas_writes_the_same_records(tmp_path,
                                                          data_root):
    """On the CPU both routes are the plain version, so the perceptual
    CLI with --no_pallas writes the records of the run without it (times
    aside) and ends in the same weights and codebooks, bit for bit; the
    model it built has the kernel route off."""
    runs, records = {}, {}
    for name, extra in (("kernels", []), ("plain", ["--no_pallas"])):
        work = tmp_path / name
        runs[name] = tcli.main(_argv(data_root, work, *extra), device="cpu")
        with open(work / "m.jsonl") as f:
            records[name] = [{k: v for k, v in r.items() if k != "time"}
                             for r in map(json.loads, f)]
    assert len(records["plain"]) == 2
    assert records["plain"] == records["kernels"]
    a = runs["kernels"].state.model.state_dict()
    b = runs["plain"].state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert runs["kernels"].model.quantize_t.use_kernels
    assert not runs["plain"].model.quantize_t.use_kernels
    assert runs["plain"].cfg.model.use_pallas_vq is False


@pytest.mark.parametrize("cli,argv", [
    (swap_cli, ["--source", "a", "--target", "b", "--checkpoint_dir", "c"]),
    (encode_cli, ["--video_dir", "a", "--checkpoint_dir", "c"]),
    (evaluate_cli, ["--data_root", "a", "--checkpoint_dir", "c"]),
    (export_cli, ["--checkpoint_dir", "c", "--out", "o"]),
    (vanilla_cli, ["--data_root", "a"]),
    (gan_cli, ["--data_root", "a"])],
    ids=["swap", "encode", "evaluate", "export", "train_faceoff",
         "train_faceoff_gan"])
def test_every_cli_takes_no_pallas(cli, argv):
    """Each CLI parses --no_pallas and its checks let it through; the
    model configuration it builds has the kernel route off."""
    parser = (cli.build_parser() if cli is not vanilla_cli
              else tcli.build_parser())
    args = parser.parse_args([*argv, "--no_pallas"])
    if cli is vanilla_cli:
        vanilla_cli.refuse(parser, args)
    if cli is gan_cli:
        gan_cli.refuse_unported(parser, args)
    assert common.model_config(args).use_pallas_vq is False


def test_clip_lengths_come_from_the_config(tmp_path, data_root, monkeypatch):
    """The CLI reads the clip lengths from `cfg.data` where the JAX CLI
    does (`faceoff_tpu/cli/train_faceoff_perceptual.py:211,221,253,259`):
    a DataConfig that holds other lengths than the flags sets the
    datasets' windows, the resident prepare function's and loader's, and
    the validation batches'."""
    from faceoff_tpu_torch.data import resident

    made, dataset, prepare = (tconfig.DataConfig,
                              tcli.TemporalAlignmentDataset,
                              resident.make_resident_prepare)
    lengths = {}

    def other_lengths(**kwargs):
        return made(**{**kwargs, "train_frames": 5, "val_frames": 2})

    def recorded_dataset(root, mode, max_frame_len, **kwargs):
        lengths[mode] = max_frame_len
        return dataset(root, mode, max_frame_len, **kwargs)

    def recorded_prepare(corpus, clips, clip_len, **kwargs):
        lengths["prepare"] = clip_len
        return prepare(corpus, clips, clip_len, **kwargs)

    monkeypatch.setattr(tcli.config_lib, "DataConfig", other_lengths)
    monkeypatch.setattr(tcli, "TemporalAlignmentDataset", recorded_dataset)
    monkeypatch.setattr(resident, "make_resident_prepare", recorded_prepare)
    args = tcli.build_parser().parse_args(_argv(data_root, tmp_path))
    trainer, cfg = tcli.build_everything(args, device="cpu")
    assert (args.train_frames, args.val_frames) == (3, 3)
    assert (cfg.data.train_frames, cfg.data.val_frames) == (5, 2)
    assert lengths == {"train": 5, "val": 2, "prepare": 5}
    assert trainer.train_loader.clip_len == 5
    assert next(iter(trainer.val_loader))["gt"].shape[1] == 2
