"""The GAN trainer's command line on the CPU at narrow widths (channel 16,
32 px, discriminators at ndf 8) on a tiny PNG dataset, warm-started from
a perceptual checkpoint: a resumed run equals the same run continued
(bitwise: the CPU steps are deterministic), --load_disc restores the
discriminators and their optimizers, every recipe trains and validates,
the parser matches the JAX parser, and the flags the port lacks exit
naming their item."""

import json
import shutil

import pytest
import torch

from faceoff_tpu.cli import train_faceoff_gan as jcli
from faceoff_tpu_torch.cli import train_faceoff_gan as gcli
from faceoff_tpu_torch.cli import train_faceoff_perceptual as pcli
from faceoff_tpu_torch.data.synthetic import generate_dataset

NARROW = ["--channel", "16", "--n_res_channel", "8", "--embed_dim", "8",
          "--n_embed", "16", "--num_workers", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """A PNG dataset of 3 videos x 8 frames at 32 px and a perceptual
    checkpoint (2 steps) to warm-start from."""
    root = tmp_path_factory.mktemp("gan_cli")
    generate_dataset(str(root / "data"), 3, 8, 32, seed=1)
    pcli.main(["--data_root", str(root / "data"), "--resident_data",
               "--size", "32", "--batch_size", "3", "--train_frames", "4",
               "--val_frames", "4", "--epoch", "2", "--validate_at", "100",
               "--checkpoint_dir", str(root / "pckpt"),
               "--sample_folder", str(root / "psamples"), *NARROW],
              device="cpu")
    (ckpt,) = root.glob("pckpt_*")
    return root, ckpt


def _run(root, ckpt, name, *extra):
    return gcli.main(
        ["--data_root", str(root / "data"), "--resident_data", "--size", "32",
         "--train_frames", "4", "--sample_frames", "4", "--val_frames", "4",
         "--val_batches", "1", "--ndf", "8", "--log_every", "1",
         "--epoch", "100", "--ckpt", "latest",
         "--gen_checkpoint_dir", str(ckpt),
         "--checkpoint_dir", str(root / f"ckpt_{name}"),
         "--sample_folder", str(root / f"samples_{name}"),
         "--metrics_path", str(root / f"metrics_{name}.jsonl"),
         *NARROW, *extra], device="cpu")


def _tensors(state):
    out = {f"gen.{k}": v for k, v in state.gen.model.state_dict().items()}
    for name, sd in gcli.disc_bundle(state).items():
        if "state" in sd:  # an optimizer: its moments and step counts
            for i, st in sd["state"].items():
                out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
        else:
            out.update({f"{name}.{k}": v for k, v in sd.items()})
    return out


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.gen.step == b.gen.step


def _records(path):
    with open(path) as f:
        return {r["step"]: {k: v for k, v in r.items()
                            if k not in ("time", "epoch")}
                for r in map(json.loads, f) if "fd_vgg" not in r}


def test_resume_equals_the_unbroken_run(warm):
    """4 mocoganhd steps validating (and checkpointing) every 2, against
    the step-2 checkpoints of that run resumed with --resume latest:
    every parameter, buffer and optimizer moment, and the metrics of
    steps 3-4, bitwise equal; the generator warm-started at the
    perceptual checkpoint's step."""
    root, ckpt = warm
    run_a = _run(root, ckpt, "a", "--steps", "4", "--validate_at", "2")
    assert run_a["step"] == 4 and set(run_a["fd"]) == {"fd_vgg",
                                                       "fd_vgg_motion"}
    assert run_a["state"].gen.step == 2 + 2  # warm start at 2, 2 gen steps
    resumed = root / "ckpt_r"
    (resumed / "disc").mkdir(parents=True)
    for sub in ("", "disc"):
        shutil.copy(root / "ckpt_a" / sub / "ckpt_00000002.pt",
                    resumed / sub)
    run_r = _run(root, ckpt, "r", "--steps", "4", "--validate_at", "2",
                 "--resume", "latest")
    _assert_same(run_r["state"], run_a["state"])
    rec_a, rec_r = (_records(root / f"metrics_{n}.jsonl") for n in "ar")
    assert sorted(rec_r) == [3, 4]
    assert all(rec_r[s] == rec_a[s] for s in (3, 4))
    assert set(rec_a[1]) >= {"g_loss", "g_2d", "g_3d", "adv_scale"}
    assert set(rec_a[2]) >= {"d_3d_loss", "d_img_loss"}
    streams = sorted((root / "samples_a").glob("*.mp4"))
    assert len(streams) == 2 * 4  # two validations of one batch


def test_load_disc_restores_the_discriminators(warm):
    """A run warm-started with --ckpt latest --load_disc from another GAN
    run's directory takes its discriminators and their optimizers; no
    step is taken (--epoch 0)."""
    root, ckpt = warm
    src = _run(root, ckpt, "src", "--steps", "2", "--validate_at", "100")
    loaded = gcli.main(
        ["--data_root", str(root / "data"), "--resident_data", "--size", "32",
         "--train_frames", "4", "--sample_frames", "4", "--ndf", "8",
         "--epoch", "0", "--ckpt", "latest", "--load_disc",
         "--gen_checkpoint_dir", str(root / "ckpt_src"),
         "--checkpoint_dir", str(root / "ckpt_loaded"), *NARROW],
        device="cpu")
    _assert_same(loaded["state"], src["state"])
    fresh = _run(root, ckpt, "fresh", "--epoch", "0")
    assert not torch.equal(fresh["state"].d_3d.scales[0].convs[1].weight,
                           src["state"].d_3d.scales[0].convs[1].weight)


@pytest.mark.parametrize("recipe", [["--gan", "mocogan"], ["--gan", "vqgan"],
                                    ["--perceptual"],
                                    ["--steps_per_call", "2"]])
def test_recipes_train_and_validate(warm, recipe):
    """Each recipe takes 4 steps and validates; mocogan's patch
    discriminators need 64 px and 16 frames, so it runs there."""
    root, ckpt = warm
    extra = list(recipe)
    if recipe[-1] == "mocogan":
        generate_dataset(str(root / "data64"), 2, 16, 64, seed=2)
        extra += ["--data_root", str(root / "data64"), "--size", "64",
                  "--train_frames", "16", "--val_frames", "16", "--ndf", "4"]
    if recipe[0] == "--steps_per_call":  # host batches, two steps a call
        extra = ["--batch_size", "1", "--steps_per_call", "2"]
    argv_tail = ["--steps", "4", "--validate_at", "4", *extra]
    if recipe[0] == "--steps_per_call":
        res = gcli.main(
            ["--data_root", str(root / "data"), "--size", "32",
             "--train_frames", "4", "--sample_frames", "4", "--val_frames",
             "4", "--val_batches", "1", "--ndf", "8", "--log_every", "1",
             "--epoch", "100", "--checkpoint_dir", str(root / "ckpt_spc"),
             "--sample_folder", str(root / "samples_spc"), *NARROW,
             *argv_tail], device="cpu")
    else:
        res = _run(root, ckpt, recipe[-1].strip("-"), *argv_tail)
    assert res["step"] == 4 and res["fd"] is not None
    assert all(map(lambda v: v == v, res["fd"].values()))


def test_parser_matches_jax():
    """The same option strings, and the same default for every one."""
    def options(parser):
        return {s: a.default for a in parser._actions for s in
                a.option_strings if s not in ("-h", "--help")}

    assert options(gcli.build_parser()) == options(jcli.build_parser())


@pytest.mark.parametrize("flags,item", [
    (["--multihost"], "Queue 1 item 6"),
    (["--process_id", "0"], "Queue 1 item 6"),
    (["--lpips_weights", "auto"], "Queue 1 item 7"),
    (["--no_pallas"], "North star")])
def test_refused_flags_exit_naming_their_item(flags, item):
    """--multihost and its coordination flags were refused until Queue 1
    item 6 was ported, --lpips_weights auto until item 7(a), --no_pallas
    (naming the North star) until item 11; now they pass the check
    (multi-process GAN steps: tests/test_torch_parallel.py; --no_pallas:
    tests/test_torch_no_pallas.py)."""
    parser = gcli.build_parser()
    gcli.refuse_unported(parser, parser.parse_args(
        ["--data_root", "unused", *flags]))


@pytest.mark.parametrize("flags,message", [
    (["--gan", "vqgan", "--steps_per_call", "2"], "mocoganhd only"),
    (["--steps_per_call", "3"], "must be even"),
    (["--resident_data", "--steps_per_call", "2"], "steps_per_call=1")])
def test_unsupported_combinations_exit(capsys, flags, message):
    with pytest.raises(SystemExit):
        gcli.main(["--data_root", "unused", *flags], device="cpu")
    assert message in capsys.readouterr().err
