"""The perceptual trainer's command line, twin of
`faceoff_tpu/cli/train_faceoff_perceptual.py`:

    python -m faceoff_tpu_torch.cli.train_faceoff_perceptual \
        --data_root DIR --resident_data --batch_size 16 --train_frames 8 \
        [--sched cycle] [--validate_at N] [--ckpt latest|STEP] ...

The same flags and defaults as the JAX trainer. --resident_data stages
the decoded corpus on the card and samples and prepares every step's
clips there; --device_pipeline decodes clips on the host and prepares
them on the card; by default host workers build whole items. Runs on
CUDA; `main(argv, device="cpu")` runs on the CPU (the tests).

--multihost trains one process a GPU over torch.distributed (NCCL on
CUDA, gloo on the CPU; one NCCL process a GPU), joined with
--coordinator_address/--num_processes/--process_id or the torchrun
environment: each process takes --batch_size clips of its shard of the
data a step, the step averages the gradients and sums the VQ statistics
over the processes (`train/shardmap_step.py`), and only process 0
writes checkpoints and samples. --lpips_weights auto probes local paths
(`models.lpips.discover_lpips_weights`). --no_pallas is refused: on the
card the port always runs its CUDA kernels. Checkpoints are
`torch.save` files of the full train state; sample streams are AVI
files.
"""

from __future__ import annotations

import argparse
import functools
import random
import string
import time

import torch

from faceoff_tpu_torch import config as config_lib
from faceoff_tpu_torch.cli import common
from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset
from faceoff_tpu_torch.data.pipeline import DataLoader
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.models.lpips import (RematLPIPS, init_lpips,
                                            resolve_lpips_weights)
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.parallel.mesh import make_mesh
from faceoff_tpu_torch.train.shardmap_step import make_shardmap_train_step
from faceoff_tpu_torch.train.state import create_train_state, make_optimizer
from faceoff_tpu_torch.train.train_step import (make_eval_step,
                                                make_multi_step,
                                                make_train_step)
from faceoff_tpu_torch.train.trainer import Trainer, run_validation


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--batch_size", type=int, default=1,
                   help="clips per step")
    p.add_argument("--size", type=int, default=256, help="image resolution")
    p.add_argument("--epoch", type=int, default=560)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--sched", type=str, default="")
    p.add_argument("--validate_at", type=int, default=1024)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint step to resume (or 'latest')")
    p.add_argument("--test", action="store_true")
    p.add_argument("--gray", action="store_true")
    p.add_argument("--colorjit", type=str, default="",
                   help="const or random or empty")
    p.add_argument("--crossid", action="store_true")
    p.add_argument("--custom_validation", action="store_true")
    p.add_argument("--sample_folder", type=str, default="samples")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoint")
    p.add_argument("--validation_folder", type=str, default=None)
    p.add_argument("--train_frames", type=int, default=30)
    p.add_argument("--val_frames", type=int, default=50)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--lpips_weights", type=str, default=None,
                   help=".npz from tools/convert_lpips.py, or 'auto' to "
                        "probe local paths")
    common.add_model_flags(p)
    p.add_argument("--device_pipeline", action="store_true",
                   help="decode clips on the host, build the training "
                        "input on the card")
    p.add_argument("--resident_data", action="store_true",
                   help="stage the whole decoded corpus on the card once; "
                        "clip sampling and the training input run inside "
                        "each step")
    p.add_argument("--resident_max_frames", type=int, default=None,
                   help="cap decoded frames per video in the resident "
                        "corpus")
    p.add_argument("--resident_hbm_budget_gib", type=float, default=8.0,
                   help="refuse to stage a resident corpus estimated above "
                        "this many GiB")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help=">1: that many optimizer steps per step call")
    p.add_argument("--metrics_path", type=str, default=None,
                   help="append per-step scalars as JSONL")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10-15")
    p.add_argument("--stall_timeout", type=float, default=0.0,
                   help="exit 117 after this many seconds without a "
                        "finished step, for a supervisor to restart with "
                        "--ckpt latest; 0 disables")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multihost", action="store_true",
                   help="one process a GPU over torch.distributed")
    common.add_curation_flags(p)
    common.add_multihost_flags(p)
    p.add_argument("--commitment_beta", type=float, default=1.0,
                   help="scales the VQ commitment (latent) term")
    p.add_argument("--revive_every", type=int, default=0,
                   help="re-seed EMA-dead VQ codes every N steps (0 = off)")
    return p


def refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """Exit with an error for a flag whose function the port lacks: only
    --no_pallas (the port has no path around its kernels on the card)."""
    common.refuse_no_pallas(parser, args)


def random_run_name(n: int = 5) -> str:
    """The run directories' suffix."""
    return "".join(random.choices(string.ascii_lowercase + string.digits,
                                  k=n))


def build_everything(args, device: DeviceLike = None, *,
                     perceptual: bool = True):
    """(trainer, cfg) of the flags on `device`. perceptual=False builds no
    LPIPS and a step without the perceptual term (`cli/train_faceoff`).
    Across processes each takes --batch_size clips of its own shard a
    step, through the shardmap step."""
    dev = resolve_device(device)
    mesh = make_mesh()
    world, rank = collectives.get_world_size(), collectives.get_rank()
    # each process's share of the global batch of batch_size clips a device
    local_clips = max(1, args.batch_size * mesh.size // world)
    local_val_clips = max(1, mesh.size // world)
    group = collectives.default_group()
    cfg = config_lib.Config(
        model=common.model_config(args),
        data=config_lib.DataConfig(
            data_root=args.data_root,
            resolution=args.size,
            train_frames=args.train_frames,
            val_frames=args.val_frames,
            batch_clips=args.batch_size,
            color_jitter=args.colorjit,
            grayscale=args.gray,
            num_workers=args.num_workers,
        ),
        train=config_lib.TrainConfig(
            lr=args.lr,
            epochs=args.epoch,
            validate_at=args.validate_at,
            sched=args.sched,
            seed=args.seed,
            revive_codes_every=args.revive_every,
            checkpoint_dir=args.checkpoint_dir,
            sample_folder=args.sample_folder,
        ),
    )
    model = common.build_vqvae(args, cfg.model.in_channels, device=dev)
    model.set_process_group(group)

    train_ds = TemporalAlignmentDataset(
        args.data_root, "train", args.train_frames,
        resolution=args.size, color_jitter_type=args.colorjit,
        grayscale=args.gray, exclude_list=args.exclude_list, device=dev)
    val_ds = TemporalAlignmentDataset(
        args.validation_folder or args.data_root, "val",
        args.val_frames, resolution=args.size,
        color_jitter_type=args.colorjit, cross_identity=args.crossid,
        grayscale=args.gray,
        custom_validation_source=(args.data_root if args.custom_validation
                                  else None),
        exclude_list=args.exclude_list, device=dev)
    prepare_fn = None
    if args.resident_data:
        from faceoff_tpu_torch.data.resident import (ResidentBatches,
                                                     build_resident_corpus,
                                                     make_resident_prepare)

        t0 = time.perf_counter()
        corpus = build_resident_corpus(
            train_ds, max_frames_per_video=args.resident_max_frames,
            hbm_budget_bytes=int(args.resident_hbm_budget_gib * 2**30),
            device=dev)
        print(f"resident corpus staged: {corpus.n_videos} videos, "
              f"{corpus.frames.shape[1]} max frames, "
              f"{corpus.nbytes / 2**20:.0f} MiB on {dev} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        prepare_fn = make_resident_prepare(
            corpus, local_clips, args.train_frames,
            color_jitter=args.colorjit)
        train_loader = ResidentBatches(
            corpus, max(1, len(train_ds) // local_clips),
            args.steps_per_call, clips_per_step=local_clips,
            clip_len=args.train_frames)
    elif args.device_pipeline:
        from faceoff_tpu_torch.data.device_pipeline import (
            RawClipLoader, prepare_train_batch)

        train_loader = RawClipLoader(train_ds, batch_clips=local_clips,
                                     num_workers=args.num_workers,
                                     seed=args.seed, shard_index=rank,
                                     shard_count=world)
        prepare_fn = functools.partial(prepare_train_batch,
                                       color_jitter=args.colorjit)
    else:
        train_loader = DataLoader(train_ds, batch_clips=local_clips,
                                  num_workers=args.num_workers,
                                  seed=args.seed, shard_index=rank,
                                  shard_count=world)
    val_loader = DataLoader(val_ds, batch_clips=local_val_clips,
                            shuffle=False, num_workers=args.num_workers,
                            seed=args.seed, shard_index=rank,
                            shard_count=world)

    steps_per_epoch = max(len(train_loader), 1)
    opt = make_optimizer(model.parameters(), args.lr, args.sched,
                         n_iter=steps_per_epoch * args.epoch,
                         warmup_proportion=0.05)
    state = create_train_state(model, opt)
    lpips = None
    if perceptual:
        lpips = init_lpips(torch.Generator().manual_seed(args.seed + 1),
                           weights_npz=resolve_lpips_weights(
                               args.lpips_weights), device=dev)
        if args.remat_lpips:
            lpips = RematLPIPS(lpips)

    step_kwargs = dict(
        latent_loss_weight=cfg.train.latent_loss_weight,
        perceptual_loss_weight=(cfg.train.perceptual_loss_weight
                                if perceptual else 0.0),
        lpips=lpips, prepare_fn=prepare_fn)
    if args.steps_per_call > 1:
        # a resident corpus: every inner step takes the same staged batch
        train_step = make_multi_step(model, args.steps_per_call,
                                     scan_batches=not args.resident_data,
                                     process_group=group, **step_kwargs)
    elif group is not None:
        train_step = make_shardmap_train_step(model, mesh,
                                              process_group=group,
                                              **step_kwargs)
    else:
        train_step = make_train_step(model, **step_kwargs)
    trainer = Trainer(
        cfg, model, state, train_step, make_eval_step(model), train_loader,
        val_loader, metrics_path=args.metrics_path,
        profile_dir=args.profile_dir, steps_per_call=args.steps_per_call,
        stall_timeout=args.stall_timeout)
    return trainer, cfg


def main(argv=None, device: DeviceLike = None) -> Trainer:
    """Parse `argv`, build the trainer on `device` (CUDA unless named),
    resume with --ckpt, then validate (--test) or train. Returns the
    trainer."""
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    common.init_multihost(args, device)
    run = common.shared_run_name() if args.multihost else random_run_name()
    args.sample_folder = f"{args.sample_folder}_{run}"
    # with --ckpt the checkpoint directory is used as it is, to resume it
    if not args.ckpt:
        args.checkpoint_dir = f"{args.checkpoint_dir}_{run}"
    print(args, flush=True)

    trainer, cfg = build_everything(args, device)
    return resume_and_run(args, trainer, cfg)


def resume_and_run(args, trainer: Trainer, cfg,
                   missing: str = "--ckpt latest: no checkpoint in {} yet; "
                                  "training from scratch") -> Trainer:
    """Resume with --ckpt, then validate (--test) or train. `missing` is
    the message for --ckpt latest without a checkpoint in the directory
    ({} its path)."""
    if args.ckpt == "latest":
        # resume if there is a checkpoint, else train from scratch, so that
        # a supervisor may always pass --ckpt latest
        if trainer.ckpt.latest_step() is None:
            print(missing.format(trainer.ckpt.directory), flush=True)
        else:
            trainer.resume(None)
    elif args.ckpt:
        trainer.resume(int(args.ckpt))

    if args.test:
        run_validation(trainer.eval_step, trainer.state, trainer.val_loader,
                       cfg.train.sample_folder, epoch=0, step=0)
    else:
        trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
