"""The GAN fine-tuning stage's command line, twin of
`faceoff_tpu/cli/train_faceoff_gan.py`: one trainer for three adversarial
recipes.

    python -m faceoff_tpu_torch.cli.train_faceoff_gan \
        --data_root DATA --gan mocoganhd [--perceptual] \
        [--ckpt latest --gen_checkpoint_dir PERCEPTUAL_CKPT] [--resume latest]

--gan selects the recipe:
  mocoganhd  alternating gen/disc steps, RaLSGAN with the multiscale 2D
             content and 3D motion discriminators (`train/gan.py`);
             --perceptual adds LPIPS (and a 12-frame window)
  mocogan    one step updates the patch image and video discriminators,
             then the generator, BCE (`train/mocogan.py`)
  vqgan      alternating steps, a PatchGAN with the adaptive weight
             (`train/vqgan.py`)

The same flags and defaults as the JAX trainer. --ckpt warm-starts the
generator (weights, codebooks and step count) from a perceptual
checkpoint in --gen_checkpoint_dir; --resume restores the whole GAN
state (generator, discriminators, every optimizer) from --checkpoint_dir,
whose discriminator bundle lives in <checkpoint_dir>/disc; both
directories are used as given. Validation writes the sample streams (AVI)
and prints fd_vgg and fd_vgg_motion. Runs on CUDA; `main(argv,
device="cpu")` runs on the CPU (the tests).

--multihost trains one process a GPU over torch.distributed (NCCL on
CUDA, gloo on the CPU; the perceptual CLI's flags): each process takes
--batch_size clips of its shard a step, every step is one step on the
global batch (gradients and metrics averaged, VQ statistics summed,
BatchNorm statistics and the RaLSGAN batch means the global batch's,
the Fréchet features gathered), only process 0 writes checkpoints and
samples, and a preemption stops every process by consensus at the log
cadence. --lpips_weights auto probes local paths; --no_pallas makes
the generator's quantizers assign through the plain VQ path, in the gen
and the disc steps (`ModelConfig.use_pallas_vq`), as the JAX CLI's
`use_pallas=False` model does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os.path as osp
from typing import Any, Dict

import numpy as np
import torch

from faceoff_tpu_torch.cli import common
from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset
from faceoff_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.evaluation import make_fd_video_features
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.models.discriminators import (MultiscaleDiscriminator2D,
                                                     MultiscaleDiscriminator3D,
                                                     NLayerDiscriminator,
                                                     PatchImageDiscriminator,
                                                     PatchVideoDiscriminator,
                                                     set_process_group)
from faceoff_tpu_torch.models.lpips import (RematLPIPS, init_lpips,
                                            resolve_lpips_weights)
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.parallel.mesh import make_mesh
from faceoff_tpu_torch.train.gan import (adv_scale_schedule,
                                         create_gan_state,
                                         make_gan_multi_step, make_gan_steps)
from faceoff_tpu_torch.train.mocogan import (create_mocogan_state,
                                             make_mocogan_step)
from faceoff_tpu_torch.train.observability import (MetricsWriter,
                                                   PreemptionGuard,
                                                   StallWatchdog)
from faceoff_tpu_torch.train.state import create_train_state, make_optimizer
from faceoff_tpu_torch.train.train_step import make_eval_step
from faceoff_tpu_torch.train.trainer import run_validation
from faceoff_tpu_torch.train.vqgan import create_vqgan_state, make_vqgan_steps


def disc_bundle(state) -> Dict[str, Any]:
    """Everything in a GAN state but the generator: each discriminator's
    and optimizer's state_dict, checkpointed beside the generator so that
    a run resumes exactly."""
    return {f.name: getattr(state, f.name).state_dict()
            for f in dataclasses.fields(state) if f.name != "gen"}


def load_disc_bundle(state, bundle: Dict[str, Any]) -> None:
    """Load `disc_bundle`'s output into `state` in place."""
    for f in dataclasses.fields(state):
        if f.name != "gen":
            getattr(state, f.name).load_state_dict(bundle[f.name])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--gan", choices=["mocoganhd", "mocogan", "vqgan"],
                   default="mocoganhd")
    p.add_argument("--perceptual", action="store_true")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--epoch", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--disc_lr", type=float, default=3e-4)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--train_frames", type=int, default=30)
    p.add_argument("--sample_frames", type=int, default=16,
                   help="discriminator clip window (12 in the perceptual "
                        "variant)")
    p.add_argument("--validate_at", type=int, default=1024)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--ckpt", default=None,
                   help="step or 'latest': initialize the generator from a "
                        "perceptual-stage checkpoint in --gen_checkpoint_dir")
    p.add_argument("--load_disc", action="store_true",
                   help="with --ckpt: also restore the discriminators and "
                        "their optimizers from <gen_checkpoint_dir>/disc")
    p.add_argument("--resume", default=None,
                   help="step or 'latest': resume the whole GAN state "
                        "(generator, discriminators, every optimizer) from "
                        "--checkpoint_dir")
    p.add_argument("--gen_checkpoint_dir", default=None,
                   help="checkpoint dir of the pretrained generator")
    p.add_argument("--checkpoint_dir", default="gan_checkpoint")
    p.add_argument("--sample_folder", default="gan_samples",
                   help="validation sample streams are written here at the "
                        "--validate_at cadence")
    p.add_argument("--metrics_path", default=None,
                   help="append-only JSONL scalar log (one line per step)")
    p.add_argument("--stall_timeout", type=float, default=0.0,
                   help="exit 117 after this many seconds without a "
                        "finished step, for a supervisor to restart with "
                        "--resume; 0 disables")
    p.add_argument("--val_frames", type=int, default=30)
    p.add_argument("--val_batches", type=int, default=2)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--lpips_weights", default=None,
                   help=".npz from tools/convert_lpips.py, or 'auto' to "
                        "probe local paths")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=None,
                   help="optional cap on total steps (smoke runs); with "
                        "--steps_per_call it rounds up to the next call "
                        "boundary")
    p.add_argument("--device_pipeline", action="store_true",
                   help="decode clips on the host, build the training input "
                        "on the card (all recipes)")
    p.add_argument("--resident_data", action="store_true",
                   help="stage the whole decoded corpus on the card once; "
                        "clip sampling and the training input run inside "
                        "each step (all recipes; steps_per_call=1)")
    p.add_argument("--resident_max_frames", type=int, default=None,
                   help="cap decoded frames per video in the resident "
                        "corpus")
    p.add_argument("--resident_hbm_budget_gib", type=float, default=8.0,
                   help="refuse to stage a resident corpus estimated above "
                        "this many GiB")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="K alternating gen/disc steps per call (mocoganhd "
                        "only; even K)")
    common.add_model_flags(p)
    p.add_argument("--ndf", type=int, default=64,
                   help="discriminator base width")
    p.add_argument("--disc_noise", type=float, default=0.0,
                   help="mocogan: additive gaussian input-noise sigma for "
                        "the discriminators (0 = off)")
    p.add_argument("--g2d_weight", type=float, default=0.25,
                   help="mocoganhd: weight of the 2D adversarial generator "
                        "term")
    p.add_argument("--g3d_weight", type=float, default=0.25,
                   help="mocoganhd: weight of the 3D adversarial generator "
                        "term")
    p.add_argument("--img_disc_weight", type=float, default=0.5,
                   help="mocogan: generator-side image-disc weight")
    p.add_argument("--vid_disc_weight", type=float, default=0.5,
                   help="mocogan: generator-side video-disc weight")
    p.add_argument("--adversarial_start", type=int, default=0,
                   help="mocoganhd: zero the generator's adversarial terms "
                        "for this many steps of the run")
    p.add_argument("--adversarial_ramp", type=int, default=0,
                   help="mocoganhd: ramp the adversarial terms linearly "
                        "0->1 over this many steps after "
                        "--adversarial_start (0 = hard switch)")
    p.add_argument("--multihost", action="store_true",
                   help="one process a GPU over torch.distributed")
    common.add_curation_flags(p)
    common.add_multihost_flags(p)
    return p


def refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """Exit with an error for a combination the steps do not take."""
    if args.steps_per_call > 1 and args.gan != "mocoganhd":
        parser.error("--steps_per_call supports --gan mocoganhd only")
    if args.steps_per_call > 1 and args.steps_per_call % 2 != 0:
        parser.error("--steps_per_call must be even (gen/disc pairs per "
                     "call)")
    if args.resident_data and args.steps_per_call > 1:
        parser.error("--resident_data supports steps_per_call=1 (each step "
                     "samples and prepares its own clips on the card)")


def _loaders(args, ds, dev, local_clips):
    """(train loader, prepare_fn) for the three input paths, each process
    taking `local_clips` clips of its own shard a step."""
    rank, world = collectives.get_rank(), collectives.get_world_size()
    if args.resident_data:
        from faceoff_tpu_torch.data.resident import (ResidentBatches,
                                                     build_resident_corpus,
                                                     make_resident_prepare)

        corpus = build_resident_corpus(
            ds, max_frames_per_video=args.resident_max_frames,
            hbm_budget_bytes=int(args.resident_hbm_budget_gib * 2**30),
            device=dev)
        print(f"resident corpus staged: {corpus.n_videos} videos, "
              f"{corpus.nbytes / 2**20:.0f} MiB on {dev}", flush=True)
        return (ResidentBatches(corpus, max(1, len(ds) // local_clips),
                                clips_per_step=local_clips,
                                clip_len=args.train_frames),
                make_resident_prepare(corpus, local_clips,
                                      args.train_frames))
    if args.device_pipeline:
        from faceoff_tpu_torch.data.device_pipeline import (
            RawClipLoader, prepare_train_batch)

        return (RawClipLoader(ds, batch_clips=local_clips,
                              num_workers=args.num_workers, seed=args.seed,
                              shard_index=rank, shard_count=world),
                prepare_train_batch)
    return DataLoader(ds, batch_clips=local_clips,
                      num_workers=args.num_workers, seed=args.seed,
                      shard_index=rank, shard_count=world), None


def _recipe(args, model, gen_state, lpips, prepare_fn, dev, group=None):
    """(state, run_step(state, batch, step_count), multi_step or None);
    across processes the discriminators and every step reduce over
    `group`."""
    disc_gen = torch.Generator().manual_seed(args.seed + 2)
    seed = args.seed
    lpips_kw = dict(lpips=lpips, prepare_fn=prepare_fn,
                    perceptual_loss_weight=1.0 if args.perceptual else 0.0,
                    process_group=group)
    if args.gan == "mocoganhd":
        d_img = MultiscaleDiscriminator2D(ndf=args.ndf, device=dev,
                                          generator=disc_gen)
        d_3d = MultiscaleDiscriminator3D(ndf=args.ndf,
                                         n_frames=args.sample_frames,
                                         device=dev, generator=disc_gen)
        for d in (d_img, d_3d):
            set_process_group(d, group)
        state = create_gan_state(gen_state, d_img, d_3d,
                                 disc_lr=args.disc_lr)
        step_kwargs = dict(sample_frames=args.sample_frames,
                           g_2d_weight=args.g2d_weight,
                           g_3d_weight=args.g3d_weight, **lpips_kw)
        gen_step, disc_step = make_gan_steps(model, d_img, d_3d, **step_kwargs)
        multi = (make_gan_multi_step(model, d_img, d_3d, args.steps_per_call,
                                     **step_kwargs)
                 if args.steps_per_call > 1 else None)

        def run_step(state, batch, step_count):
            # alternate gen/disc; metrics stay on the device until the log
            if step_count % 2 == 0:
                scale = adv_scale_schedule(step_count,
                                           start=args.adversarial_start,
                                           ramp=args.adversarial_ramp)
                state, m = gen_step(state, batch, seed, scale)
                return state, {**m, "adv_scale": scale}
            return disc_step(state, batch, seed)

        return state, run_step, multi

    if args.gan == "mocogan":
        noise = dict(use_noise=args.disc_noise > 0,
                     noise_sigma=args.disc_noise, device=dev,
                     generator=disc_gen)
        d_img = PatchImageDiscriminator(ndf=args.ndf, **noise)
        d_vid = PatchVideoDiscriminator(ndf=args.ndf, **noise)
        for d in (d_img, d_vid):
            set_process_group(d, group)
        state = create_mocogan_state(gen_state, d_img, d_vid,
                                     disc_lr=args.disc_lr)
        step = make_mocogan_step(model, d_img, d_vid,
                                 image_disc_weight=args.img_disc_weight,
                                 video_disc_weight=args.vid_disc_weight,
                                 **lpips_kw)
        return state, lambda st, b, n: step(st, b, seed), None

    disc = NLayerDiscriminator(ndf=args.ndf, device=dev, generator=disc_gen)
    set_process_group(disc, group)
    state = create_vqgan_state(gen_state, disc, disc_lr=args.disc_lr)
    gen_step, disc_step = make_vqgan_steps(model, disc, lpips=lpips,
                                           prepare_fn=prepare_fn,
                                           process_group=group)

    def run_step(state, batch, step_count):
        if step_count % 2 == 0:
            return gen_step(state, batch, seed)
        return disc_step(state, batch, seed)

    return state, run_step, None


def main(argv=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Parse `argv` and train on `device` (CUDA unless named). Returns
    {"state", "step", "checkpoint_dir", "fd"} (the last validation's
    Fréchet distances, or None)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    common.init_multihost(args, device)
    args.lpips_weights = resolve_lpips_weights(args.lpips_weights)
    if args.perceptual and args.sample_frames == 16:
        args.sample_frames = 12
    print(args, flush=True)
    dev = resolve_device(device)
    mesh = make_mesh()
    world = collectives.get_world_size()
    primary = collectives.is_primary()
    group = collectives.default_group()
    # each process's share of the global batch of batch_size clips a device
    local_clips = max(1, args.batch_size * mesh.size // world)
    local_val_clips = max(1, mesh.size // world)

    model = common.build_vqvae(args, device=dev)
    model.set_process_group(group)
    ds = TemporalAlignmentDataset(
        args.data_root, "train", args.train_frames, resolution=args.size,
        exclude_list=args.exclude_list, device=dev)
    loader, prepare_fn = _loaders(args, ds, dev, local_clips)
    gen_state = create_train_state(
        model, make_optimizer(model.parameters(), args.lr))

    # warm start from a perceptual-stage checkpoint
    if args.ckpt is not None:
        src_dir = args.gen_checkpoint_dir or args.checkpoint_dir
        step = None if args.ckpt == "latest" else int(args.ckpt)
        CheckpointManager(src_dir).restore_weights(gen_state, step)
        print(f"generator warm-started from {src_dir} @ step "
              f"{gen_state.step}", flush=True)

    # LPIPS is also the Fréchet distances' feature extractor: always built
    fd_lpips = init_lpips(torch.Generator().manual_seed(args.seed + 1),
                          weights_npz=args.lpips_weights, device=dev)
    lpips = None
    if args.perceptual or args.gan == "vqgan":
        lpips = RematLPIPS(fd_lpips) if args.remat_lpips else fd_lpips
    state, run_step, multi_step = _recipe(args, model, gen_state, lpips,
                                          prepare_fn, dev, group)

    ckpt = CheckpointManager(args.checkpoint_dir)
    disc_ckpt = CheckpointManager(osp.join(args.checkpoint_dir, "disc"))
    step0 = 0
    if args.resume == "latest" and ckpt.latest_step() is None:
        # a supervisor may always pass --resume latest: the first launch
        # falls through to the warm start or a fresh state
        print("--resume latest: no checkpoint yet; starting fresh",
              flush=True)
        args.resume = None
    if args.resume is not None:
        step = (ckpt.latest_step() if args.resume == "latest"
                else int(args.resume))
        ckpt.restore(state.gen, step, seed=args.seed)
        load_disc_bundle(state, disc_ckpt.restore_tree(step))
        step0 = int(step)
        print(f"resumed the whole GAN state @ step {step0}", flush=True)
    elif args.ckpt is not None and args.load_disc:
        src_dir = args.gen_checkpoint_dir or args.checkpoint_dir
        step = None if args.ckpt == "latest" else int(args.ckpt)
        load_disc_bundle(state, CheckpointManager(
            osp.join(src_dir, "disc")).restore_tree(step))
        print(f"discriminators restored from {src_dir}/disc", flush=True)

    eval_step = make_eval_step(model)
    val_ds = TemporalAlignmentDataset(
        args.data_root, "val", args.val_frames, resolution=args.size,
        exclude_list=args.exclude_list, device=dev)
    val_loader = DataLoader(val_ds, batch_clips=local_val_clips,
                            shuffle=False, num_workers=2, seed=args.seed,
                            shard_index=collectives.get_rank(),
                            shard_count=world)
    metrics_writer = (MetricsWriter(args.metrics_path)
                      if args.metrics_path and primary else None)
    preemption = PreemptionGuard()
    watchdog = StallWatchdog(args.stall_timeout)
    fd_feats, fd_finalize = make_fd_video_features(fd_lpips)
    last_fd = None

    def save_all(step_count):
        def write():
            ckpt.save(step_count, state.gen, seed=args.seed)
            disc_ckpt.save_tree(step_count, disc_bundle(state))

        collectives.run_on_primary(write)

    def validate(epoch, step_count):
        nonlocal last_fd
        run_validation(eval_step, state.gen, val_loader, args.sample_folder,
                       epoch, step_count, max_batches=args.val_batches)
        # Fréchet distances of real and generated clips in VGG feature
        # space, over all --val_batches batches at once
        chunks = []
        for bi, host in enumerate(val_loader):
            if bi >= args.val_batches:
                break
            batch = {k: torch.from_numpy(np.asarray(host[k])).to(dev)
                     for k in ("input", "gt")}
            out, _ = eval_step(state.gen, batch)
            chunks.append(fd_feats(batch["gt"], out.to(torch.float32)))
        if world > 1:
            # the features of every process's validation shard
            chunks = [{k: collectives.all_gather_rows(c[k], group)
                       for k in c} for c in chunks]
        last_fd = {k: float(v) for k, v in fd_finalize(chunks).items()}
        if primary:
            print(" ".join(f"{k}: {v:.4f}" for k, v in last_fd.items()),
                  flush=True)
        if metrics_writer is not None:
            metrics_writer.write(step_count, last_fd, epoch=epoch)
            metrics_writer.flush()
        save_all(step_count)

    def device_batches():
        if getattr(loader, "is_resident", False):
            yield from loader
        else:
            yield from prefetch_to_device(iter(loader), dev)

    step_count = step0
    pending = []  # (step, epoch, metrics on the device): read at the log
    spc = args.steps_per_call if multi_step is not None else 1
    acc = []  # micro-batches accumulated for steps_per_call > 1
    last_log = last_val = step0
    # the budget counts the steps restored by --resume: --epoch is the
    # run's total, so a restarted run finishes the original budget
    steps_per_epoch = max(len(loader), 1)
    step_budget = args.epoch * steps_per_epoch

    def delivered(e):
        # steps trained by e whole epochs: with K steps a call the
        # micro-batches carry across epoch boundaries
        if spc <= 1:
            return e * steps_per_epoch
        return (e * steps_per_epoch // spc) * spc

    start_epoch = 0
    while start_epoch < args.epoch and delivered(start_epoch + 1) <= step0:
        start_epoch += 1
    if start_epoch:
        print(f"resume at step {step0}: {start_epoch}/{args.epoch} epochs "
              f"already done (budget {step_budget} steps)", flush=True)
    done = False
    try:
        for epoch in range(start_epoch, args.epoch):
            for batch in device_batches():
                batch = {k: v for k, v in batch.items()
                         if k in ("input", "gt", "frames", "landmarks")}
                if spc > 1 and not (step_count % 2 == 1 and not acc):
                    acc.append(batch)
                    if len(acc) < spc:
                        continue
                    stacked = {k: torch.stack([b[k] for b in acc])
                               for k in acc[0]}
                    acc = []
                    scale = adv_scale_schedule(
                        step_count, start=args.adversarial_start,
                        ramp=args.adversarial_ramp)
                    state, seq = multi_step(state, stacked, args.seed, scale)
                    for j in range(spc):
                        part = "gen" if j % 2 == 0 else "disc"
                        step_count += 1
                        pending.append((step_count, epoch, {
                            k: v[j // 2] for k, v in seq[part].items()}))
                else:
                    # one step; with K a call, an odd resumed step first
                    # takes the disc step alone to realign the pairs
                    state, m = run_step(state, batch, step_count)
                    step_count += 1
                    pending.append((step_count, epoch, m))
                watchdog.beat()
                log_now = step_count - last_log >= args.log_every
                if log_now:
                    last_log = step_count
                    for s, e, pm in pending:
                        vals = {k: float(v) for k, v in pm.items()}
                        if metrics_writer is not None:
                            metrics_writer.write(s, vals, epoch=e)
                    line = " ".join(f"{k}: {v:.5f}" for k, v in vals.items())
                    if primary:
                        print(f"epoch {epoch + 1} step {step_count}; {line}",
                              flush=True)
                    pending.clear()
                    if metrics_writer is not None:
                        metrics_writer.flush()
                # across processes: stop by consensus at the log cadence,
                # which every process reaches at the same step
                if (preemption.should_stop if world == 1 else
                        log_now and preemption.should_stop_global(dev)):
                    print("preemption: saving the whole GAN state",
                          flush=True)
                    save_all(step_count)
                    done = True
                    break
                if step_count - last_val >= args.validate_at:
                    last_val = step_count
                    validate(epoch, step_count)
                if step_count >= step_budget or (
                        args.steps and step_count >= args.steps):
                    done = True
                    break
            if done:
                break
        if acc:
            print(f"note: {len(acc)} accumulated micro-batch(es) below the "
                  f"--steps_per_call={spc} call size were not trained",
                  flush=True)
        pending.clear()
        save_all(max(step_count, 1))
    finally:
        watchdog.stop()
        preemption.restore()
        if metrics_writer is not None:
            metrics_writer.close()
    print(f"done: {step_count} steps; the whole GAN state saved "
          f"(generator in {args.checkpoint_dir}, discriminators in "
          f"{args.checkpoint_dir}/disc)", flush=True)
    return {"state": state, "step": step_count,
            "checkpoint_dir": args.checkpoint_dir, "fd": last_fd}


if __name__ == "__main__":
    main()
