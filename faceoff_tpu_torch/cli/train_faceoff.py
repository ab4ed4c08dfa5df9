"""The vanilla trainer's command line, twin of
`faceoff_tpu/cli/train_faceoff.py`: the perceptual trainer's flags with
the loss MSE + latent only. No LPIPS is built and no VGG runs.

    python -m faceoff_tpu_torch.cli.train_faceoff --data_root DATA ...

The JAX CLI rebuilds the step as `make_train_step(model,
perceptual_loss_weight=0.0, lpips_apply=None)`, which drops the
`prepare_fn` of --resident_data and --device_pipeline (its step then
fails with KeyError 'input') and hands --steps_per_call's K-step batches
to a one-step function; nor does it join a process group for
--multihost. ROADMAP.md Queue 3 records this fault of the reference.
The port reproduces it rather than repair it: those flags exit with an
error naming the entry, and the default host loader trains as in the
JAX CLI. Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

from faceoff_tpu_torch.cli import train_faceoff_perceptual as base
from faceoff_tpu_torch.device import DeviceLike
from faceoff_tpu_torch.train.train_step import make_train_step
from faceoff_tpu_torch.train.trainer import Trainer

_FAULT = ("the JAX cli/train_faceoff.py drops the prepare function and the "
          "multi-step (ROADMAP.md, Queue 3); train with "
          "cli/train_faceoff_perceptual.py")


def refuse(parser, args) -> None:
    """Exit for the flags whose path the JAX CLI breaks."""
    if args.resident_data:
        parser.error(f"--resident_data: {_FAULT}")
    if args.device_pipeline:
        parser.error(f"--device_pipeline: {_FAULT}")
    if args.steps_per_call > 1:
        parser.error(f"--steps_per_call {args.steps_per_call}: {_FAULT}")
    if args.multihost:
        parser.error("--multihost: the JAX cli/train_faceoff.py never joins "
                     "a process group (ROADMAP.md, Queue 3); train with "
                     "cli/train_faceoff_perceptual.py")


def main(argv=None, device: DeviceLike = None) -> Trainer:
    """Parse `argv`, build the trainer on `device` (CUDA unless named)
    without LPIPS, resume with --ckpt, then validate (--test) or train.
    Returns the trainer."""
    parser = base.build_parser()
    args = parser.parse_args(argv)
    refuse(parser, args)
    run = base.random_run_name()
    args.sample_folder = f"{args.sample_folder}_{run}"
    if not args.ckpt:
        args.checkpoint_dir = f"{args.checkpoint_dir}_{run}"
    print(args, flush=True)

    trainer, cfg = base.build_everything(args, device, perceptual=False)
    # the JAX CLI's step: MSE + latent, no perceptual term
    trainer.train_step = make_train_step(
        trainer.model, latent_loss_weight=cfg.train.latent_loss_weight,
        perceptual_loss_weight=0.0, lpips=None)
    return base.resume_and_run(
        args, trainer, cfg,
        missing="--ckpt latest: no checkpoint yet — training from scratch")


if __name__ == "__main__":
    main()
