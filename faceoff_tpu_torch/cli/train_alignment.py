"""The alignment-regression network's command line, twin of
`faceoff_tpu/cli/train_alignment.py`:

    python -m faceoff_tpu_torch.cli.train_alignment --data_root DATA \
        [--steps N] [--size 256] [--frames 8] [--checkpoint_dir CKPT]

`AlignmentNet` regresses the inverse (rotation deg, tx px, ty px) of the
dataset's alignment items from the (perturbed face || background)
composite, trained with MSE (`train/alignment.py`). The same flags and
defaults as the JAX CLI. Runs on CUDA in bf16; `main(argv,
device="cpu")` runs on the CPU in float32 (the tests). Checkpoints are
`ckpt_{step:08d}.pt` files of the network, its Adam and the step
(`io.checkpoint.CheckpointManager.save_tree`).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset
from faceoff_tpu_torch.data.pipeline import DataLoader
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.models.alignment import AlignmentNet
from faceoff_tpu_torch.train.alignment import (create_alignment_state,
                                               make_alignment_step)
from faceoff_tpu_torch.train.observability import MetricsWriter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epoch", type=int, default=100)
    p.add_argument("--steps", type=int, default=None,
                   help="optional hard cap on total steps")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint_dir", default="alignment_checkpoint")
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--metrics_path", default=None)
    p.add_argument("--widths", type=int, nargs="+",
                   default=[32, 64, 128, 128])
    return p


def _save(ckpt: CheckpointManager, step: int, state, seed: int) -> None:
    ckpt.save_tree(step, {"step": state.step, "seed": seed,
                          "model": state.model.state_dict(),
                          "optimizer": state.optimizer.state_dict()})


def main(argv=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train on `device` (CUDA unless named). Returns {"state", "steps",
    "seconds" (the training loop's wall time), "first" and "last" (the
    first and last step's metrics)}."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    model = AlignmentNet(widths=tuple(args.widths), device=dev,
                         generator=torch.Generator().manual_seed(args.seed))
    ds = TemporalAlignmentDataset(args.data_root, "train", args.frames,
                                  resolution=args.size, alignment=True,
                                  device=dev)
    loader = DataLoader(ds, batch_clips=args.batch_size,
                        num_workers=args.num_workers, seed=args.seed)
    state = create_alignment_state(model, lr=args.lr)
    step = make_alignment_step(model)
    ckpt = CheckpointManager(args.checkpoint_dir)
    writer = MetricsWriter(args.metrics_path) if args.metrics_path else None

    step_count, first, m = 0, None, None
    done = False
    t0 = time.perf_counter()
    for epoch in range(args.epoch):
        for batch in loader:
            b = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
                 for k in ("input", "transforms")}
            state, m = step(state, b)
            first = m if first is None else first
            step_count += 1
            if step_count % args.log_every == 0:
                vals = {k: float(v) for k, v in m.items()}
                print(f"epoch {epoch + 1} step {step_count}; "
                      + " ".join(f"{k}: {v:.4f}" for k, v in vals.items()),
                      flush=True)
                if writer is not None:
                    writer.write(step_count, vals, epoch=epoch)
                    writer.flush()
            if step_count % args.save_every == 0:
                _save(ckpt, step_count, state, args.seed)
            if args.steps and step_count >= args.steps:
                done = True
                break
        if done:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0

    _save(ckpt, max(step_count, 1), state, args.seed)
    if writer is not None:
        writer.close()
    print(f"done: {step_count} steps; checkpoint in {args.checkpoint_dir}",
          flush=True)
    read = (lambda mm: {k: float(v) for k, v in mm.items()}
            if mm is not None else None)
    return {"state": state, "steps": step_count, "seconds": seconds,
            "first": read(first), "last": read(m)}


if __name__ == "__main__":
    main()
