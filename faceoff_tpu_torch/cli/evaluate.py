"""Quantitative report on a validation set, twin of
`faceoff_tpu/cli/evaluate.py`:

    python -m faceoff_tpu_torch.cli.evaluate --data_root DATA \
        --checkpoint_dir CKPT [--ckpt STEP] [--lpips_weights W.npz] \
        [--crossid [--naive_baseline paste|poisson]]

Self-supervised items: MSE, L1, PSNR, SSIM and LPIPS of the
reconstructions, averaged over the clips. With --crossid the swapped
clips have no pixel ground truth, so the report is the Fréchet distances
between the swapped outputs and the real target clips (fd_vgg, per frame;
fd_vgg_motion, of frame differences), and with --naive_baseline the same
of the naive blend. Prints one JSON line.

Without learned LPIPS weights the metric runs on the random VGG16 from a
seed and its keys are tagged `_random_vgg` (`_untrained_lin` where the
weights carry only the VGG trunk): such numbers track one run and are not
comparable with published LPIPS. LPIPS and its trunk compute in float32,
as the JAX CLI builds them; the model runs in bf16 on CUDA.
`main(argv, device="cpu")` runs on the CPU (the tests).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from faceoff_tpu_torch.cli import common
from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset
from faceoff_tpu_torch.data.pipeline import DataLoader
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.evaluation import evaluate_reconstruction, make_fd_video
from faceoff_tpu_torch.models.lpips import (init_lpips,
                                            lpips_weights_trunk_only,
                                            resolve_lpips_weights)
from faceoff_tpu_torch.train.train_step import make_eval_step


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=16)
    p.add_argument("--lpips_weights", default=None,
                   help=".npz from tools/convert_lpips.py, or 'auto' to "
                        "probe local paths")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--naive_baseline", choices=["paste", "poisson"],
                   default=None,
                   help="with --crossid: also report the Fréchet distances "
                        "of the naive blended composite (hard paste or "
                        "Poisson blend)")
    p.add_argument("--crossid", action="store_true",
                   help="cross-identity evaluation: Fréchet feature "
                        "distances between the swapped outputs and the real "
                        "target clips (fd_vgg appearance, fd_vgg_motion "
                        "temporal)")
    common.add_model_flags(p)
    common.add_curation_flags(p)
    return p


def _lpips_tag(lpips_npz) -> str:
    """'' for learned weights, '_untrained_lin' for a VGG trunk without
    the lin heads, '_random_vgg' for the random VGG from a seed."""
    if lpips_npz is None:
        print("WARNING: no LPIPS weights; using a fixed-seed RANDOM VGG. "
              "Reporting the metric as 'lpips_random_vgg': it is NOT "
              "comparable to the reference LPIPS.", flush=True)
        return "_random_vgg"
    if lpips_weights_trunk_only(lpips_npz):
        print(f"WARNING: {lpips_npz} carries the VGG trunk only; the lin "
              "heads are random. Reporting the metric as "
              "'lpips_untrained_lin': NOT comparable to the reference "
              "LPIPS.", flush=True)
        return "_untrained_lin"
    return ""


def main(argv=None, device: DeviceLike = None) -> Dict:
    """Evaluate, print the report as one JSON line and return it."""
    args = build_parser().parse_args(argv)
    lpips_npz = resolve_lpips_weights(args.lpips_weights)
    dev = resolve_device(device)
    state = common.restore_for_inference(args, dev)
    eval_step = make_eval_step(state.model)
    lpips = init_lpips(torch.Generator().manual_seed(1),
                       weights_npz=lpips_npz, device=dev,
                       dtype=torch.float32)
    lpips_tag = _lpips_tag(lpips_npz)

    ds = TemporalAlignmentDataset(
        args.data_root, "val", args.frames, resolution=args.size,
        cross_identity=args.crossid,
        naive_blend=(args.naive_baseline or "") if args.crossid else "",
        exclude_list=args.exclude_list, device=dev)
    loader = DataLoader(ds, batch_clips=1, shuffle=False,
                        num_workers=args.num_workers)

    reports = []
    preds, reals, naives = [], [], []
    for i, host in enumerate(loader):
        if i >= args.max_batches:
            break
        batch = {k: torch.from_numpy(host[k]).to(dev) for k in ("input", "gt")}
        out, _ = eval_step(state, batch)
        out = out.to(torch.float32)
        if args.crossid:
            preds.append(out)
            reals.append(batch["gt"])
            if "naive" in host:
                naives.append(torch.from_numpy(host["naive"]).to(dev))
            continue
        rep = evaluate_reconstruction(out, batch["gt"], lpips_apply=lpips)
        rep = {k: float(v) for k, v in rep.items()}
        if lpips_tag:
            rep[f"lpips{lpips_tag}"] = rep.pop("lpips")
        reports.append(rep)

    if args.crossid:
        fd = make_fd_video(lpips)
        real = torch.cat(reals)
        summary = {k: round(float(v), 5)
                   for k, v in fd(real, torch.cat(preds)).items()}
        if naives:
            summary.update({
                f"{k}_naive_{args.naive_baseline}": round(float(v), 5)
                for k, v in fd(real, torch.cat(naives)).items()})
        if lpips_tag:
            summary = {f"{k}{lpips_tag}": v for k, v in summary.items()}
        summary["n_clips"] = len(preds)
    else:
        summary = {k: round(float(np.mean([r[k] for r in reports])), 5)
                   for k in reports[0]}
        summary["n_clips"] = len(reports)
    summary["checkpoint_step"] = int(state.step)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
