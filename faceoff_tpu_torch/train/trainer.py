"""The perceptual trainer's loop, counterpart of
`faceoff_tpu/train/trainer.py`: steps over the loader, metrics on a
cadence, validation that writes sample streams, checkpoints of the full
train state, resume and the epoch budget.

The step's metrics are tensors on the card. The loop keeps them there and
reads them only at the log cadence and at the end of an epoch
(`MetricLogger`, `MetricsWriter`), as the JAX trainer defers its reads,
so that it does not wait for the card after every step. Validation
writes four streams a batch (source, background, prediction,
source_images) as uncompressed AVI files named
`{epoch}_{step}_{batch}_{stream}.avi`.

Across `torch.distributed` processes (the CLI's --multihost) every
process runs the loop on its own shard of the data with the same step
(`train.shardmap_step`); only the primary prints, writes metrics, sample
streams and checkpoints, with barriers around each checkpoint;
validation metrics are averaged over the processes; and a preemption
stops every process by consensus at the log cadence, as in the JAX
trainer.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from faceoff_tpu_torch import config as config_lib
from faceoff_tpu_torch.data.dataset import denormalize
from faceoff_tpu_torch.data.pipeline import prefetch_to_device
from faceoff_tpu_torch.evaluation import evaluate_reconstruction
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.io.video import save_frames_as_video
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.train.observability import (MetricsWriter,
                                                   PreemptionGuard,
                                                   StallWatchdog,
                                                   StepProfiler)
from faceoff_tpu_torch.train.state import TrainState


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


class MetricLogger:
    """Running scalars and the console line. The step's metric tensors
    are kept as they are and read only at `materialize` (a log line or
    the end of an epoch)."""

    def __init__(self):
        self._pending = []  # (metrics dict of tensors, frames)
        self.mse_sum = 0.0
        self.mse_n = 0
        self.perceptual = []

    def update(self, metrics: Dict[str, Any], frames: int):
        self._pending.append((metrics, frames))

    def materialize(self):
        for metrics, frames in self._pending:
            self.mse_sum += float(metrics["mse"]) * frames
            self.mse_n += frames
            if "perceptual" in metrics:
                self.perceptual.append(float(metrics["perceptual"]))
        self._pending.clear()

    @property
    def avg_mse(self) -> float:
        return self.mse_sum / max(self.mse_n, 1)

    def line(self, epoch: int, metrics: Dict[str, Any], lr: float) -> str:
        self.materialize()
        perc = np.mean(self.perceptual) if self.perceptual else 0.0
        return (
            f"epoch: {epoch + 1}; mse: {float(metrics['mse']):.5f}; "
            f"perceptual: {perc:.3f} latent: {float(metrics['latent']):.3f}; "
            f"avg mse: {self.avg_mse:.5f}; lr: {lr:.5f}"
        )


def run_validation(
    eval_step,
    state: TrainState,
    val_loader: Iterable,
    sample_folder: str,
    epoch: int,
    step: int,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Write the sample streams of every validation batch (the first clip
    of each: source, background, prediction, source_images, and
    source_original and naive where the batch has them) and return the
    mean reconstruction metrics. Across processes each evaluates its own
    shard, the means are averaged over them, and the primary alone
    writes its shard's streams and prints."""
    primary = collectives.is_primary()
    if primary:
        os.makedirs(sample_folder, exist_ok=True)
    device = _device_of(state)
    reports = []
    for i, host in enumerate(val_loader):
        if max_batches is not None and i >= max_batches:
            break
        batch = {k: torch.from_numpy(np.asarray(host[k])).to(device)
                 for k in ("input", "gt")}
        out, _ = eval_step(state, batch)
        rep = evaluate_reconstruction(out, batch["gt"])
        reports.append({k: float(v) for k, v in rep.items()})
        saves = {
            "source": host["input"][..., :3],
            "background": host["input"][..., 3:6],
            "prediction": out.to(torch.float32).cpu().numpy(),
            "source_images": host["gt"],
        }
        # cross-identity batches: the source frames and the naive blend
        for name in ("source_original", "naive"):
            if name in host:
                saves[name] = host[name]
        if not primary:
            continue
        for name, clip in saves.items():
            frames = [denormalize(f) for f in clip[0]]
            save_frames_as_video(frames, osp.join(
                sample_folder, f"{epoch + 1}_{step}_{i}_{name}.avi"))
    if not reports:
        return {"val_mse": float("nan")}
    summary = {f"val_{k}": float(np.mean([r[k] for r in reports]))
               for k in reports[0]}
    if collectives.get_world_size() > 1:
        means = collectives.all_reduce_metrics(
            {k: torch.tensor(v, device=device) for k, v in summary.items()})
        summary = {k: float(v) for k, v in means.items()}
    if primary:
        line = "; ".join(f"{k}: {v:.4f}" for k, v in summary.items())
        print(f"validation: {line}", flush=True)
    return summary


class Trainer:
    """End-to-end perceptual training: `fit` runs epochs of `train_epoch`
    to a total budget, validating and checkpointing every
    `cfg.train.validate_at` steps and at the end."""

    def __init__(
        self,
        cfg: config_lib.Config,
        model: torch.nn.Module,
        state: TrainState,
        train_step,
        eval_step,
        train_loader,
        val_loader,
        log_every: int = 10,
        metrics_path: Optional[str] = None,
        profile_dir: Optional[str] = None,
        steps_per_call: int = 1,
        stall_timeout: float = 0.0,
    ):
        self.cfg = cfg
        self.model = model
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.log_every = log_every
        self.device = _device_of(state)
        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                                      keep=cfg.train.keep_checkpoints)
        self.global_step = 0
        self._last_saved_step = -1
        # >1: train_step is a make_multi_step loop over stacked batches
        self.steps_per_call = steps_per_call
        self.world = collectives.get_world_size()
        self.metrics_writer = (MetricsWriter(metrics_path)
                               if metrics_path and collectives.is_primary()
                               else None)
        self.profiler = StepProfiler(profile_dir)
        self.preemption = PreemptionGuard()
        # exits STALL_EXIT_CODE after `stall_timeout` s without a finished
        # step, so that a supervisor restarts and resumes (0 disables)
        self.watchdog = StallWatchdog(stall_timeout)
        # re-seed EMA-dead codebook entries every revive_every steps from
        # the current batch's latents (0 disables)
        self.revive_every = cfg.train.revive_codes_every

    def resume(self, step: Optional[int] = None):
        self.state = self.ckpt.restore(self.state, step,
                                       seed=self.cfg.train.seed)
        self.global_step = int(self.state.step)
        self._last_saved_step = self.global_step
        print(f"resumed from step {self.global_step}")

    def _batch_stream(self):
        """Host batches, stacked K at a time when steps_per_call = K > 1
        (a remainder short of K is dropped)."""
        if self.steps_per_call <= 1:
            yield from self.train_loader
            return
        acc = []
        for batch in self.train_loader:
            acc.append(batch)
            if len(acc) == self.steps_per_call:
                yield {k: np.stack([b[k] for b in acc]) for k in acc[0]}
                acc = []

    def _device_stream(self):
        """(batch on the card, optimizer steps it is worth). A resident
        corpus yields its staged tensors as they are; host batches go
        through `prefetch_to_device`, the copy of batch k + 1 overlapping
        step k."""
        if getattr(self.train_loader, "is_resident", False):
            for batch in self.train_loader:
                yield batch, self.steps_per_call
            return
        for batch in prefetch_to_device(self._batch_stream(), self.device):
            yield batch, max(1, self.steps_per_call)

    def train_epoch(self, epoch: int):
        logger = MetricLogger()
        t0 = time.time()
        for i, (batch, n_steps) in enumerate(self._device_stream()):
            if getattr(self.train_loader, "is_resident", False):
                # the batch is the whole corpus: count the sampled frames
                frames = (self.train_loader.clips_per_step
                          * self.train_loader.clip_len * n_steps)
            elif n_steps > 1:
                first = next(iter(batch.values()))
                frames = int(np.prod(first.shape[:3]))
            else:
                first = next(iter(batch.values()))
                frames = first.shape[0] * first.shape[1]
            self.state, metrics = self.train_step(self.state, batch,
                                                  self.cfg.train.seed)
            self.global_step += n_steps
            logger.update(metrics, frames)
            self.profiler.step(self.global_step)
            self.watchdog.beat()

            if self.metrics_writer is not None:
                self.metrics_writer.write(self.global_step, metrics,
                                          epoch=epoch)

            if i % self.log_every == 0 and collectives.is_primary():
                lr = float(metrics["lr"])
                line = logger.line(epoch, metrics, lr)
                fps = frames * (i + 1) / max(time.time() - t0, 1e-9)
                print(line + f"; frames/s: {fps:.1f}", flush=True)
                if self.metrics_writer is not None:
                    self.metrics_writer.flush()

            if (self.revive_every
                    and self.global_step % self.revive_every == 0
                    and "input" in batch and n_steps == 1):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.cfg.train.seed * 7_368_787
                                + self.global_step)
                self.model.revive_codes(batch["input"], gen)

            if self._stop_requested(i):
                print("preemption requested: saving and stopping",
                      flush=True)
                self._save()
                return logger

            if self.global_step % self.cfg.train.validate_at == 0:
                self.validate(epoch, i)
        logger.materialize()
        if self.metrics_writer is not None:
            self.metrics_writer.flush()
        return logger

    def validate(self, epoch: int, step: int):
        run_validation(self.eval_step, self.state, self.val_loader,
                       self.cfg.train.sample_folder, epoch, step)
        self._save()

    def _stop_requested(self, i: int) -> bool:
        """The preemption check. Across processes the flags are combined
        at the log cadence, which every process reaches at the same step,
        so that all stop together before the checkpoint's barrier."""
        if self.world <= 1:
            return self.preemption.should_stop
        if i % self.log_every == 0:
            return self.preemption.should_stop_global(self.device)
        return False

    def _save(self):
        if self.global_step == self._last_saved_step:
            return  # already saved at this step (validation or preemption)
        collectives.run_on_primary(lambda: self.ckpt.save(
            self.global_step, self.state, seed=self.cfg.train.seed))
        self._last_saved_step = self.global_step

    def fit(self, epochs: Optional[int] = None):
        """Train to a TOTAL budget of `epochs`: after a resume the restored
        steps count against it, so a restart finishes the original run and
        the step-indexed schedule stays within its horizon."""
        n = epochs if epochs is not None else self.cfg.train.epochs
        start = 0
        if self.global_step > 0:
            spe = len(self.train_loader)
            if self.steps_per_call > 1:
                # an epoch advances floor(spe / K) * K optimizer steps
                spe = (spe // self.steps_per_call) * self.steps_per_call
            if spe > 0:
                start = min(n, self.global_step // spe)
                if start:
                    print(f"resume at step {self.global_step}: "
                          f"{start}/{n} epochs already done", flush=True)
        try:
            for epoch in range(start, n):
                self.train_epoch(epoch)
                if self.preemption.should_stop:
                    break
            # a run whose length is no multiple of validate_at keeps its tail
            if self.global_step > 0:
                self._save()
        finally:
            self.watchdog.stop()
            self.profiler.close()
            self.preemption.restore()
            if self.metrics_writer is not None:
                self.metrics_writer.close()
