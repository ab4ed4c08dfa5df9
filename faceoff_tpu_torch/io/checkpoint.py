"""Checkpoints of the full train state, counterpart of
`faceoff_tpu/io/checkpoint.py` (orbax there, `torch.save` here).

One file a step, `ckpt_{step:08d}.pt`, written under a temporary name and
renamed into place, so a file that exists is whole. Only the newest
`keep` files are kept. Each holds the model's state_dict (parameters and
the EMA codebook buffers: embed, cluster sizes and sums), the optimizer
(Adam's moments and per-parameter step counts, the lr of the last update,
the schedule's name and length), `TrainState.step` and the run's seed,
and loads with `torch.load(weights_only=True)`.

Resuming is exact: the train step seeds its generator from (seed, step)
(`train_step.step_seed`), so it needs no saved generator state, and
everything else the next step reads is in the file.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from faceoff_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: TrainState, *, seed: int = 0) -> None:
        self.save_tree(step, {
            "step": int(state.step),
            "seed": int(seed),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        })

    def save_tree(self, step: int, payload: dict) -> None:
        """Write any dict of tensors, numbers and strings as the file of
        `step` (the GAN stage's discriminator bundle)."""
        final = self.path(step)
        tmp = f"{final}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.keep]:
            os.remove(self.path(old))

    def restore_tree(self, step: Optional[int] = None) -> dict:
        """The dict `save_tree` wrote for `step` (the latest by default),
        on the CPU."""
        return self._load(step)

    def _load(self, step: Optional[int]) -> dict:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None, *,
                seed: Optional[int] = None) -> TrainState:
        """Load the checkpoint of `step` (the latest by default) into
        `state`'s model and optimizer in place and set its step. With
        `seed`, raise unless the checkpoint's run used that seed: the
        steps that follow would not be the ones that run would take."""
        payload = self._load(step)
        if seed is not None and payload["seed"] != seed:
            raise ValueError(
                f"checkpoint {step} was trained with seed {payload['seed']},"
                f" not {seed}; resume with --seed {payload['seed']}")
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def restore_weights(self, state: TrainState,
                        step: Optional[int] = None) -> TrainState:
        """Load only the step, the parameters and the EMA state; the
        optimizer stays as it is (fine-tuning or inference under another
        optimizer)."""
        payload = self._load(step)
        state.model.load_state_dict(payload["model"])
        state.step = int(payload["step"])
        return state

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX interface."""
