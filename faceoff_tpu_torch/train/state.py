"""Training state: the model (parameters and EMA codebook buffers), Adam
and the step count, counterpart of `faceoff_tpu/train/state.py`.

The JAX package builds Adam through `optax.inject_hyperparams`, which
evaluates the schedules at the update's count before it increments it,
and whose bias correction uses the current b1. `ScheduledAdam` does the
same with `torch.optim.Adam`: before each `step()` it writes the lr and
`betas[0]` of the current count into the parameter group. torch's Adam
also takes the current beta1 into its bias correction, so the two
updates are the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch
from torch import nn

from faceoff_tpu_torch.train import schedule as schedules


class ScheduledAdam:
    """Adam whose lr and b1 follow schedules of the step count."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        lr: float,
        sched_name: str = "",
        n_iter: int = 1,
        warmup_proportion: float = 0.05,
        b1: float = 0.9,
        b2: float = 0.999,
        momentum: Tuple[float, float] = (0.95, 0.85),
        eps: float = 1e-8,
    ):
        self.sched_name = sched_name
        self.n_iter = n_iter
        sched = schedules.make_schedule(sched_name, lr, n_iter,
                                        warmup_proportion)
        self.lr_fn = sched if sched is not None else (lambda step: lr)
        if sched_name == "cycle":
            self.b1_fn = schedules.cycle_momentum_schedule(
                n_iter, momentum, warmup_proportion)
        else:
            self.b1_fn = lambda step: b1
        self.b2 = b2
        self.optimizer = torch.optim.Adam(
            list(params), lr=self.lr_fn(0), betas=(self.b1_fn(0), b2),
            eps=eps)
        self.lr = float(self.lr_fn(0))

    def step(self, count: int) -> None:
        """One update with the hyperparameters of step `count`."""
        self.lr = float(self.lr_fn(count))
        b1 = float(self.b1_fn(count))
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
            group["betas"] = (b1, self.b2)
        self.optimizer.step()

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """Adam's state (moments, per-parameter step counts, the group's
        lr and betas), the lr of the last update and the schedule's name
        and length."""
        return {"adam": self.optimizer.state_dict(), "lr": self.lr,
                "sched_name": self.sched_name, "n_iter": self.n_iter}

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output. The schedule stays this
        optimizer's, as the JAX package's resume takes its optimizer from
        the command line; a different saved schedule is reported."""
        if (state["sched_name"], state["n_iter"]) != (self.sched_name,
                                                       self.n_iter):
            print(f"restored optimizer state was scheduled "
                  f"{state['sched_name']!r} over {state['n_iter']} steps; "
                  f"continuing with {self.sched_name!r} over {self.n_iter}",
                  flush=True)
        self.optimizer.load_state_dict(state["adam"])
        self.lr = float(state["lr"])


def make_optimizer(
    params: Iterable[torch.Tensor],
    lr: float,
    sched_name: str = "",
    n_iter: int = 1,
    warmup_proportion: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.999,
    momentum: Tuple[float, float] = (0.95, 0.85),
) -> ScheduledAdam:
    """Adam with the `--sched` lr schedule; 'cycle' also cycles b1 between
    `momentum` as the one-cycle policy does."""
    return ScheduledAdam(params, lr, sched_name, n_iter, warmup_proportion,
                         b1, b2, momentum)


@dataclasses.dataclass
class TrainState:
    """The model with its EMA buffers, the optimizer and the step count.
    The model and the optimizer are updated in place."""

    model: nn.Module
    optimizer: ScheduledAdam
    step: int = 0

    def apply_gradients(self) -> None:
        """Adam on the gradients in the parameters' .grad, with the
        hyperparameters of the current step; then the step advances."""
        self.optimizer.step(self.step)
        self.step += 1


def create_train_state(
    model: nn.Module,
    optimizer: Optional[ScheduledAdam] = None,
    lr: float = 3e-4,
) -> TrainState:
    """A train state at step 0; Adam with a constant `lr` unless an
    optimizer is given."""
    if optimizer is None:
        optimizer = make_optimizer(model.parameters(), lr)
    return TrainState(model=model, optimizer=optimizer, step=0)


def current_lr(state: TrainState) -> float:
    """The learning rate of the last update (of step 0 before any)."""
    return state.optimizer.lr
