"""Learning-rate and momentum schedules as plain functions of the step,
counterpart of `faceoff_tpu/train/schedule.py`.

Each factory returns `fn(step) -> float`. The step count is the only
state, so a schedule needs no checkpoint of its own. The arithmetic is
the JAX package's, in double precision where the JAX package rounds to
float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

Schedule = Callable[[int], float]


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


def cosine_lr(lr_min: float, lr_max: float, step_size: int) -> Schedule:
    """Cosine from lr_max to lr_min, restarting every step_size steps."""

    def fn(step):
        it = float(step) % step_size
        return lr_min + 0.5 * (lr_max - lr_min) * (
            1 + math.cos(it / step_size * math.pi))

    return fn


def power_lr(lr_min: float, lr_max: float, warmup: int) -> Schedule:
    """Linear warmup, then inverse-square-root decay."""

    def fn(step):
        it = float(step)
        if it < warmup:
            return lr_min + (lr_max - lr_min) / warmup * it
        return lr_max * (it - warmup + 1) ** -0.5

    return fn


def sine_lr(lr_min: float, lr_max: float, step_size: int) -> Schedule:

    def fn(step):
        it = float(step) % step_size
        return lr_min + (lr_max - lr_min) * math.sin(it / step_size * math.pi)

    return fn


def linear_lr(lr_min: float, lr_max: float, warmup: int,
              step_size: int) -> Schedule:
    """Flat warmup, then linear decay, repeating every step_size steps."""

    def fn(step):
        it = float(step) % step_size
        if it < warmup:
            return lr_max
        return lr_max + (it - warmup) * (lr_min - lr_max) / (step_size - warmup)

    return fn


def clr(lr_min: float, lr_max: float, step_size: int) -> Schedule:
    """Triangular cyclical learning rate."""

    def fn(step):
        it = float(step)
        cycle = math.floor(1 + it / (2 * step_size))
        x = abs(it / step_size - 2 * cycle + 1)
        return lr_min + (lr_max - lr_min) * max(0.0, 1 - x)

    return fn


def transformer_warmup(model_dim: int, factor: float = 1.0,
                       warmup: int = 16000) -> Schedule:
    """The Noam schedule."""

    def fn(step):
        it = max(float(step), 1.0)
        return factor * model_dim ** -0.5 * min(it ** -0.5,
                                                it * warmup ** -1.5)

    return fn


def _anneal_linear(start, end, proportion):
    return start + proportion * (end - start)


def _anneal_cos(start, end, proportion):
    cos_val = math.cos(math.pi * proportion) + 1
    return end + (start - end) / 2 * cos_val


def cycle_schedule(lr_max: float, n_iter: int, divider: float = 25.0,
                   warmup_proportion: float = 0.3) -> Schedule:
    """One-cycle: linear lr_max/divider -> lr_max over the warmup, then
    cosine lr_max -> lr_max/divider/1e4."""
    phase1 = int(n_iter * warmup_proportion)
    phase2 = max(n_iter - phase1, 1)
    lr_min = lr_max / divider

    def fn(step):
        it = float(step) % n_iter
        if it < phase1:
            return _anneal_linear(lr_min, lr_max, _clip01(it / max(phase1, 1)))
        return _anneal_cos(lr_max, lr_min / 1e4,
                           _clip01((it - phase1) / phase2))

    return fn


def cycle_momentum_schedule(
    n_iter: int, momentum: Tuple[float, float] = (0.95, 0.85),
    warmup_proportion: float = 0.3,
) -> Schedule:
    """Adam's b1 beside the one-cycle lr: high -> low over the warmup,
    back up over the anneal."""
    phase1 = int(n_iter * warmup_proportion)
    phase2 = max(n_iter - phase1, 1)
    mom1, mom2 = momentum

    def fn(step):
        it = float(step) % n_iter
        if it < phase1:
            return _anneal_linear(mom1, mom2, _clip01(it / max(phase1, 1)))
        return _anneal_cos(mom2, mom1, _clip01((it - phase1) / phase2))

    return fn


def cycle_anneal(lr_max: float, lr_divider: float, cut_point: int,
                 step_size: int) -> Schedule:
    """fastai-style cyclical anneal: triangular ramp up and down around
    lr_max, then a linear cut to lr_max/100/divider."""
    cycle_step = int(step_size * (1 - cut_point / 100) / 2)

    def fn(step):
        it = float(step) % step_size
        if it > 2 * cycle_step:
            cut3 = (it - 2 * cycle_step) / max(step_size - 2 * cycle_step, 1)
            return lr_max * (1 + cut3 * (1 - 100) / 100) / lr_divider
        if it > cycle_step:
            cut2 = 1 - (it - cycle_step) / max(cycle_step, 1)
            return lr_max * (1 + cut2 * (lr_divider - 1)) / lr_divider
        cut1 = it / max(cycle_step, 1)
        return lr_max * (1 + cut1 * (lr_divider - 1)) / lr_divider

    return fn


def lr_finder(lr_min: float, lr_max: float, step_size: int,
              linear: bool = False) -> Schedule:
    """Exponential (or linear) learning-rate sweep for range tests."""
    ratio = lr_max / lr_min

    def fn(step):
        it = float(step)
        if linear:
            return lr_min + (ratio / step_size) * it
        return lr_min * (ratio ** (1.0 / step_size)) ** it

    return fn


def make_schedule(name: str, lr: float, n_iter: int,
                  warmup_proportion: float = 0.05) -> Optional[Schedule]:
    """The trainer's `--sched` names: '' -> None (constant lr), 'cycle' ->
    one-cycle, and the other policies with the JAX package's settings."""
    if not name:
        return None
    if name == "cycle":
        return cycle_schedule(lr, n_iter, warmup_proportion=warmup_proportion)
    if name == "cosine":
        return cosine_lr(lr / 25.0, lr, n_iter)
    if name == "power":
        return power_lr(lr / 25.0, lr, max(int(n_iter * warmup_proportion), 1))
    if name == "sine":
        return sine_lr(lr / 25.0, lr, n_iter)
    if name == "linear":
        return linear_lr(lr / 25.0, lr,
                         max(int(n_iter * warmup_proportion), 1), n_iter)
    if name == "clr":
        return clr(lr / 25.0, lr, max(n_iter // 4, 1))
    if name == "cycle_anneal":
        return cycle_anneal(lr, 10.0, 20, n_iter)
    if name == "lr_finder":
        return lr_finder(lr / 1000.0, lr, n_iter)
    raise ValueError(f"unknown schedule '{name}'")
