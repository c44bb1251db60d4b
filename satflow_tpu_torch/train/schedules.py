"""Learning-rate schedules, counterpart of ``satflow_tpu/train/schedules.py``.

A schedule maps the update count to a learning rate, as an optax schedule
does. :func:`scheduled` makes a torch optimizer follow one: before each
``step()`` every param group's ``lr`` is set to the schedule at the number of
updates made so far, which is where ``optax.scale_by_schedule`` evaluates it
(before it increments its count).
"""

from __future__ import annotations

import itertools
import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def warmup_cosine(
    lr: float,
    warmup_steps: int = 1000,
    total_steps: int = 100_000,
    warmup_start_lr: float = 1e-8,
    eta_min: float = 1e-8,
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(warmup_start_lr, lr, warmup_steps,
    total_steps, eta_min)``: linear from ``warmup_start_lr`` to ``lr`` over
    ``warmup_steps``, then a cosine from ``lr`` down to ``eta_min`` at
    ``total_steps``, and ``eta_min`` after."""
    alpha = 0.0 if lr == 0.0 else eta_min / lr
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"total_steps ({total_steps}) must exceed warmup_steps ({warmup_steps})")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (warmup_start_lr - lr) * frac + lr
        t = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def scheduled(optimizer: torch.optim.Optimizer, schedule: Schedule) -> torch.optim.Optimizer:
    """``optimizer`` with its learning rate set to ``schedule(n)`` before its
    n-th ``step()`` (n from 0), in every param group; returns it."""
    count = itertools.count()

    def set_lr(opt, args, kwargs) -> None:  # noqa: ARG001 - the hook's signature
        lr = float(schedule(next(count)))
        for group in opt.param_groups:
            group["lr"] = lr

    optimizer.register_step_pre_hook(set_lr)
    return optimizer
