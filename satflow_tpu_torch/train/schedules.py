"""Learning-rate schedules, counterpart of ``satflow_tpu/train/schedules.py``.

A schedule maps the update count to a learning rate, as an optax schedule
does. :func:`scheduled` makes a torch optimizer follow one: before each
``step()`` every param group's ``lr`` is set to the schedule at the number of
updates made so far, which is where ``optax.scale_by_schedule`` evaluates it
(before it increments its count). That count lives in the param groups
(``"schedule_count"``), so the optimizer's ``state_dict`` carries it and a
resumed run goes on from where the schedule was, as the count inside the
JAX ``opt_state`` does.

``PlateauScheduler`` and ``rewrite_learning_rate`` are not here: their only
users are the GAN models (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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


def cosine(lr: float, total_steps: int = 100_000, eta_min: float = 1e-8) -> Schedule:
    """``optax.cosine_decay_schedule(lr, total_steps, alpha=eta_min / lr)``:
    a cosine from ``lr`` down to ``eta_min`` at ``total_steps``, and
    ``eta_min`` after."""
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    alpha = eta_min / max(lr, 1e-12)

    def schedule(count: int) -> float:
        t = min(count, total_steps)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / total_steps)) + alpha)

    return schedule


def constant(lr: float) -> Schedule:
    """``optax.constant_schedule(lr)``."""
    return lambda count: lr  # noqa: ARG005 - a schedule takes the count


def make_schedule(name: Optional[str], lr: float, **kwargs) -> Schedule:
    """A schedule by name: ``None``, ``""``, ``"constant"`` or ``"none"``,
    ``"warmup_cosine"``, ``"cosine"``; ``kwargs`` go to its factory."""
    if name in (None, "", "constant", "none"):
        return constant(lr)
    if name == "warmup_cosine":
        return warmup_cosine(lr, **kwargs)
    if name == "cosine":
        return cosine(lr, **kwargs)
    raise ValueError(f"Unknown schedule {name!r}")


def scheduled(optimizer: torch.optim.Optimizer, schedule: Schedule) -> torch.optim.Optimizer:
    """``optimizer`` with its learning rate set to ``schedule(n)`` before its
    n-th ``step()`` (n from 0), in every param group; returns it. n is kept
    in each param group as ``"schedule_count"``, where
    ``optimizer.state_dict()`` saves it and ``load_state_dict`` restores it."""
    for group in optimizer.param_groups:
        group["schedule_count"] = 0

    def set_lr(opt, args, kwargs) -> None:  # noqa: ARG001 - the hook's signature
        count = opt.param_groups[0]["schedule_count"]
        lr = float(schedule(count))
        for group in opt.param_groups:
            group["lr"] = lr
            group["schedule_count"] = count + 1

    optimizer.register_step_pre_hook(set_lr)
    return optimizer
