"""Learning-rate schedules, counterpart of ``satflow_tpu/train/schedules.py``.

A schedule maps the update count to a learning rate, as an optax schedule
does. :func:`scheduled` makes a torch optimizer follow one: before each
``step()`` every param group's ``lr`` is set to the schedule at the number of
updates made so far, which is where ``optax.scale_by_schedule`` evaluates it
(before it increments its count). That count lives in the param groups
(``"schedule_count"``), so the optimizer's ``state_dict`` carries it and a
resumed run goes on from where the schedule was, as the count inside the
JAX ``opt_state`` does.

:class:`PlateauScheduler` is ReduceLROnPlateau on the engine side (it needs
a validation metric, so it lives outside the optimizer, as in JAX), and
:func:`rewrite_learning_rate` sets an optimizer's rate, which in JAX is the
``inject_hyperparams`` learning rate inside the optax state; here it is each
param group's ``"lr"``.
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


class PlateauScheduler:
    """ReduceLROnPlateau as a scale on a base rate: :meth:`update` takes the
    monitored metric once per validation; after more than ``patience``
    epochs without a new best it multiplies the scale by ``factor``, never
    below ``min_lr / base_lr`` (the rate, not the scale, is clamped at
    ``min_lr``) nor above 1. The engine then sets each optimizer's rate to
    its own base rate times the scale (:func:`rewrite_learning_rate`)."""

    def __init__(self, base_lr: float = 1.0, factor: float = 0.5,
                 patience: int = 5, min_lr: float = 1e-7):
        self.base_lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        """Feed the monitored metric; returns the current scale."""
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                floor = self.min_lr / max(self.base_lr, 1e-30)
                self.scale = max(self.scale * self.factor, min(floor, 1.0))
                self.bad_epochs = 0
        return self.scale

    @property
    def lr(self) -> float:
        return self.base_lr * self.scale


def rewrite_learning_rate(optimizer: torch.optim.Optimizer, new_lr: float) -> torch.optim.Optimizer:
    """Set every param group's learning rate of ``optimizer`` to ``new_lr``
    (a scheduled optimizer's schedule sets it again before its next step,
    as an injected schedule does in JAX); returns the optimizer."""
    for group in optimizer.param_groups:
        group["lr"] = float(new_lr)
    return optimizer
