"""Train and eval steps, counterpart of ``satflow_tpu/train/steps.py``.

The JAX steps are jitted pure functions of the state; here a step runs the
model eagerly (each cell step a kernel launch on the card), backpropagates,
and hands the gradients to :meth:`TrainState.apply_gradients`. Metrics stay
on the device: ``loss``, ``frame_loss`` (T,), ``grad_norm`` (the global norm
of the raw gradients, before any clipping) and ``finite``.

:func:`make_gan_train_step` is the two-optimizer round of the GAN models:
``disc_steps`` discriminator updates, each at a fresh generator sample taken
without gradient, then one generator update against the discriminator as it
now is, its parameters held out of that backward. ``"fused"`` runs both
halves in one call; ``"split"`` calls its two halves, ``d_jit`` and
``g_jit`` (the JAX mode's two jitted programs), one after the other. Run
eagerly, the two modes execute the same operations in the same order and
draw the same noise, so they give the same state; both names are kept for the
JAX ``gan_step_mode`` knob. Metrics carry the JAX keys: ``d_*`` and ``g_*``
and ``finite``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional

import torch

from satflow_tpu_torch.train.state import GANTrainState, TrainState, global_norm


def make_train_step(model, **forward_kwargs) -> Callable:
    """``train_step(state, batch) -> metrics`` for a BaseModel;
    ``forward_kwargs`` go to the model's forward (the chip smoke passes the
    plain step to time the same train step without the kernels)."""

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model.train()
        loss, metrics = model.loss(batch, **forward_kwargs)
        loss.backward()
        metrics["grad_norm"] = global_norm(
            p.grad for p in state.params() if p.grad is not None)
        state.apply_gradients()
        metrics["finite"] = torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model) -> Callable:
    """``eval_step(state, batch) -> metrics`` (no grad, nothing saved)."""

    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            _, metrics = model.loss(batch)
        return metrics

    return eval_step


@contextlib.contextmanager
def _without_param_grads(module: torch.nn.Module) -> Iterator[None]:
    """Inside, ``module``'s parameters take no gradient (the generator step's
    backward stops at the discriminator's activations)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _round_metrics(d_metrics, g_metrics) -> Dict[str, torch.Tensor]:
    metrics = {**{f"d_{k}": v.detach() for k, v in d_metrics.items()},
               **{f"g_{k}": v.detach() for k, v in g_metrics.items()}}
    metrics["finite"] = torch.isfinite(d_metrics["loss"]) & torch.isfinite(g_metrics["loss"])
    return metrics


def make_gan_train_step(model, mode: str = "fused") -> Callable:
    """``train_step(state, batch) -> metrics`` for a GAN model and a
    :class:`GANTrainState`: ``model.disc_steps`` (default 1) discriminator
    updates, then one generator update, the noise drawn from
    ``state.noise``. ``mode`` is ``"fused"`` or ``"split"`` (the returned
    step then has its halves as ``d_jit`` and ``g_jit``); any other mode, or
    ``disc_steps`` < 1, raises ValueError as in JAX."""
    disc_steps = int(getattr(model, "disc_steps", 1))
    if disc_steps < 1:
        raise ValueError(
            f"disc_steps must be >= 1 (got {disc_steps}); to freeze the "
            "discriminator use disc_lr=0"
        )
    if mode not in ("fused", "split"):
        raise ValueError(f"gan step mode must be 'fused' or 'split' (got {mode!r})")

    def d_step(state: GANTrainState, batch) -> Dict[str, torch.Tensor]:
        metrics = None
        for _ in range(disc_steps):
            loss, metrics = model.discriminator_loss(batch, generator=state.noise)
            loss.backward()
            state.apply_d()
        return metrics

    def g_step(state: GANTrainState, batch) -> Dict[str, torch.Tensor]:
        with _without_param_grads(model.disc_module):
            loss, metrics = model.generator_loss(batch, generator=state.noise)
            loss.backward()
        state.apply_g()
        return metrics

    def train_step(state: GANTrainState, batch) -> Dict[str, torch.Tensor]:
        return _round_metrics(d_step(state, batch), g_step(state, batch))

    if mode == "split":
        train_step.d_jit = d_step
        train_step.g_jit = g_step
    return train_step


def make_gan_eval_step(model, seed: int = 0) -> Callable:
    """``eval_step(state, batch) -> metrics``: the generator's and the
    discriminator's losses as the train step computes them (training mode,
    as the JAX eval step applies both losses with ``train=True``), no
    parameter, statistic or spectral vector moving, and no gradient kept.
    The noise comes from a generator seeded ``seed`` on the first batch's
    device, so every evaluation run made with a fresh step draws the same
    noise."""
    from satflow_tpu_torch.nn.norm import frozen_state

    noise: Dict[str, torch.Generator] = {}

    def eval_step(state: Optional[GANTrainState], batch) -> Dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        if "g" not in noise:
            noise["g"] = torch.Generator(device=device).manual_seed(seed)
        with frozen_state(model), torch.no_grad():
            _, g_metrics = model.generator_loss(batch, generator=noise["g"])
            _, d_metrics = model.discriminator_loss(batch, generator=noise["g"])
        return {**{f"d_{k}": v for k, v in d_metrics.items()},
                **{f"g_{k}": v for k, v in g_metrics.items()}}

    return eval_step
