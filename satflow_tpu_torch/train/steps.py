"""Train and eval steps, counterpart of ``satflow_tpu/train/steps.py``.

The JAX steps are jitted pure functions of the state; here a step runs the
model eagerly (each cell step a kernel launch on the card), backpropagates,
and hands the gradients to :meth:`TrainState.apply_gradients`. Metrics stay
on the device: ``loss``, ``frame_loss`` (T,), ``grad_norm`` (the global norm
of the raw gradients, before any clipping) and ``finite``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from satflow_tpu_torch.train.state import TrainState, global_norm


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
