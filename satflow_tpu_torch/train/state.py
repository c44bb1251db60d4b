"""Train state: step counter, model and optimizer, counterpart of
``satflow_tpu/train/state.py::TrainState``.

The JAX state is a pytree whose ``tx`` is the optax chain the engine built:
``MultiSteps(chain(clip_by_global_norm, adam))``. Here the model and the
optimizer hold the weights and moments in place, and :meth:`TrainState.apply_gradients`
runs the same chain on the gradients that ``backward`` left in ``.grad``.

:meth:`TrainState.state_dict` is what a checkpoint holds, as the JAX
checkpoint holds ``params``, ``model_state``, ``opt_state`` and ``step``:
the model's ``state_dict`` (weights and the BatchNorm buffers), the
optimizer's (Adam's moments and, for a scheduled optimizer, the schedule's
count), ``step``, and the accumulation's ``mini_step`` and running mean
(``MultiSteps``' ``mini_step`` and ``acc_grads``), so that a checkpoint taken
between two updates resumes there.

:class:`GANTrainState` is the two-optimizer state of the GAN models: a
:class:`TrainState` for the generator and one for the discriminator, each
with its own Adam (and clipping and accumulation, as the JAX engine wraps
both optax transforms alike), and the ``torch.Generator`` the steps draw
their noise from. Its ``step`` counts discriminator updates, as the JAX
``GANTrainState.step`` does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch import nn


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (``optax_global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@dataclass
class TrainState:
    """``step`` counts optimizer calls as the JAX state does: with
    ``accumulate_grad_batches`` k > 1 every mini-step counts, and the weights
    move on every k-th.

    ``gradient_clip_val`` > 0 clips the gradient by its global norm first,
    exactly as ``optax.clip_by_global_norm`` does (g * c / norm when norm > c;
    ``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to the norm). With k > 1
    the gradients are averaged over the k mini-steps (``optax.MultiSteps``,
    the same running mean) and the clip and the optimizer see the average.
    """

    model: nn.Module
    optimizer: torch.optim.Optimizer
    gradient_clip_val: float = 0.0
    accumulate_grad_batches: int = 1
    step: int = 0
    mini_step: int = 0
    _acc: Optional[List[torch.Tensor]] = field(default=None, repr=False)

    def state_dict(self) -> Dict[str, Any]:
        """The state to save (tensors by reference, on their devices)."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "mini_step": self.mini_step,
            "accumulate_grad_batches": self.accumulate_grad_batches,
            "acc": self._acc,
        }

    def load_state_dict(self, state: Dict[str, Any], weights_only: bool = False) -> None:
        """Restore what :meth:`state_dict` gave, onto this state's devices;
        ``weights_only`` restores the model's ``state_dict`` and ``step`` and
        leaves the optimizer and the accumulation as they are."""
        self.model.load_state_dict(state["model"])
        self.step = int(state["step"])
        if weights_only:
            return
        self.optimizer.load_state_dict(state["optimizer"])
        self.mini_step = int(state["mini_step"])
        device = self.params()[0].device
        self._acc = None if state["acc"] is None else [a.to(device) for a in state["acc"]]

    def params(self) -> List[nn.Parameter]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def apply_gradients(self) -> None:
        """Consume the gradients in ``.grad`` (and clear them)."""
        params = [p for p in self.params() if p.grad is not None]
        k = self.accumulate_grad_batches
        self.step += 1
        if k > 1:
            grads = [p.grad for p in params]
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            for acc, g in zip(self._acc, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                self.optimizer.zero_grad(set_to_none=True)
                return
            for p, acc in zip(params, self._acc):
                p.grad = acc
            self._acc = None
            self.mini_step = 0
        if self.gradient_clip_val:
            norm = global_norm(p.grad for p in params)
            scale = torch.clamp(self.gradient_clip_val / norm, max=1.0)
            for p in params:
                p.grad.mul_(scale.to(p.grad.dtype))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)


@dataclass
class GANTrainState:
    """Generator and discriminator train states over one GAN model
    (``model.module``, ``model.disc_module``), and ``noise``, the generator
    of the latent draws and the gradient penalty's interpolation weights.

    :meth:`apply_d` consumes the discriminator's gradients and counts one
    ``step``; :meth:`apply_g` the generator's. :meth:`state_dict` holds both
    networks (the model's ``state_dict``: weights, BatchNorm statistics,
    spectral-norm vectors), both optimizers, both accumulations, the step and
    the noise generator's state, so that a resumed run draws the noise the
    uninterrupted one would have."""

    model: nn.Module
    g: TrainState
    d: TrainState
    noise: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, g_optimizer: torch.optim.Optimizer,
               d_optimizer: torch.optim.Optimizer, noise: torch.Generator,
               gradient_clip_val: float = 0.0,
               accumulate_grad_batches: int = 1) -> "GANTrainState":
        kw = dict(gradient_clip_val=gradient_clip_val,
                  accumulate_grad_batches=accumulate_grad_batches)
        return cls(model, TrainState(model.module, g_optimizer, **kw),
                   TrainState(model.disc_module, d_optimizer, **kw), noise)

    @property
    def step(self) -> int:
        return self.d.step

    @property
    def rounds(self) -> int:
        """Rounds taken: the engine's global step (one generator update a
        batch, where ``step`` counts ``disc_steps`` a round)."""
        return self.g.step

    @property
    def accumulate_grad_batches(self) -> int:
        return self.d.accumulate_grad_batches

    def params(self) -> List[nn.Parameter]:
        return self.g.params() + self.d.params()

    def apply_g(self) -> None:
        """Consume the generator's gradients."""
        self.g.apply_gradients()

    def apply_d(self) -> None:
        self.d.apply_gradients()

    @staticmethod
    def _half(state: TrainState) -> Dict[str, Any]:
        return {"optimizer": state.optimizer.state_dict(), "step": state.step,
                "mini_step": state.mini_step, "acc": state._acc}

    def state_dict(self) -> Dict[str, Any]:
        """The state to save (tensors by reference, on their devices)."""
        return {
            "model": self.model.state_dict(),
            "step": self.step,
            "accumulate_grad_batches": self.accumulate_grad_batches,
            "g": self._half(self.g),
            "d": self._half(self.d),
            "noise": self.noise.get_state(),
        }

    def load_state_dict(self, state: Dict[str, Any], weights_only: bool = False) -> None:
        """Restore what :meth:`state_dict` gave; ``weights_only`` restores the
        networks and the step and leaves the optimizers, the accumulations
        and the noise as they are."""
        self.model.load_state_dict(state["model"])
        for half, saved in ((self.g, state["g"]), (self.d, state["d"])):
            half.step = int(saved["step"])
            if weights_only:
                continue
            half.optimizer.load_state_dict(saved["optimizer"])
            half.mini_step = int(saved["mini_step"])
            device = half.params()[0].device
            half._acc = None if saved["acc"] is None else [a.to(device) for a in saved["acc"]]
        if not weights_only:
            self.noise.set_state(state["noise"].cpu())
