"""Train state: step counter, model and optimizer, counterpart of
``satflow_tpu/train/state.py::TrainState``.

The JAX state is a pytree whose ``tx`` is the optax chain the engine built:
``MultiSteps(chain(clip_by_global_norm, adam))``. Here the model and the
optimizer hold the weights and moments in place, and :meth:`TrainState.apply_gradients`
runs the same chain on the gradients that ``backward`` left in ``.grad``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

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
