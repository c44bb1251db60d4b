"""LAMB, the Perceiver's optimizer: ``optax.lamb`` as a torch optimizer.

``optax.lamb(learning_rate, b1, b2)`` with optax's other defaults (``eps``
1e-6, ``eps_root`` 0, ``weight_decay`` 0) is the chain ``scale_by_adam`` ->
``add_decayed_weights(0)`` -> ``scale_by_trust_ratio`` ->
``scale_by_learning_rate``. Per parameter tensor p with gradient g, at
update n (from 1):

    m = (1 - b1) g + b1 m,   v = (1 - b2) g² + b2 v
    u = (m / (1 - b1^n)) / (sqrt(v / (1 - b2^n)) + eps)
    u = u * (|p| / |u|), or u where |p| or |u| is 0 (Frobenius norms)
    p = p + u * (-lr)

As in optax, every tensor is updated at every step with one shared count
n: a tensor without a gradient (``grad`` None: a modality absent from this
batch leaves its projection out of the graph) takes a zero gradient, so its
moments decay and it moves by its momentum. The moments live in the
optimizer's state and the count in its param group (``"count"``), so its
``state_dict`` carries both through a checkpoint. The learning rate is the
param group's ``lr``; :func:`~satflow_tpu_torch.train.schedules.scheduled`
sets it from a schedule at the update count before the increment, which is
where ``scale_by_learning_rate(schedule)`` evaluates it.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch


class Lamb(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, count=0))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            group["count"] += 1
            # the bias corrections in f32, as optax's 1 - b**n
            n = np.float32(group["count"])
            c1 = float(np.float32(1) - np.float32(b1) ** n)
            c2 = float(np.float32(1) - np.float32(b2) ** n)
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * (g * g) + b2 * v)
                u = (m / c1) / (torch.sqrt(v / c2) + group["eps"])
                p_norm = torch.linalg.vector_norm(p)
                u_norm = torch.linalg.vector_norm(u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    p_norm / u_norm)
                p.add_(u * ratio * (-group["lr"]))
        return loss
