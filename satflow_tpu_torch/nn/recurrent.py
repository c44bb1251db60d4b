"""The fused ConvLSTM cell (NHWC), counterpart of ``satflow_tpu/nn/recurrent.py``.

:class:`FusedConvLSTMCell` keeps the JAX cell's parameter names and layouts
(``x_gates_kernel`` (3, 3, Cx, 4Ch), ``h_gates_kernel`` (3, 3, Ch, 4Ch),
``bias`` (4Ch), gate order i, f, o, g), holds them in f32 and casts them to
the compute dtype per call, and runs the whole step through
:func:`satflow_tpu_torch.ops.fused_convlstm_step.fused_convlstm_step`. Under
autograd the gradients flow back through that cast to the f32 parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step

Carry = Tuple[torch.Tensor, torch.Tensor]


def zeros_carry(batch: int, h: int, w: int, features: int, n: int,
                dtype=torch.float32, device=None) -> Tuple[torch.Tensor, ...]:
    """n-tuple of zero NHWC state tensors."""
    return tuple(torch.zeros(batch, h, w, features, dtype=dtype, device=device)
                 for _ in range(n))


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, rescaled so that
    the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class FusedConvLSTMCell(nn.Module):
    """ConvLSTM cell whose whole step is one fused-step call."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.x_gates_kernel = nn.Parameter(torch.empty(3, 3, in_features, 4 * features))
        self.h_gates_kernel = nn.Parameter(torch.empty(3, 3, features, 4 * features))
        self.bias = nn.Parameter(torch.zeros(4 * features))
        lecun_normal_(self.x_gates_kernel, 9 * in_features, generator)
        lecun_normal_(self.h_gates_kernel, 9 * features, generator)

    def forward(self, carry: Carry, x: torch.Tensor,
                step: Callable = fused_convlstm_step) -> Tuple[Carry, torch.Tensor]:
        """((h, c), x) -> ((h', c'), h'). ``step`` swaps in another
        implementation of the fused step (tests compare against the plain one)."""
        h, c = carry
        cdtype = self.dtype or x.dtype
        h_next, c_next = step(
            x.to(cdtype), h.to(cdtype), c.to(cdtype),
            self.x_gates_kernel.to(cdtype), self.h_gates_kernel.to(cdtype),
            self.bias.to(cdtype),
        )
        return (h_next, c_next), h_next

    @staticmethod
    def init_carry(batch: int, h: int, w: int, features: int,
                   dtype=torch.float32, device=None) -> Carry:
        return zeros_carry(batch, h, w, features, 2, dtype, device)
