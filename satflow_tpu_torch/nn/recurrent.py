"""ConvLSTM cells (NHWC), counterpart of ``satflow_tpu/nn/recurrent.py``.

:class:`ConvLSTMCell` is the JAX ``ConvLSTMCell`` with its fused gate tail:
one conv ``gates`` over ``[x | h]`` to 4C (a library conv), then the LSTM
gate tail through :func:`satflow_tpu_torch.ops.fused_lstm.fused_lstm_gates`
(kernel K3 on the card). MetNet's temporal encoder runs it.

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

from satflow_tpu_torch.nn.misc import compute_dtype, conv2d_nhwc
from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates

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


class ConvLSTMCell(nn.Module):
    """Fused-gate ConvLSTM cell: ``gates`` (an ``nn.Conv2d``, SAME padding)
    over ``[x | h]`` to 4C in i, f, o, g order, then the gate tail with c cast
    to the gates' dtype.

    The compute dtype is ``dtype``, or with None what flax promotes to: the
    input's, at least float32.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.gates = nn.Conv2d(in_features + features, 4 * features, kernel_size,
                               padding="same")
        lecun_normal_(self.gates.weight, (in_features + features) * kernel_size ** 2, generator)
        nn.init.zeros_(self.gates.bias)

    def forward(self, carry: Carry, x: torch.Tensor,
                gate_tail: Callable = fused_lstm_gates) -> Tuple[Carry, torch.Tensor]:
        """((h, c), x) -> ((h', c'), h'). ``gate_tail`` swaps in another
        implementation of the gate tail (tests compare against the plain one)."""
        h, c = carry
        cdtype = compute_dtype(self.dtype, x)
        conv = self.gates
        gates = conv2d_nhwc(torch.cat([x, h], dim=-1).to(cdtype), conv.weight.to(cdtype),
                            conv.bias.to(cdtype))
        h_next, c_next = gate_tail(gates, c.to(gates.dtype))
        return (h_next, c_next), h_next

    @staticmethod
    def init_carry(batch: int, h: int, w: int, features: int,
                   dtype=torch.float32, device=None) -> Carry:
        return zeros_carry(batch, h, w, features, 2, dtype, device)
