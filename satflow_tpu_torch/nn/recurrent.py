"""ConvLSTM cells (NHWC), counterpart of ``satflow_tpu/nn/recurrent.py``.

:class:`ConvLSTMCell` is the JAX ``ConvLSTMCell`` with its fused gate tail:
one conv ``gates`` over ``[x | h]`` to 4C (a library conv of any
``conv_type``), then the LSTM gate tail through
:func:`satflow_tpu_torch.ops.fused_lstm.fused_lstm_gates` (kernel K3 on the
card). MetNet's temporal encoder and the ``concat`` ConvLSTM run it.
:class:`SplitConvLSTMCell` and :class:`InputGateConv` are the ``split``
formulation: separate input and hidden gate convs, the input one hoisted over
the whole sequence, and the same gate tail.

:class:`FusedConvLSTMCell` keeps the JAX cell's parameter names and layouts
(``x_gates_kernel`` (3, 3, Cx, 4Ch), ``h_gates_kernel`` (3, 3, Ch, 4Ch),
``bias`` (4Ch), gate order i, f, o, g), holds them in f32 and casts them to
the compute dtype per call, and runs the whole step through
:func:`satflow_tpu_torch.ops.fused_convlstm_step.fused_convlstm_step`. Under
autograd the gradients flow back through that cast to the f32 parameters.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from satflow_tpu_torch.nn.conv import Conv, get_conv_layer, lecun_normal_  # noqa: F401
from satflow_tpu_torch.nn.misc import compute_dtype
from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates

Carry = Tuple[torch.Tensor, torch.Tensor]


def zeros_carry(batch: int, h: int, w: int, features: int, n: int,
                dtype=torch.float32, device=None) -> Tuple[torch.Tensor, ...]:
    """n-tuple of zero NHWC state tensors."""
    return tuple(torch.zeros(batch, h, w, features, dtype=dtype, device=device)
                 for _ in range(n))


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


class _ConvCell(nn.Module):
    """A module whose ``dtype`` (the compute dtype; None: the input's, at
    least float32) is followed by every :class:`Conv` below it, so that
    assigning ``cell.dtype`` re-types the whole cell."""

    _dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return self._dtype

    @dtype.setter
    def dtype(self, value: Optional[torch.dtype]) -> None:
        self._dtype = value
        for m in self.modules():
            if isinstance(m, Conv):
                m.dtype = value

    @staticmethod
    def init_carry(batch: int, h: int, w: int, features: int,
                   dtype=torch.float32, device=None) -> Carry:
        return zeros_carry(batch, h, w, features, 2, dtype, device)


class ConvLSTMCell(_ConvCell):
    """Fused-gate ConvLSTM cell: one conv ``gates`` (SAME padding) of the
    ``conv_type`` (:func:`get_conv_layer`) over ``[x | h]`` to 4C in i, f, o, g
    order, then the gate tail with c cast to the gates' dtype.

    The compute dtype is ``dtype``, or with None what flax promotes to: the
    input's, at least float32.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 conv_type: str = "standard", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.gates = get_conv_layer(conv_type)(
            in_features + features, 4 * features, kernel_size, padding="SAME",
            generator=generator)
        self.dtype = dtype

    def forward(self, carry: Carry, x: torch.Tensor,
                gate_tail: Callable = fused_lstm_gates) -> Tuple[Carry, torch.Tensor]:
        """((h, c), x) -> ((h', c'), h'). ``gate_tail`` swaps in another
        implementation of the gate tail (tests compare against the plain one)."""
        h, c = carry
        gates = self.gates(torch.cat([x, h], dim=-1).to(compute_dtype(self.dtype, x)))
        h_next, c_next = gate_tail(gates, c.to(gates.dtype))
        return (h_next, c_next), h_next


class SplitConvLSTMCell(_ConvCell):
    """ConvLSTM cell with split input and hidden gate convs (no concat):
    ``x_gates`` (with the bias) over x plus ``h_gates`` (without) over h, then
    the gate tail with c cast to the gates' dtype. With ``x_precomputed`` the
    input arrives as the (B, H, W, 4C) output of :class:`InputGateConv` and
    the cell holds no ``x_gates``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 x_precomputed: bool = False, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.x_gates = None if x_precomputed else Conv(
            in_features, 4 * features, kernel_size, generator=generator)
        self.h_gates = Conv(features, 4 * features, kernel_size, use_bias=False,
                            generator=generator)
        self.dtype = dtype

    def forward(self, carry: Carry, x: torch.Tensor,
                gate_tail: Callable = fused_lstm_gates) -> Tuple[Carry, torch.Tensor]:
        """((h, c), x or its precomputed input gates) -> ((h', c'), h')."""
        h, c = carry
        xg = x if self.x_gates is None else self.x_gates(x)
        gates = xg + self.h_gates(h)
        h_next, c_next = gate_tail(gates, c.to(gates.dtype))
        return (h_next, c_next), h_next


class InputGateConv(_ConvCell):
    """The input-side gate conv of :class:`SplitConvLSTMCell` (``x_gates``,
    with the bias) over a whole (B, T, H, W, C) sequence as one folded B·T
    batch, outside the recurrent loop."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.x_gates = Conv(in_features, 4 * features, kernel_size, generator=generator)
        self.dtype = dtype

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        b, t = x_seq.shape[:2]
        xg = self.x_gates(x_seq.reshape(b * t, *x_seq.shape[2:]))
        return xg.reshape(b, t, *xg.shape[1:])
