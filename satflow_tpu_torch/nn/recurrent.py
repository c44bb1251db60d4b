"""ConvLSTM cells (NHWC), counterpart of ``satflow_tpu/nn/recurrent.py``.

:class:`ConvLSTMCell` is the JAX ``ConvLSTMCell`` with its fused gate tail:
one conv ``gates`` over ``[x | h]`` to 4C (a library conv of any
``conv_type``), then the LSTM gate tail through
:func:`satflow_tpu_torch.ops.fused_lstm.fused_lstm_gates` (kernel K3 on the
card). MetNet's temporal encoder and the ``concat`` ConvLSTM run it.
:class:`SplitConvLSTMCell` and :class:`InputGateConv` are the ``split``
formulation: separate input and hidden gate convs, the input one hoisted over
the whole sequence, and the same gate tail. :class:`SpatioTemporalLSTMCell`
is the PredRNN-v2 cell (library convs, no kernel), :class:`ConvGRUCell` the
DGMR sampler's GRU (library convs, optionally spectrally normalised, no
kernel), and :func:`scan_cell`
runs a cell over the time axis of a sequence with shared weights, as the
JAX package's ``nn.scan`` wrapper does.

:class:`FusedConvLSTMCell` keeps the JAX cell's parameter names and layouts
(``x_gates_kernel`` (3, 3, Cx, 4Ch), ``h_gates_kernel`` (3, 3, Ch, 4Ch),
``bias`` (4Ch), gate order i, f, o, g), holds them in f32 and casts them to
the compute dtype per call, and runs the whole step through
:func:`satflow_tpu_torch.ops.fused_convlstm_step.fused_convlstm_step`. Under
autograd the gradients flow back through that cast to the f32 parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from satflow_tpu_torch.nn.conv import Conv, DtypedModule, get_conv_layer, lecun_normal_  # noqa: F401
from satflow_tpu_torch.nn.misc import LayerNorm, compute_dtype
from satflow_tpu_torch.nn.norm import SNConv
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


class _ConvCell(DtypedModule):
    """A cell whose ``dtype`` every :class:`Conv` below it follows."""

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


class SpatioTemporalLSTMCell(DtypedModule):
    """PredRNN-v2 cell with memory decoupling (dual memories c and m).

    x contributes 7 gate maps (``conv_x``), h 4 (``conv_h``), m 3
    (``conv_m``), each a bias-free ``kernel_size`` conv, optionally followed
    by a LayerNorm over the channels (``conv_*_ln``); ``conv_o`` reads
    [c' | m'] for the output gate and the 1x1 ``conv_last`` the memory that
    tanh takes. ``forget_bias`` is added to both forget gates. Returns
    ((h', c', m'), (h', Δc, Δm)), Δc and Δm being what the decoupling loss
    reads. ``in_features=None`` takes x's width from the first input.
    """

    def __init__(self, in_features: Optional[int], features: int, kernel_size: int = 5,
                 layer_norm: bool = True, forget_bias: float = 1.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.layer_norm = layer_norm
        self.forget_bias = forget_bias
        for name, cin, mult in (("conv_x", in_features, 7), ("conv_h", features, 4),
                                ("conv_m", features, 3), ("conv_o", 2 * features, 1)):
            self.add_module(name, Conv(cin, mult * features, kernel_size, use_bias=False,
                                       generator=generator))
            if layer_norm:
                self.add_module(f"{name}_ln", LayerNorm(mult * features))
        self.conv_last = Conv(2 * features, features, 1, use_bias=False, generator=generator)
        self.dtype = dtype

    def _gate_conv(self, name: str, inp: torch.Tensor) -> torch.Tensor:
        y = getattr(self, name)(inp)
        return getattr(self, f"{name}_ln")(y) if self.layer_norm else y

    def forward(self, carry, x: torch.Tensor):
        h, c, m = carry
        i_x, f_x, g_x, i_xp, f_xp, g_xp, o_x = self._gate_conv("conv_x", x).chunk(7, dim=-1)
        i_h, f_h, g_h, o_h = self._gate_conv("conv_h", h).chunk(4, dim=-1)
        i_m, f_m, g_m = self._gate_conv("conv_m", m).chunk(3, dim=-1)

        i_t = torch.sigmoid(i_x + i_h)
        f_t = torch.sigmoid(f_x + f_h + self.forget_bias)
        g_t = torch.tanh(g_x + g_h)
        delta_c = i_t * g_t
        c_next = f_t * c + delta_c

        i_tp = torch.sigmoid(i_xp + i_m)
        f_tp = torch.sigmoid(f_xp + f_m + self.forget_bias)
        g_tp = torch.tanh(g_xp + g_m)
        delta_m = i_tp * g_tp
        m_next = f_tp * m + delta_m

        mem = torch.cat([c_next, m_next], dim=-1)
        o_t = torch.sigmoid(o_x + o_h + self._gate_conv("conv_o", mem))
        h_next = o_t * torch.tanh(self.conv_last(mem))
        return (h_next, c_next, m_next), (h_next, delta_c, delta_m)

    @staticmethod
    def init_carry(batch: int, h: int, w: int, features: int,
                   dtype=torch.float32, device=None):
        return zeros_carry(batch, h, w, features, 3, dtype, device)


class ConvGRUCell(_ConvCell):
    """Convolutional GRU cell (NHWC), the DGMR generator's recurrence: one
    conv ``gates`` over ``[x | h]`` to the update and reset gates (z, r), a
    conv ``candidate`` over ``[x | r·h]``, ``h' = (1 - z)·h + z·tanh(cand)``.
    ``sn`` makes both convs :class:`~satflow_tpu_torch.nn.norm.SNConv`
    (``sn_stateless`` their stateless form). ``((h,), x) -> ((h',), h')``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 sn: bool = False, sn_stateless: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def conv(cin, cout):
            if sn:
                return SNConv(cin, cout, kernel_size, stateless=sn_stateless,
                              generator=generator)
            return Conv(cin, cout, kernel_size, generator=generator)

        self.features = features
        self.gates = conv(in_features + features, 2 * features)
        self.candidate = conv(in_features + features, features)
        self.dtype = dtype

    def forward(self, carry: Tuple[torch.Tensor], x: torch.Tensor):
        (h,) = carry
        z, r = torch.sigmoid(self.gates(torch.cat([x, h], dim=-1))).chunk(2, -1)
        cand = self.candidate(torch.cat([x, r * h], dim=-1))
        h_next = (1.0 - z) * h + z * torch.tanh(cand)
        return (h_next,), h_next

    @staticmethod
    def init_carry(batch: int, h: int, w: int, features: int,
                   dtype=torch.float32, device=None) -> Tuple[torch.Tensor]:
        return zeros_carry(batch, h, w, features, 1, dtype, device)


def _stack_outputs(ys: list) -> Any:
    """A list over time of outputs (tensors, or tuples of them) -> the same
    structure with each leaf stacked on axis 1."""
    if isinstance(ys[0], torch.Tensor):
        return torch.stack(ys, dim=1)
    return type(ys[0])(_stack_outputs([y[i] for y in ys]) for i in range(len(ys[0])))


class ScanCell(nn.Module):
    """A cell run over axis 1 of a (B, T, ...) input with one set of weights
    (the wrapped ``cell``'s): ``(carry, xs) -> (carry, ys)``, the outputs
    stacked on axis 1, as ``nn.scan(in_axes=1, out_axes=1)``."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.cell = cell

    def forward(self, carry, xs: torch.Tensor, *args, **kwargs):
        ys = []
        for t in range(xs.shape[1]):
            carry, y = self.cell(carry, xs[:, t], *args, **kwargs)
            ys.append(y)
        return carry, _stack_outputs(ys)


def scan_cell(cell_cls: Callable[..., nn.Module], *args, **cell_kwargs) -> ScanCell:
    """``cell_cls(*args, **cell_kwargs)`` wrapped in a :class:`ScanCell`, which
    scans it over the time axis of a (B, T, H, W, C) input with its weights
    shared across steps (the JAX ``scan_cell``)."""
    return ScanCell(cell_cls(*args, **cell_kwargs))
