"""LSTM gate tail: the CUDA kernel's wrapper, its plain PyTorch version and the
autograd Function that joins them.

Counterpart of ``satflow_tpu/ops/pallas/fused_lstm.py``: the TPU kernel
``_fused_pallas``, ported as K3 (``csrc/fused_lstm_gates.cu``). From gate
pre-activations ``gates`` (..., 4C) in i, f, o, g order and the cell state
``c`` (..., C) it computes, with f32 math,

    c' = σ(f)·c + σ(i)·tanh(g);  h' = σ(o)·tanh(c')

and returns ``(h', c')`` in c's dtype. :func:`fused_lstm_gates` runs the
plain version for CPU tensors and launches the kernel for CUDA tensors, or
raises; nothing falls back from one to the other. Under autograd it is
:class:`FusedLSTMGates`, whose backward is the JAX ``_bwd``'s f32 chain (the
JAX package has no backward kernel here either).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from satflow_tpu_torch.ops import _build

_SOURCE = "fused_lstm_gates"
_ENTRY = {
    torch.float32: "satflow_fused_lstm_gates_f32",
    torch.bfloat16: "satflow_fused_lstm_gates_bf16",
}


def fused_lstm_gates_ref(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, ``_gates_ref`` computed in f32: (h', c') in c's dtype."""
    i, f, o, g = gates.float().chunk(4, dim=-1)
    c_next = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_next = torch.sigmoid(o) * torch.tanh(c_next)
    return h_next.to(c.dtype), c_next.to(c.dtype)


def _check(gates: torch.Tensor, c: torch.Tensor) -> None:
    """Raise on anything the kernel does not take (the device type last, so
    that the shape checks can be exercised without a card)."""
    if gates.device != c.device:
        raise ValueError(f"gates are on {gates.device}, c on {c.device}")
    if gates.dtype != c.dtype:
        raise TypeError(f"gates are {gates.dtype}, c is {c.dtype}")
    if c.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {c.dtype}")
    if c.dim() < 1 or gates.shape[:-1] != c.shape[:-1] or gates.shape[-1] != 4 * c.shape[-1]:
        raise ValueError(
            f"gates {tuple(gates.shape)} must be c's shape {tuple(c.shape)} with 4x its last dim"
        )
    if c.numel() == 0:
        raise ValueError(f"the kernel takes at least one element, got c {tuple(c.shape)}")
    if c.device.type != "cuda":
        raise ValueError(f"the gate tail runs on cpu or cuda tensors, not {c.device}")


def _library() -> ctypes.CDLL:
    """The kernel's library, entry points typed: gates, c, h', c' pointers,
    then (rows, C, device), then the stream."""
    return _build.load_typed(_SOURCE, _ENTRY.values(), [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _gates(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 without autograd: the plain version for CPU tensors, else the kernel."""
    if gates.device.type == "cpu" and c.device.type == "cpu":
        return fused_lstm_gates_ref(gates, c)
    _check(gates, c)
    gates, c = gates.contiguous(), c.contiguous()
    lib = _library()
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    ch = c.shape[-1]
    stream = torch.cuda.current_stream(c.device).cuda_stream
    err = getattr(lib, _ENTRY[c.dtype])(
        gates.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        c.numel() // ch, ch, c.device.index, stream,
    )
    _build.raise_on(err, lib, "fused_lstm_gates")
    fused_lstm_gates.launches += 1
    return h_out, c_out


def gates_bwd(gates, c, c_next, dh, dc_next) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``_bwd``: (dgates, dc) from the saved (gates, c, c') and the
    cotangents of (h', c'), in f32, cast to the gates' dtype."""
    out_dtype = gates.dtype
    gates, c, c_next, dh, dc_next = (t.float() for t in (gates, c, c_next, dh, dc_next))
    i, f, o, g = gates.chunk(4, dim=-1)
    si, sf, so, tg = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
    tc = torch.tanh(c_next)
    dcn = dc_next + dh * so * (1.0 - tc * tc)
    di = dcn * tg * si * (1.0 - si)
    df = dcn * c * sf * (1.0 - sf)
    do = dh * tc * so * (1.0 - so)
    dg = dcn * si * (1.0 - tg * tg)
    return torch.cat([di, df, do, dg], dim=-1).to(out_dtype), (dcn * sf).to(out_dtype)


class FusedLSTMGates(torch.autograd.Function):
    """The gate tail under autograd, ``fused_lstm_gates``'s ``custom_vjp``.

    Forward: K3 (its plain version on the CPU); saves (gates, c, c') as
    ``_fwd`` does. Backward: :func:`gates_bwd`.
    """

    @staticmethod
    def forward(ctx, gates, c):
        h_next, c_next = _gates(gates, c)
        ctx.save_for_backward(gates, c, c_next)
        return h_next, c_next

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh, dc_next):
        gates, c, c_next = ctx.saved_tensors
        return gates_bwd(gates, c, c_next, dh, dc_next)


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (..., 4C), c (..., C)) -> (h', c'), in c's dtype.

    CPU tensors take :func:`fused_lstm_gates_ref`; CUDA tensors launch K3 on
    the current stream, counted in ``fused_lstm_gates.launches``. With grad
    mode on and an input that requires grad it runs as :class:`FusedLSTMGates`;
    otherwise it is the bare launch and saves nothing.
    """
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        return FusedLSTMGates.apply(gates, c)
    return _gates(gates, c)


fused_lstm_gates.launches = 0


def build() -> None:
    """Build (or load) the kernel's library now rather than at first launch."""
    _build.load(_SOURCE)
