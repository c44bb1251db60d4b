"""LSTM gate tail: the CUDA kernels' wrapper, their plain PyTorch version and
the autograd Function that joins them.

Counterpart of ``satflow_tpu/ops/pallas/fused_lstm.py``: the TPU kernel
``_fused_pallas``, ported as K3 (``csrc/fused_lstm_gates.cu``). From gate
pre-activations ``gates`` (..., 4C) in i, f, o, g order and the cell state
``c`` (..., C) it computes, with f32 math,

    c' = σ(f)·c + σ(i)·tanh(g);  h' = σ(o)·tanh(c')

and returns ``(h', c')`` in c's dtype. :func:`fused_lstm_gates` runs the
plain version for CPU tensors and launches a kernel for CUDA tensors, or
raises; nothing falls back from one to the other. Under autograd it is
:class:`FusedLSTMGates`, whose backward is the JAX ``_bwd``'s f32 chain (the
JAX package has no backward kernel here either).

K3 is two hand-written kernels in one source, and :func:`vector_path` is the
stated rule that picks one per call: the vector kernel (16 bytes of one row
a thread, streaming loads of the gates) when C is a multiple of 8 in
bfloat16 or 4 in float32, both inputs are 16-byte aligned and c has fewer
than 2^31 elements; the per-element kernel otherwise (odd widths, offset
views). Every launch counts in ``fused_lstm_gates.launches``, and in
``fused_lstm_gates.vector_launches`` or ``fused_lstm_gates.element_launches``.

At MetNet's shape the launch takes as long as the kernel, so the CUDA path
is kept short: the entry points are typed once per process
(:func:`_entry`), the stream is read as a raw handle, the op's CUDA
implementation is :func:`_launch` itself, and its checks are the ones the
kernels need.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from satflow_tpu_torch.ops import _build

_SOURCE = "fused_lstm_gates"
#: the per-element kernel's entry points
_ENTRY = {
    torch.float32: "satflow_fused_lstm_gates_f32",
    torch.bfloat16: "satflow_fused_lstm_gates_bf16",
}
#: the vector kernel's entry points
_VEC_ENTRY = {
    torch.float32: "satflow_fused_lstm_gates_vec_f32",
    torch.bfloat16: "satflow_fused_lstm_gates_vec_bf16",
}
#: gates, c, h', c' pointers, then (rows, C, device), then the stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
#: channels in 16 bytes: the vector kernel's unit
VECTOR_WIDTH = {torch.float32: 4, torch.bfloat16: 8}


def fused_lstm_gates_ref(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, ``_gates_ref`` computed in f32: (h', c') in c's dtype."""
    i, f, o, g = gates.float().chunk(4, dim=-1)
    c_next = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_next = torch.sigmoid(o) * torch.tanh(c_next)
    return h_next.to(c.dtype), c_next.to(c.dtype)


def to_aten_order(gates: torch.Tensor) -> torch.Tensor:
    """(..., 4C) gate columns i, f, o, g -> i, f, g, o, the order of ATen's
    fused LSTM cell (``torch.ops.aten._thnn_fused_lstm_cell``), the library
    call that computes the same tail."""
    i, f, o, g = gates.chunk(4, dim=-1)
    return torch.cat((i, f, g, o), dim=-1)


def vector_path(gates: torch.Tensor, c: torch.Tensor) -> bool:
    """K3's dispatch rule on the contiguous tensors a launch reads (it copies
    others first): the vector kernel when C is a multiple of 8 (bfloat16) or
    4 (float32), both base pointers are 16-byte aligned (the outputs are
    fresh allocations, which are) and c has fewer than 2^31 elements; the
    per-element kernel otherwise."""
    width = VECTOR_WIDTH.get(c.dtype)
    return (width is not None and c.shape[-1] % width == 0 and c.numel() < 2 ** 31
            and (gates.data_ptr() | c.data_ptr()) % 16 == 0)


def _check(gates: torch.Tensor, c: torch.Tensor) -> Tuple[int, torch.dtype, int, int]:
    """Raise on anything the kernels do not take (the device type last, so
    that the shape checks can be exercised without a card); returns what the
    launch reads of c: (device index, dtype, C, number of elements)."""
    device = c.get_device()  # -1 off the card
    if gates.get_device() != device or (device < 0 and gates.device != c.device):
        raise ValueError(f"gates are on {gates.device}, c on {c.device}")
    dtype = c.dtype
    if gates.dtype != dtype:
        raise TypeError(f"gates are {gates.dtype}, c is {dtype}")
    if dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")
    shape, gshape = c.shape, gates.shape
    if not shape or gshape[:-1] != shape[:-1] or gshape[-1] != 4 * shape[-1]:
        raise ValueError(
            f"gates {tuple(gshape)} must be c's shape {tuple(shape)} with 4x its last dim")
    numel = c.numel()
    if numel == 0:
        raise ValueError(f"the kernel takes at least one element, got c {tuple(shape)}")
    if device < 0:
        raise ValueError(f"the gate tail runs on cpu or cuda tensors, not {c.device}")
    return device, dtype, shape[-1], numel


_typed = None  # {(vector, dtype): entry point} and the library, typed once per process


def _entry(vector: bool, dtype: torch.dtype):
    """(library, entry point) of the vector or the per-element kernel in
    ``dtype``: the library is built or loaded, and its entry points typed, at
    the first call of the process only."""
    global _typed
    if _typed is None:
        lib = _build.load_typed(_SOURCE, [*_ENTRY.values(), *_VEC_ENTRY.values()], _ARGTYPES)
        _typed = {**{(False, d): getattr(lib, n) for d, n in _ENTRY.items()},
                  **{(True, d): getattr(lib, n) for d, n in _VEC_ENTRY.items()}, None: lib}
    return _typed[None], _typed[vector, dtype]


def _launch(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors: the checks, then the kernel :func:`vector_path`
    picks for the contiguous tensors it launches on, launched on the current
    stream and counted."""
    device, dtype, ch, numel = _check(gates, c)
    if not (gates.is_contiguous() and c.is_contiguous()):
        gates, c = gates.contiguous(), c.contiguous()
    vector = vector_path(gates, c)
    lib, entry = _entry(vector, dtype)
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    err = entry(gates.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), numel // ch,
                ch, device, torch._C._cuda_getCurrentRawStream(device))
    if err:
        _build.raise_on(err, lib, "fused_lstm_gates")
    fused_lstm_gates.launches += 1
    if vector:
        fused_lstm_gates.vector_launches += 1
    else:
        fused_lstm_gates.element_launches += 1
    return h_out, c_out


# K3 as the dispatcher op ``satflow::fused_lstm_gates``, so that torch.export
# records it and an exported program runs it (with satflow_tpu_torch.ops
# imported): the launch for CUDA tensors, the plain version for CPU ones, no
# autograd of its own (FusedLSTMGates wraps it). A plain library registration,
# not torch.library.custom_op, whose Python wrappers add host time to every
# call of a host-bound path; and the functions themselves, without a frame
# around them.
_LIB = torch.library.Library("satflow", "FRAGMENT")
_LIB.define("fused_lstm_gates(Tensor gates, Tensor c) -> (Tensor, Tensor)")
_LIB.impl("fused_lstm_gates", _launch, "CUDA")
_LIB.impl("fused_lstm_gates", fused_lstm_gates_ref, "CPU")
_OP = torch.ops.satflow.fused_lstm_gates.default


@torch.library.register_fake("satflow::fused_lstm_gates", lib=_LIB)
def _gates_fake(gates, c):
    return torch.empty_like(c), torch.empty_like(c)


def _gates(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's op without autograd: the plain version for CPU tensors, else the
    kernel. Tensors on another device take the kernel's checks here, which
    refuse them."""
    if not ((gates.is_cuda or gates.is_cpu) and (c.is_cuda or c.is_cpu)):
        _check(gates, c)
    return _OP(gates, c)


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
    the current stream (the kernel :func:`vector_path` picks), counted in
    ``fused_lstm_gates.launches`` and in its kernel's own count. With grad
    mode on and an input that requires grad it runs as :class:`FusedLSTMGates`;
    otherwise it is the bare launch and saves nothing.
    """
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        return FusedLSTMGates.apply(gates, c)
    return _gates(gates, c)


fused_lstm_gates.launches = 0
fused_lstm_gates.vector_launches = 0
fused_lstm_gates.element_launches = 0


def build() -> None:
    """Build (or load) the kernel's library now rather than at first launch."""
    _build.load(_SOURCE)
