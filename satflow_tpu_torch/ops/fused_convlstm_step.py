"""Fused ConvLSTM step and its backward: the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd Function that joins them.

Counterpart of ``satflow_tpu/ops/pallas/fused_convlstm_step.py``: the TPU
kernel ``_step_pallas_padded`` (and its unpadded sibling ``_step_pallas``),
ported as K1, and the backward's ``_gate_bwd_pallas``, ported as K2. One
step computes, on unpadded NHWC tensors,

    gates = conv3x3(x, Wx) + conv3x3(h, Wh) + b       (f32 accumulation)
    i, f, o, g = split(gates, 4)
    c' = σ(f)·c + σ(i)·tanh(g);  h' = σ(o)·tanh(c')   (f32 math)

and returns ``(h', c')`` in the input dtype. Weights keep the JAX layout:
``wx`` (3, 3, Cx, 4Ch), ``wh`` (3, 3, Ch, 4Ch), ``b`` (4Ch,).

Each wrapper (:func:`fused_convlstm_step` for K1, :func:`gate_bwd` for K2)
runs its plain version for CPU tensors and launches its hand-written kernel
(``csrc/fused_convlstm_step.cu``, ``csrc/fused_convlstm_step_bwd.cu``) for
CUDA tensors, or raises; nothing falls back from one to the other. Under
autograd the step is :class:`FusedConvLSTMStep`, whose backward is K2 plus
the merged linear grads as library convs, as ``_bwd`` leaves them to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from satflow_tpu_torch.ops import _build

#: hidden width the kernel is compiled for
KERNEL_HIDDEN = 64
#: largest input width whose staged window fits the block's shared memory
KERNEL_MAX_CX = 256

_ENTRY = {
    torch.float32: "satflow_fused_convlstm_step_f32",
    torch.bfloat16: "satflow_fused_convlstm_step_bf16",
}
_BWD_ENTRY = {
    torch.float32: "satflow_gate_bwd_f32",
    torch.bfloat16: "satflow_gate_bwd_bf16",
}


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3×3 conv of NHWC ``x`` with an HWIO kernel, returning NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def lstm_gates(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, 4Ch) pre-activations in i, f, o, g order and c -> (h', c'), f32."""
    i, f, o, g = gates.float().chunk(4, dim=-1)
    c_next = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_next = torch.sigmoid(o) * torch.tanh(c_next)
    return h_next, c_next


def fused_convlstm_step_ref(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: two library convs in the input dtype, f32 gate math."""
    gates = conv3x3(x, wx).float() + conv3x3(h, wh).float() + b.float()
    h_next, c_next = lstm_gates(gates, c)
    return (h_next.to(x.dtype).contiguous(memory_format=torch.contiguous_format),
            c_next.to(x.dtype).contiguous(memory_format=torch.contiguous_format))


def gate_bwd_math(gates, c, dh_next, dc_next) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate chain's backward in f32, ``_gate_bwd_math``: (dgates, dc_prev)
    from the pre-activations, c and the cotangents of (h', c')."""
    si, sf, so, tg = gates.float().chunk(4, dim=-1)
    si, sf, so, tg = torch.sigmoid(si), torch.sigmoid(sf), torch.sigmoid(so), torch.tanh(tg)
    c = c.float()
    dh_next = dh_next.float()
    tc = torch.tanh(sf * c + si * tg)
    do_pre = dh_next * tc * so * (1.0 - so)
    dct = dc_next.float() + dh_next * so * (1.0 - tc * tc)
    di_pre = dct * tg * si * (1.0 - si)
    df_pre = dct * c * sf * (1.0 - sf)
    dg_pre = dct * si * (1.0 - tg * tg)
    return torch.cat([di_pre, df_pre, do_pre, dg_pre], dim=-1), dct * sf


def gate_bwd_ref(x, h, c, wx, wh, b, dh_next, dc_next) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version, ``_gate_bwd_ref``: the gates recomputed with two
    library convs in the input dtype, the chain in f32, both outputs cast to
    ``x.dtype``: dgates (B, H, W, 4Ch) and dc_prev (B, H, W, Ch)."""
    gates = conv3x3(x, wx).float() + conv3x3(h, wh).float() + b.float()
    dgates, dc_prev = gate_bwd_math(gates, c, dh_next, dc_next)
    return (dgates.to(x.dtype).contiguous(memory_format=torch.contiguous_format),
            dc_prev.to(x.dtype).contiguous(memory_format=torch.contiguous_format))


def _check(x, h, c, wx, wh, b, **state_like) -> None:
    """Raise on anything the kernels do not take (the device type last, so
    that the shape checks can be exercised without a card). ``state_like``
    are further tensors of c's shape (the backward's dh' and dc')."""
    named = dict(x=x, h=h, c=c, wx=wx, wh=wh, b=b, **state_like)
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 4 or h.dim() != 4:
        raise ValueError(f"x and h must be NHWC, got {tuple(x.shape)}, {tuple(h.shape)}")
    bsz, height, width, cx = x.shape
    ch = h.shape[-1]
    if h.shape[:3] != x.shape[:3] or c.shape != h.shape:
        raise ValueError(
            f"x {tuple(x.shape)}, h {tuple(h.shape)} and c {tuple(c.shape)} "
            "must share (B, H, W), and h and c their shape"
        )
    for name, t in state_like.items():
        if t.shape != c.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have c's shape {tuple(c.shape)}")
    if (tuple(wx.shape) != (3, 3, cx, 4 * ch) or tuple(wh.shape) != (3, 3, ch, 4 * ch)
            or tuple(b.shape) != (4 * ch,)):
        raise ValueError(
            f"weights must be wx (3,3,{cx},{4 * ch}), wh (3,3,{ch},{4 * ch}), "
            f"b ({4 * ch},); got {tuple(wx.shape)}, {tuple(wh.shape)}, {tuple(b.shape)}"
        )
    if ch != KERNEL_HIDDEN:
        raise ValueError(f"the kernel is built for hidden width {KERNEL_HIDDEN}, got {ch}")
    if cx % 4 or not 0 < cx <= KERNEL_MAX_CX:
        raise ValueError(f"the kernel takes Cx a multiple of 4 in [4, {KERNEL_MAX_CX}], got {cx}")
    if min(bsz, height, width) <= 0 or bsz > 65535:
        raise ValueError(f"the kernel takes 1 <= B <= 65535 and H, W >= 1, got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"the fused step runs on cpu or cuda tensors, not {x.device}")


def _library(name: str, entries, n_pointers: int) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu`` with its entry points typed:
    ``n_pointers`` pointers, then (B, H, W, Cx, Ch, device), then the stream."""
    return _build.load_typed(
        name, entries.values(),
        [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def build() -> None:
    """Build (or load) both kernels' libraries now, one nvcc each, run
    together, rather than at first launch."""
    _build.load_all(["fused_convlstm_step", "fused_convlstm_step_bwd"])


def _step(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 without autograd: the plain version for CPU tensors, else the kernel."""
    if all(t.device.type == "cpu" for t in (x, h, c, wx, wh, b)):
        return fused_convlstm_step_ref(x, h, c, wx, wh, b)
    _check(x, h, c, wx, wh, b)
    lib = _library("fused_convlstm_step", _ENTRY, 8)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    bsz, height, width, cx = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        bsz, height, width, cx, h.shape[-1], x.device.index, stream,
    )
    _build.raise_on(err, lib, "fused_convlstm_step")
    fused_convlstm_step.launches += 1
    return h_out, c_out


def gate_bwd(x, h, c, wx, wh, b, dh_next, dc_next) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (x, h, c, Wx, Wh, b, dh', dc') -> (dgates, dc_prev), NHWC.

    CPU tensors take :func:`gate_bwd_ref`; CUDA tensors launch the kernel on
    the current stream, counted in ``gate_bwd.launches``.
    """
    args = (x, h, c, wx, wh, b, dh_next, dc_next)
    if all(t.device.type == "cpu" for t in args):
        return gate_bwd_ref(*args)
    _check(x, h, c, wx, wh, b, dh_next=dh_next, dc_next=dc_next)
    lib = _library("fused_convlstm_step_bwd", _BWD_ENTRY, 10)
    bsz, height, width, cx = x.shape
    ch = h.shape[-1]
    dgates = torch.empty(bsz, height, width, 4 * ch, dtype=x.dtype, device=x.device)
    dc_prev = torch.empty_like(c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _BWD_ENTRY[x.dtype])(
        *(t.data_ptr() for t in args), dgates.data_ptr(), dc_prev.data_ptr(),
        bsz, height, width, cx, ch, x.device.index, stream,
    )
    _build.raise_on(err, lib, "gate_bwd")
    gate_bwd.launches += 1
    return dgates, dc_prev


gate_bwd.launches = 0


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class FusedConvLSTMStep(torch.autograd.Function):
    """The step under autograd, ``fused_convlstm_step``'s ``custom_vjp``.

    Forward: K1 (its plain version on the CPU); saves ``(x, h, c, wx, wh,
    b)``. Backward, as ``_bwd`` with its default merged linear grads: K2
    recomputes the gates and gives (dgates, dc_prev); one data-grad conv over
    ``[x | h]`` with ``[wx | wh]`` gives dx and dh, one weight-grad conv dWx
    and dWh (both library convs); db sums dgates.
    """

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return _step(x, h, c, wx, wh, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh_next, dc_next):
        x, h, c, wx, wh, b = ctx.saved_tensors
        # cotangents arrive as slices of the next step's merged data grad
        dgates, dc_prev = gate_bwd(x, h, c, wx, wh, b, dh_next.contiguous(),
                                   dc_next.contiguous())
        cx = x.shape[-1]
        need = ctx.needs_input_grad
        dx = dh = dwx = dwh = db = None
        dg = _nchw(dgates)
        if need[0] or need[1] or need[3] or need[4]:
            xh = _nchw(torch.cat([x, h], dim=-1))
            w3c = torch.cat([wx, wh], dim=2).permute(3, 2, 0, 1)  # OIHW
        if need[0] or need[1]:
            dxh = torch.nn.grad.conv2d_input(xh.shape, w3c, dg, padding=1)
            dxh = dxh.permute(0, 2, 3, 1)
            dx, dh = dxh[..., :cx], dxh[..., cx:]
        if need[3] or need[4]:
            dw3 = torch.nn.grad.conv2d_weight(xh, w3c.shape, dg, padding=1)
            dw3 = dw3.permute(2, 3, 1, 0)  # HWIO
            dwx, dwh = dw3[:, :, :cx], dw3[:, :, cx:]
        if need[5]:
            db = dgates.sum(dim=(0, 1, 2)).to(b.dtype)
        return dx, dh, dc_prev if need[2] else None, dwx, dwh, db


def fused_convlstm_step(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ConvLSTM step: (x, h, c, Wx, Wh, b) -> (h', c'), NHWC.

    CPU tensors take :func:`fused_convlstm_step_ref`; CUDA tensors launch K1
    on the current stream, counted in ``fused_convlstm_step.launches``. With
    grad mode on and an input that requires grad, the step runs as
    :class:`FusedConvLSTMStep`, whose backward launches K2; otherwise
    (``no_grad``, ``inference_mode``) it is the bare K1 launch and saves
    nothing.
    """
    args = (x, h, c, wx, wh, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedConvLSTMStep.apply(*args)
    return _step(*args)


fused_convlstm_step.launches = 0
