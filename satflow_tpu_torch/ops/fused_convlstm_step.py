"""Fused ConvLSTM step: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``satflow_tpu/ops/pallas/fused_convlstm_step.py`` (the TPU
kernel ``_step_pallas_padded`` and its unpadded sibling ``_step_pallas``).
One call computes, on unpadded NHWC tensors,

    gates = conv3x3(x, Wx) + conv3x3(h, Wh) + b       (f32 accumulation)
    i, f, o, g = split(gates, 4)
    c' = σ(f)·c + σ(i)·tanh(g);  h' = σ(o)·tanh(c')   (f32 math)

and returns ``(h', c')`` in the input dtype. Weights keep the JAX layout:
``wx`` (3, 3, Cx, 4Ch), ``wh`` (3, 3, Ch, 4Ch), ``b`` (4Ch,).

:func:`fused_convlstm_step` runs the plain version for CPU tensors and
launches the hand-written kernel (``csrc/fused_convlstm_step.cu``) for CUDA
tensors, or raises; nothing falls back from one to the other.
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


def _check(x, h, c, wx, wh, b) -> None:
    """Raise on anything the kernel does not take (the device type last, so
    that the shape checks can be exercised without a card)."""
    named = dict(x=x, h=h, c=c, wx=wx, wh=wh, b=b)
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


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_convlstm_step")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.satflow_cuda_error_string.argtypes = [ctypes.c_int]
    lib.satflow_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the kernel's library now rather than at first launch."""
    _library()


def fused_convlstm_step(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ConvLSTM step: (x, h, c, Wx, Wh, b) -> (h', c'), NHWC.

    CPU tensors take :func:`fused_convlstm_step_ref`; CUDA tensors launch the
    kernel on the current stream, counted in ``fused_convlstm_step.launches``.
    """
    if all(t.device.type == "cpu" for t in (x, h, c, wx, wh, b)):
        return fused_convlstm_step_ref(x, h, c, wx, wh, b)
    _check(x, h, c, wx, wh, b)
    lib = _library()
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    bsz, height, width, cx = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        bsz, height, width, cx, h.shape[-1], x.device.index, stream,
    )
    if err:
        msg = lib.satflow_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_convlstm_step launch failed: CUDA error {err} ({msg})")
    fused_convlstm_step.launches += 1
    return h_out, c_out


fused_convlstm_step.launches = 0
