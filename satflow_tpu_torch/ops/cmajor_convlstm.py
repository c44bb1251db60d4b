"""Channel-major ConvLSTM step and 3×3 conv head: the CUDA kernels' wrappers,
their plain PyTorch versions, the layout changes and the autograd Functions.

Counterpart of ``satflow_tpu/ops/pallas/cmajor_convlstm.py``: the TPU
kernels ``_cell_pallas``, ported as K6a, and ``_conv_pallas``, ported as K6b
(both in ``csrc/cmajor_convlstm.cu``). The recurrent carries are stored
channel-major with the image flattened, ``(B, C, H·W)``, across a whole
rollout, so that neighbouring threads own neighbouring pixels of one channel
and every access along W is coalesced; the layout changes once per rollout,
not once per step.

The JAX layout pads the image with ``block_h`` zero rows above and below
(``SP = (H + 2·block_h)·W``) to keep the TPU's lane slices aligned. Like the
NHWC kernels' W+2 halo, the pad rows are dropped here: the carry is plain
``(B, C, H·W)`` and the kernels supply the zeros of SAME padding.
:func:`from_cmajor_seq` gives the same frames as the JAX function.

Each wrapper (:func:`cmajor_convlstm_step` for K6a, :func:`cmajor_conv3x3`
for K6b) runs its plain version for CPU tensors and launches its kernel for
CUDA tensors, or raises; nothing falls back from one to the other. Under
autograd each is a Function whose backward goes through the NHWC plain step /
a plain conv, as the JAX VJPs do: this is the inference formulation.

The geometry gate :func:`cmajor_supported` is the JAX one (W % 128 == 0,
channels % 8 == 0): it decides whether a model takes this formulation at all,
on every device, so that the port and the JAX package agree on which rollout
a configuration runs. K6a is built for the hidden widths
``CELL_HIDDEN_WIDTHS`` = 8, 16, 32, 64, 128 and any Cx from 1 to 256
(:func:`cell_takes`): another hidden width up to 128 is zero-padded to the
next one that is, exactly as the NHWC step pads it, and the outputs sliced
back; K6b takes Cin <= 128 and Cout <= 16. A CUDA tensor outside that is
refused.

K6a and K6b are the dispatcher ops ``satflow::cmajor_convlstm_step`` and
``satflow::cmajor_conv3x3``, so that ``torch.export`` records a
channel-major decoder and an exported program runs the two kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from satflow_tpu_torch.ops import _build
from satflow_tpu_torch.ops.fused_convlstm_step import (
    conv3x3,
    fused_convlstm_step_ref,
    pad_step_weights,
    padded_hidden,
    width_rule,
)

#: hidden widths K6a is compiled for
CELL_HIDDEN_WIDTHS = (8, 16, 32, 64, 128)
#: largest input widths whose staged windows fit a block's shared memory
KERNEL_MAX_CX = 256
KERNEL_MAX_CIN = 128
#: most output channels K6b's per-thread accumulators hold
KERNEL_MAX_COUT = 16

_SOURCE = "cmajor_convlstm"
_CELL_ENTRY = {
    torch.float32: "satflow_cmajor_cell_f32",
    torch.bfloat16: "satflow_cmajor_cell_bf16",
}
_CONV_ENTRY = {
    torch.float32: "satflow_cmajor_conv_f32",
    torch.bfloat16: "satflow_cmajor_conv_bf16",
}


def cmajor_supported(height: int, width: int, *channels: int) -> bool:
    """Whether a model takes the channel-major formulation at this geometry:
    the JAX package's rule, W % 128 == 0 and every channel count % 8 == 0."""
    return height > 0 and width % 128 == 0 and all(c % 8 == 0 for c in channels)


# ---------------------------------------------------------------------------
# layout changes (outside the rollout's loop; amortised over its horizon)
# ---------------------------------------------------------------------------


def to_cmajor(a: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) NHWC -> (B, C, H·W) channel-major, contiguous."""
    b, h, w, c = a.shape
    return a.permute(0, 3, 1, 2).reshape(b, c, h * w).contiguous()


def from_cmajor(a: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, C, H·W) -> (B, H, W, C), contiguous."""
    b, c, _ = a.shape
    return a.reshape(b, c, height, width).permute(0, 2, 3, 1).contiguous()


def from_cmajor_seq(a: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, T, C, H·W) stacked rollout output -> (B, T, H, W, C): one
    transpose for the whole rollout instead of one per step."""
    b, t, c, _ = a.shape
    return a.reshape(b, t, c, height, width).permute(0, 1, 3, 4, 2).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def cmajor_convlstm_step_ref(x, h, c, wx, wh, b, height: int, width: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a's plain version, ``_step_ref_cmajor``: the NHWC plain step between
    two layout changes."""
    h2, c2 = fused_convlstm_step_ref(
        from_cmajor(x, height, width), from_cmajor(h, height, width),
        from_cmajor(c, height, width), wx, wh, b)
    return to_cmajor(h2), to_cmajor(c2)


def cmajor_conv3x3_ref(x, w, b, height: int, width: int) -> torch.Tensor:
    """K6b's plain version, ``_conv_ref_cmajor``: a SAME library conv in the
    input dtype plus the bias, between two layout changes."""
    return to_cmajor(conv3x3(from_cmajor(x, height, width), w) + b)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_common(named: dict, first: str, height: int, width: int) -> None:
    ref = named[first]
    for name, t in named.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {first} on {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, {first} is {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if ref.dtype not in _CELL_ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {ref.dtype}")
    if ref.dim() != 3 or ref.shape[2] != height * width or min(ref.shape) <= 0:
        raise ValueError(
            f"{first} must be (B, C, H*W) with H*W = {height}*{width}, got {tuple(ref.shape)}")
    if ref.shape[0] > 65535 or -(-height // 4) > 65535:
        raise ValueError(f"the kernel takes B <= 65535 and H <= 262140, got {tuple(ref.shape)}")


def cell_takes(cx: int, ch: int) -> bool:
    """K6a's dispatch rule on CUDA tensors: 1 <= Ch <= 128 (a width it is not
    built for padded to the next that is) and 1 <= Cx <= 256."""
    return 1 <= ch <= CELL_HIDDEN_WIDTHS[-1] and 1 <= cx <= KERNEL_MAX_CX


def _check_cell(x, h, c, wx, wh, b, height, width) -> None:
    """Raise on anything K6a does not take (the device type last, so that the
    other checks can be exercised without a card)."""
    _check_common(dict(x=x, h=h, c=c, wx=wx, wh=wh, b=b), "x", height, width)
    cx, ch = x.shape[1], h.shape[1]
    if h.dim() != 3 or h.shape[0] != x.shape[0] or h.shape[2] != x.shape[2] or c.shape != h.shape:
        raise ValueError(
            f"x {tuple(x.shape)}, h {tuple(h.shape)} and c {tuple(c.shape)} must share "
            "(B, ·, H*W), and h and c their shape")
    if (tuple(wx.shape) != (3, 3, cx, 4 * ch) or tuple(wh.shape) != (3, 3, ch, 4 * ch)
            or tuple(b.shape) != (4 * ch,)):
        raise ValueError(
            f"weights must be wx (3,3,{cx},{4 * ch}), wh (3,3,{ch},{4 * ch}), "
            f"b ({4 * ch},); got {tuple(wx.shape)}, {tuple(wh.shape)}, {tuple(b.shape)}")
    if not cell_takes(cx, ch):
        raise ValueError(
            f"the channel-major step takes {width_rule(CELL_HIDDEN_WIDTHS, KERNEL_MAX_CX)}; "
            f"got Cx={cx}, Ch={ch}")
    if x.device.type != "cuda":
        raise ValueError(f"the channel-major step runs on cpu or cuda tensors, not {x.device}")


def _check_conv(x, w, b, height, width) -> None:
    """Raise on anything K6b does not take (the device type last)."""
    _check_common(dict(x=x, w=w, b=b), "x", height, width)
    cin = x.shape[1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin) or tuple(b.shape) != (w.shape[3],):
        raise ValueError(
            f"weights must be w (3,3,{cin},Cout) and b (Cout,); got {tuple(w.shape)}, "
            f"{tuple(b.shape)}")
    if cin > KERNEL_MAX_CIN or not 0 < w.shape[3] <= KERNEL_MAX_COUT:
        raise ValueError(
            f"the kernel takes Cin <= {KERNEL_MAX_CIN} and 1 <= Cout <= {KERNEL_MAX_COUT}; "
            f"got Cin={cin}, Cout={w.shape[3]}")
    if x.device.type != "cuda":
        raise ValueError(f"the channel-major conv runs on cpu or cuda tensors, not {x.device}")


def _library() -> ctypes.CDLL:
    """The kernels' library with both families of entry points typed: the
    cell's 8 pointers, the conv's 4, each then five ints (B, H, W and two
    channel counts), the device, and the stream."""
    tail = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    _build.load_typed(_SOURCE, _CELL_ENTRY.values(), [ctypes.c_void_p] * 8 + tail)
    return _build.load_typed(_SOURCE, _CONV_ENTRY.values(), [ctypes.c_void_p] * 4 + tail)


def build() -> None:
    """Build (or load) the kernels' library now rather than at first launch."""
    _build.load(_SOURCE)


def _launch_cell(x, h, c, wx, wh, b, height, width) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a on CUDA tensors: the checks, then the launch (a hidden width it is
    not built for zero-padded, the outputs sliced back), counted in
    ``cmajor_convlstm_step.launches``."""
    _check_cell(x, h, c, wx, wh, b, height, width)
    ch = h.shape[1]
    if ch not in CELL_HIDDEN_WIDTHS:  # the NHWC step's padding, on the channel axis
        ch_to = padded_hidden(ch, CELL_HIDDEN_WIDTHS)
        h, c = (F.pad(t, (0, 0, 0, ch_to - ch)) for t in (h, c))
        wx, wh, b = pad_step_weights(wx, wh, b, ch_to)
    lib = _library()
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _CELL_ENTRY[x.dtype])(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        x.shape[0], height, width, x.shape[1], h.shape[1], x.device.index, stream,
    )
    _build.raise_on(err, lib, "cmajor_convlstm_step")
    cmajor_convlstm_step.launches += 1
    if ch != h.shape[1]:
        return h_out[:, :ch].contiguous(), c_out[:, :ch].contiguous()
    return h_out, c_out


def _launch_conv(x, w, b, height, width) -> torch.Tensor:
    """K6b on CUDA tensors: the checks, then the launch, counted in
    ``cmajor_conv3x3.launches``."""
    _check_conv(x, w, b, height, width)
    lib = _library()
    out = torch.empty(x.shape[0], w.shape[3], x.shape[2], dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _CONV_ENTRY[x.dtype])(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        x.shape[0], height, width, x.shape[1], w.shape[3], x.device.index, stream,
    )
    _build.raise_on(err, lib, "cmajor_conv3x3")
    cmajor_conv3x3.launches += 1
    return out


# K6a and K6b as the dispatcher ops ``satflow::cmajor_convlstm_step`` and
# ``satflow::cmajor_conv3x3``, so that torch.export records them and an
# exported program runs them (with satflow_tpu_torch.ops imported): the
# launch for CUDA tensors, the plain version for CPU ones, no autograd of
# their own (CMajorConvLSTMStep and CMajorConv3x3 wrap them).
_LIB = torch.library.Library("satflow", "FRAGMENT")
_LIB.define("cmajor_convlstm_step(Tensor x, Tensor h, Tensor c, Tensor wx, Tensor wh, "
            "Tensor b, int height, int width) -> (Tensor, Tensor)")
_LIB.define("cmajor_conv3x3(Tensor x, Tensor w, Tensor b, int height, int width) -> Tensor")
# (each looked up when called, so that the module's names can be patched)
_LIB.impl("cmajor_convlstm_step", lambda *a: _launch_cell(*a), "CUDA")
_LIB.impl("cmajor_convlstm_step", lambda *a: cmajor_convlstm_step_ref(*a), "CPU")
_LIB.impl("cmajor_conv3x3", lambda *a: _launch_conv(*a), "CUDA")
_LIB.impl("cmajor_conv3x3", lambda *a: cmajor_conv3x3_ref(*a), "CPU")


@torch.library.register_fake("satflow::cmajor_convlstm_step", lib=_LIB)
def _cell_fake(x, h, c, wx, wh, b, height, width):
    """h' and c' of the unpadded hidden width, channel-major, in x's dtype."""
    return x.new_empty(h.shape), x.new_empty(c.shape)


@torch.library.register_fake("satflow::cmajor_conv3x3", lib=_LIB)
def _conv_fake(x, w, b, height, width):
    """(B, Cout, H·W) in x's dtype."""
    return x.new_empty(x.shape[0], w.shape[3], x.shape[2])


def _step(x, h, c, wx, wh, b, height, width) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a's op without autograd: the plain version for CPU tensors, else the
    kernel. Tensors on another device take the kernel's checks here, which
    refuse them."""
    args = (x, h, c, wx, wh, b)
    if any(t.device.type not in ("cpu", "cuda") for t in args):
        _check_cell(*args, height, width)
    return torch.ops.satflow.cmajor_convlstm_step.default(*args, height, width)


def _conv(x, w, b, height, width) -> torch.Tensor:
    """K6b's op without autograd: the plain version for CPU tensors, else the
    kernel. Tensors on another device take the kernel's checks here."""
    if any(t.device.type not in ("cpu", "cuda") for t in (x, w, b)):
        _check_conv(x, w, b, height, width)
    return torch.ops.satflow.cmajor_conv3x3.default(x, w, b, height, width)


class CMajorConvLSTMStep(torch.autograd.Function):
    """The step under autograd, ``cmajor_convlstm_step``'s ``custom_vjp``:
    forward as :func:`_step`, saving its inputs; backward recomputes through
    :func:`cmajor_convlstm_step_ref` (the NHWC plain step between layout
    changes) and takes its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b, height, width):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        ctx.geometry = (height, width)
        return _step(x, h, c, wx, wh, b, height, width)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh_next, dc_next):
        args = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = cmajor_convlstm_step_ref(*args, *ctx.geometry)
        return (*torch.autograd.grad(out, args, (dh_next, dc_next)), None, None)


class CMajorConv3x3(torch.autograd.Function):
    """The head under autograd, ``cmajor_conv3x3``'s ``custom_vjp``: backward
    recomputes through :func:`cmajor_conv3x3_ref`."""

    @staticmethod
    def forward(ctx, x, w, b, height, width):
        ctx.save_for_backward(x, w, b)
        ctx.geometry = (height, width)
        return _conv(x, w, b, height, width)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        args = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = cmajor_conv3x3_ref(*args, *ctx.geometry)
        return (*torch.autograd.grad(out, args, g), None, None)


def cmajor_convlstm_step(x, h, c, wx, wh, b, height: int, width: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ConvLSTM step with x, h, c channel-major: (B, C·, H·W) -> (h', c').

    Weights stay HWIO ((3, 3, Cx, 4C), (3, 3, Ch, 4C), (4C,)). CPU tensors take
    :func:`cmajor_convlstm_step_ref`; CUDA tensors launch K6a on the current
    stream, counted in ``cmajor_convlstm_step.launches``. With grad mode on and
    an input that requires grad it runs as :class:`CMajorConvLSTMStep`.
    """
    args = (x, h, c, wx, wh, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return CMajorConvLSTMStep.apply(*args, height, width)
    return _step(*args, height, width)


def cmajor_conv3x3(x, w, b, height: int, width: int) -> torch.Tensor:
    """SAME 3×3 conv + bias on a channel-major tensor (the output head).

    x (B, Cin, H·W); w (3, 3, Cin, Cout) HWIO; b (Cout,) -> (B, Cout, H·W).
    CPU tensors take :func:`cmajor_conv3x3_ref`; CUDA tensors launch K6b on the
    current stream, counted in ``cmajor_conv3x3.launches``. With grad mode on
    and an input that requires grad it runs as :class:`CMajorConv3x3`.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return CMajorConv3x3.apply(x, w, b, height, width)
    return _conv(x, w, b, height, width)


cmajor_convlstm_step.launches = 0
cmajor_conv3x3.launches = 0
