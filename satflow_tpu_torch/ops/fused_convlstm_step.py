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
CUDA tensors, or raises; nothing falls back on a failure. Under autograd the
step is :class:`FusedConvLSTMStep`, whose backward is K2 plus the merged
linear grads as library convs, as ``_bwd`` leaves them to XLA.

Dispatch (:func:`kernel_takes`), the counterpart of the JAX dispatcher's
``c.shape[-1] % 8 == 0``: K1 and K2 are built for the hidden widths
``KERNEL_HIDDEN_WIDTHS`` = 8, 16, 32, 64, 128, 256 and any input width Cx
from 1 to ``KERNEL_MAX_CX`` = 256, in float32 (f32 FMAs on the CUDA cores)
and in bfloat16 (the tensor cores, ``csrc/convlstm_mma.cuh``); above 128 a
block owns a group of 128 hidden channels. CUDA tensors of any hidden width
from 1 to 256 launch the kernels: a width the kernels are not built for is
zero-padded to the next one that is (:func:`padded_hidden`,
:func:`pad_step_operands`; 129-255 to 256, the last group of 128 partly
zeros) and the outputs are sliced back. That is exact: a padded channel's
gate sums are all zero, so its c' = σ(0)·0 + σ(0)·tanh(0) = 0 and h' =
σ(0)·tanh(0) = 0, and it reaches the real channels only through zero rows of
``wh``. The padded call is a counted launch of K1 / K2 like any other (a Ch
with Ch % 8 != 0, which the JAX dispatcher sends to its XLA step, is padded
like the rest). CUDA tensors with Ch above 256 or Cx above 256 raise: on the
card a wrapper launches its kernel or raises, and a caller who wants the
plain step there names it (the models take ``step=fused_convlstm_step_ref``).
Anything else the kernels do not take (a dtype that is not float32 or
bfloat16, tensors on different devices, wrong shapes, non-contiguous or
misaligned tensors) raises too, as does a failed build or launch.

The halo-tensor variant ``_step_pallas_halo`` is ported as K1h
(``csrc/fused_convlstm_step_halo.cu``, :func:`fused_convlstm_step_halo`): the
same step, but the image is cut into row blocks of ``block_h`` = 8 rows and
the row above and below each block is gathered outside the kernel by
:func:`build_halo` into a side tensor with the image's edge zeros in it, so
the kernel tests no row index. It shares K1's contraction (the tensor cores
in bfloat16) and K1's width rule and padding. As in the JAX dispatcher the environment
variable ``SATFLOW_STEP_VARIANT``, read at call time, chooses the forward of
:func:`fused_convlstm_step`: unset or ``3pass`` is K1, ``halo`` is K1h, any
other value raises. The backward is K2 whatever the variant.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from satflow_tpu_torch.ops import _build

#: hidden widths K1, K2 and K1h are compiled for
KERNEL_HIDDEN_WIDTHS = (8, 16, 32, 64, 128, 256)
#: hidden channels a block owns at most: wider steps run in groups of these
KERNEL_BLOCK_CH = 128
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
_HALO_ENTRY = {
    torch.float32: "satflow_fused_convlstm_step_halo_f32",
    torch.bfloat16: "satflow_fused_convlstm_step_halo_bf16",
}
#: rows per row block the halo kernel is compiled for
HALO_BLOCK_H = 8
#: the values of SATFLOW_STEP_VARIANT
STEP_VARIANTS = ("3pass", "halo")


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


def build_halo(a: torch.Tensor, block_h: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/block_h, 2, W, C), ``_build_halo`` on the port's
    unpadded layout: ``[:, r, 0]`` is the row above row block r (zeros for
    r = 0) and ``[:, r, 1]`` the row below it (zeros for the last block)."""
    bsz, height, width, ch = a.shape
    if block_h <= 0 or height % block_h:
        raise ValueError(f"the halo variant needs H % block_h == 0, got H={height}, "
                         f"block_h={block_h}")
    zero = a.new_zeros(bsz, 1, width, ch)
    # row above block r = image row r*bh - 1; row below = image row (r+1)*bh
    tops = torch.cat([zero, a[:, block_h - 1::block_h][:, :-1]], dim=1)
    bots = torch.cat([a[:, block_h::block_h], zero], dim=1)
    return torch.stack([tops, bots], dim=2)


def _slabs(a: torch.Tensor, halo: torch.Tensor, block_h: int) -> torch.Tensor:
    """Each row block of ``a`` between its two halo rows, the blocks folded
    into the batch: (B·H/block_h, block_h + 2, W, C)."""
    bsz, height, width, ch = a.shape
    blocks = a.reshape(bsz, height // block_h, block_h, width, ch)
    slab = torch.cat([halo[:, :, 0:1], blocks, halo[:, :, 1:2]], dim=2)
    return slab.reshape(-1, block_h + 2, width, ch)


def _conv3x3_valid_h(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 conv of NHWC ``x`` with an HWIO kernel, VALID on H and SAME on W."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=(0, 1))
    return y.permute(0, 2, 3, 1)


def fused_convlstm_step_halo_ref(x, h, c, wx, wh, b, block_h: int = HALO_BLOCK_H
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1h's plain version: every row block's slab is put together from the
    block and :func:`build_halo`'s side tensor, and convolved VALID on H, as
    the kernel reads it; then the f32 gate math."""
    gates = (_conv3x3_valid_h(_slabs(x, build_halo(x, block_h), block_h), wx).float()
             + _conv3x3_valid_h(_slabs(h, build_halo(h, block_h), block_h), wh).float()
             + b.float()).reshape(*c.shape[:3], -1)
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


def kernel_takes(cx: int, ch: int) -> bool:
    """The dispatch rule of K1, K2 and K1h on CUDA tensors: 1 <= Ch <= 256
    and 1 <= Cx <= 256 launch the kernels (a Ch they are not built for padded
    to :func:`padded_hidden`), any other width raises."""
    return 1 <= ch <= KERNEL_HIDDEN_WIDTHS[-1] and 1 <= cx <= KERNEL_MAX_CX


def padded_hidden(ch: int, widths=KERNEL_HIDDEN_WIDTHS) -> int:
    """The hidden width a kernel runs ``ch`` at: the smallest of the widths
    it is built for (by default K1's, ``KERNEL_HIDDEN_WIDTHS``) that is >= ch."""
    for width in widths:
        if ch <= width:
            return width
    raise ValueError(f"hidden width {ch} is above the kernels' largest, {widths[-1]}")


def width_rule(widths=KERNEL_HIDDEN_WIDTHS, max_cx: int = KERNEL_MAX_CX) -> str:
    """The width rule of kernels built for ``widths``, as the refusals name it."""
    return (f"1 <= Ch <= {widths[-1]} (built for {tuple(widths)}, other widths zero-padded "
            f"to the next of them) and 1 <= Cx <= {max_cx}")


def pad_channels(t: torch.Tensor, ch_to: int) -> torch.Tensor:
    """(..., Ch) -> (..., ch_to): zeros appended to the last axis."""
    return F.pad(t, (0, ch_to - t.shape[-1]))


def pad_gate_columns(t: torch.Tensor, ch_to: int) -> torch.Tensor:
    """(..., 4Ch) -> (..., 4·ch_to): each of the four gate blocks (i, f, o, g)
    padded from Ch to ch_to columns with zeros."""
    ch = t.shape[-1] // 4
    return F.pad(t.reshape(*t.shape[:-1], 4, ch), (0, ch_to - ch)).reshape(
        *t.shape[:-1], 4 * ch_to)


def slice_gate_columns(t: torch.Tensor, ch: int) -> torch.Tensor:
    """(..., 4·Ch') -> (..., 4Ch): the first ``ch`` columns of each gate block,
    the inverse of :func:`pad_gate_columns`."""
    ch_from = t.shape[-1] // 4
    return t.reshape(*t.shape[:-1], 4, ch_from)[..., :ch].reshape(*t.shape[:-1], 4 * ch)


def pad_step_weights(wx, wh, b, ch_to: int):
    """The step's (wx, wh, b) at hidden width ``ch_to`` >= Ch: ``wx`` and ``b``
    get zero gate columns, ``wh`` zero input rows and zero gate columns."""
    return (pad_gate_columns(wx, ch_to),
            F.pad(pad_gate_columns(wh, ch_to), (0, 0, 0, ch_to - wh.shape[2])),
            pad_gate_columns(b, ch_to))


def pad_step_operands(h, c, wx, wh, b, ch_to: int):
    """The step's (h, c, wx, wh, b) at hidden width ``ch_to`` >= Ch: h and c
    get zero channels, the weights :func:`pad_step_weights`. The step on these
    computes the unpadded step's (h', c') in its first Ch channels and exact
    zeros in the rest."""
    return (pad_channels(h, ch_to), pad_channels(c, ch_to), *pad_step_weights(wx, wh, b, ch_to))


def _check(x, h, c, wx, wh, b, **state_like) -> None:
    """Raise on anything the kernels do not take (the device type and the
    alignment last, so that the shape checks can be exercised without a
    card). ``state_like`` are further tensors of c's shape (the backward's
    dh' and dc')."""
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
    if not kernel_takes(cx, ch):
        raise ValueError(
            f"the kernels take {width_rule()}, got Ch={ch}, Cx={cx}; the plain step "
            "(fused_convlstm_step_ref) takes any width")
    groups = -(-padded_hidden(ch) // KERNEL_BLOCK_CH)  # blocks an image along the grid's z
    if min(bsz, height, width) <= 0 or bsz * groups > 65535:
        raise ValueError(f"the kernel takes 1 <= B <= {65535 // groups} at Ch={ch} and H, W >= 1, "
                         f"got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"the fused step runs on cpu or cuda tensors, not {x.device}")
    _check_aligned(x.dtype, ch, **named)


def _check_aligned(dtype: torch.dtype, ch: int, **named) -> None:
    """Raise on a misaligned operand (read from the storage: real tensors
    only). bfloat16 is copied 16 bytes at a time, float32 read and written as
    pairs; x and b are read by the element; at a width that is padded first
    the kernel sees the padded copies, which are fresh allocations."""
    align = 16 if dtype == torch.bfloat16 else 8
    for name, t in named.items():
        if ch in KERNEL_HIDDEN_WIDTHS and name not in ("x", "b") and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def _library(name: str, entries, n_pointers: int) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu`` with its entry points typed:
    ``n_pointers`` pointers, then (B, H, W, Cx, Ch, device), then the stream."""
    return _build.load_typed(
        name, entries.values(),
        [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def build() -> None:
    """Build (or load) the three kernels' libraries now, one nvcc each, run
    together, rather than at first launch."""
    _build.load_all(["fused_convlstm_step", "fused_convlstm_step_bwd",
                     "fused_convlstm_step_halo"])


def step_variant() -> str:
    """``SATFLOW_STEP_VARIANT`` as it stands now: ``"3pass"`` (also when
    unset) or ``"halo"``; any other value raises."""
    variant = os.environ.get("SATFLOW_STEP_VARIANT") or "3pass"
    if variant not in STEP_VARIANTS:
        raise ValueError(f"SATFLOW_STEP_VARIANT={variant!r}: expected one of {STEP_VARIANTS}")
    return variant


def _launch_step(counter, x, h, c, wx, wh, b, halo: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (or K1h with ``halo``) on checked CUDA tensors: a hidden width the
    kernels are not built for is zero-padded to the next one that is and the
    outputs sliced back; the launch is counted on ``counter``."""
    name, entries = (("fused_convlstm_step_halo", _HALO_ENTRY) if halo
                     else ("fused_convlstm_step", _ENTRY))
    ch = h.shape[-1]
    if ch not in KERNEL_HIDDEN_WIDTHS:
        h, c, wx, wh, b = pad_step_operands(h, c, wx, wh, b, padded_hidden(ch))
    # K1h reads each row block's edge rows from the side tensors
    ins = ((x, build_halo(x, HALO_BLOCK_H), h, build_halo(h, HALO_BLOCK_H)) if halo
           else (x, h)) + (c, wx, wh, b)
    lib = _library(name, entries, len(ins) + 2)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    bsz, height, width, cx = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, entries[x.dtype])(
        *(t.data_ptr() for t in ins), h_out.data_ptr(), c_out.data_ptr(),
        bsz, height, width, cx, h.shape[-1], x.device.index, stream,
    )
    _build.raise_on(err, lib, counter.__name__)
    counter.launches += 1
    if ch != h.shape[-1]:
        return h_out[..., :ch].contiguous(), c_out[..., :ch].contiguous()
    return h_out, c_out


def fused_convlstm_step_halo(x, h, c, wx, wh, b, block_h: int = HALO_BLOCK_H
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1h: one ConvLSTM step through the halo-tensor variant, without autograd.

    CPU tensors take :func:`fused_convlstm_step_halo_ref`; CUDA tensors of the
    widths in :func:`kernel_takes` gather the two side tensors with
    :func:`build_halo` and launch the kernel on the current stream (a hidden
    width it is not built for zero-padded to the next one that is, as K1),
    counted in ``fused_convlstm_step_halo.launches``. A geometry the kernel
    does not take (H % block_h != 0, block_h != 8) or any other width raises.
    """
    if all(t.device.type == "cpu" for t in (x, h, c, wx, wh, b)):
        return fused_convlstm_step_halo_ref(x, h, c, wx, wh, b, block_h)
    # the kernel's own geometry first: _check ends with the device type
    if x.dim() == 4 and (block_h != HALO_BLOCK_H or x.shape[1] % block_h):
        raise ValueError(
            f"the halo kernel is built for row blocks of {HALO_BLOCK_H} rows and needs "
            f"H % block_h == 0, got block_h={block_h}, H={x.shape[1]}")
    _check(x, h, c, wx, wh, b)
    return _launch_step(fused_convlstm_step_halo, x, h, c, wx, wh, b, halo=True)


fused_convlstm_step_halo.launches = 0


def _launch(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors: the checks, then the launch (a hidden width K1 is
    not built for zero-padded inside, the outputs sliced back), counted in
    ``fused_convlstm_step.launches``."""
    _check(x, h, c, wx, wh, b)
    return _launch_step(fused_convlstm_step, x, h, c, wx, wh, b, halo=False)


# K1 as the dispatcher op ``satflow::fused_convlstm_step``, so that
# torch.export records it and an exported program runs it (with
# satflow_tpu_torch.ops imported): the launch for CUDA tensors, the plain
# version for CPU ones, no autograd of its own (FusedConvLSTMStep wraps it).
_LIB = torch.library.Library("satflow", "FRAGMENT")
_LIB.define("fused_convlstm_step(Tensor x, Tensor h, Tensor c, Tensor wx, Tensor wh, "
            "Tensor b) -> (Tensor, Tensor)")
# (each looked up when called, so that the module's names can be patched)
_LIB.impl("fused_convlstm_step", lambda *a: _launch(*a), "CUDA")
_LIB.impl("fused_convlstm_step", lambda *a: fused_convlstm_step_ref(*a), "CPU")


@torch.library.register_fake("satflow::fused_convlstm_step", lib=_LIB)
def _step_fake(x, h, c, wx, wh, b):
    """The shapes the launch returns: h' and c' of the unpadded hidden width,
    in x's dtype."""
    return x.new_empty(h.shape), x.new_empty(c.shape)


def _step(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step without autograd, by ``SATFLOW_STEP_VARIANT``: K1h under
    ``halo``, else K1's op: the plain version for CPU tensors, else the
    kernel. Tensors on another device (meta ones stand in for a card in the
    tests) take the kernel's checks here, which refuse them."""
    args = (x, h, c, wx, wh, b)
    if step_variant() == "halo":
        return fused_convlstm_step_halo(*args)
    if any(t.device.type not in ("cpu", "cuda") for t in args):
        _check(*args)
    return torch.ops.satflow.fused_convlstm_step.default(*args)


def gate_bwd(x, h, c, wx, wh, b, dh_next, dc_next) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (x, h, c, Wx, Wh, b, dh', dc') -> (dgates, dc_prev), NHWC.

    CPU tensors take :func:`gate_bwd_ref`; CUDA tensors launch the kernel on
    the current stream, counted in ``gate_bwd.launches``, or raise.
    """
    args = (x, h, c, wx, wh, b, dh_next, dc_next)
    if all(t.device.type == "cpu" for t in args):
        return gate_bwd_ref(*args)
    _check(x, h, c, wx, wh, b, dh_next=dh_next, dc_next=dc_next)
    bsz, height, width, cx = x.shape
    ch = ch_in = h.shape[-1]
    if ch not in KERNEL_HIDDEN_WIDTHS:  # the padded cotangents are zeros
        ch = padded_hidden(ch_in)
        args = (x, *pad_step_operands(h, c, wx, wh, b, ch),
                pad_channels(dh_next, ch), pad_channels(dc_next, ch))
    lib = _library("fused_convlstm_step_bwd", _BWD_ENTRY, 10)
    dgates = torch.empty(bsz, height, width, 4 * ch, dtype=x.dtype, device=x.device)
    dc_prev = torch.empty(bsz, height, width, ch, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _BWD_ENTRY[x.dtype])(
        *(t.data_ptr() for t in args), dgates.data_ptr(), dc_prev.data_ptr(),
        bsz, height, width, cx, ch, x.device.index, stream,
    )
    _build.raise_on(err, lib, "gate_bwd")
    gate_bwd.launches += 1
    if ch != ch_in:
        return (slice_gate_columns(dgates, ch_in).contiguous(),
                dc_prev[..., :ch_in].contiguous())
    return dgates, dc_prev


gate_bwd.launches = 0


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class FusedConvLSTMStep(torch.autograd.Function):
    """The step under autograd, ``fused_convlstm_step``'s ``custom_vjp``.

    Forward: K1, or K1h under ``SATFLOW_STEP_VARIANT=halo`` (their plain
    versions on the CPU); saves ``(x, h, c, wx, wh, b)``. Backward, whatever
    the variant, as ``_bwd`` with its default merged linear grads: K2
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

    CPU tensors take :func:`fused_convlstm_step_ref`; CUDA tensors of the
    widths in :func:`kernel_takes` launch K1 on the current stream (a hidden
    width it is not built for zero-padded to the next one that is), counted in
    ``fused_convlstm_step.launches``, and of any other width raise. Under
    ``SATFLOW_STEP_VARIANT=halo`` the forward is :func:`fused_convlstm_step_halo`
    instead (K1h, counted there). With
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
