"""int8 fused ConvLSTM step, the serving formulation: the CUDA kernel's
wrapper, its plain PyTorch version, the quantizers and the int8 rollout.

Counterpart of ``satflow_tpu/ops/pallas/fused_convlstm_int8.py``, whose TPU
kernel ``fused_convlstm_step_int8`` is ported as K5
(``csrc/fused_convlstm_int8.cu``). Quantization is static, with no
calibration pass:

- activations: ConvLSTM states are range-bound by construction
  (h = σ(o)·tanh(c') in (−1, 1); nowcasting inputs are normalised to
  [0, 1]), so one fixed scale quantizes everything: ``aq = rint(a·127)``,
  halves to even. The h carry stays int8 across the rollout.
- weights: per-output-channel symmetric int8 over the merged
  (3, 3Cx+3Ch, 4Ch) gate tensor; ``dequant[col] = s_w[col] / 127`` scales
  the int32 accumulator once per column.
- one step: ``acc`` = the SAME 3×3 conv of [xq | hq] with the int8 weights,
  summed exactly in int32; ``accf = acc·dequant + b`` in f32; the i, f, o, g
  gate math in f32; c' stored in c's dtype (bf16 in the rollout);
  ``h'q = rint(h'·127)`` stored as int8.

The port's xq and hq are unpadded NHWC int8 (the TPU's (W+2)-padded carry
is dropped; the kernel supplies the zeros of SAME padding). Inference only:
nothing here takes part in autograd.

Dispatch (:func:`kernel_takes`): K5 is built for the hidden widths
``KERNEL_HIDDEN_WIDTHS`` = 8, 16, 32, 64, 128 (the tensor-core contraction's
``Shape``) and any Cx up to 256, any B, H, W >= 1; CUDA tensors of any hidden
width from 1 to 128 and any Cx from 1 to 256 launch it, zero-padded to the
next hidden width it is built for and Cx to a multiple of 4
(:func:`kernel_widths`), the outputs sliced back. (The JAX rule, H % 8 == 0
and Ch % 8 == 0, is the TPU kernel's block geometry and is not carried over.)
The padding is exact, bit for bit at the real channels: it adds zero channels
to xq and hq and zero rows and columns to the quantized weights
(:func:`pad_quantized`), which is what quantizing zero-padded float weights
gives (the fixed activation scale does not depend on the channel count, a
zero column's scale is clamped to 1e-12 and quantizes to zeros, and the real
columns' scales do not change); a padded channel's gates are then exact
zeros, its c' and h'q zeros, and the integer sums of the real channels
unchanged. The rollout pads once per session (:func:`quantize_convlstm_params`
on a card), a direct call once per call. :func:`fused_convlstm_step_int8`
runs the plain version for CPU tensors and launches K5 for CUDA tensors, or
raises: a CUDA tensor outside the rule is refused, never handed to the plain
version. :func:`int8_gate_sums` returns K5's integer sums themselves, from the
same contraction: how the card's tests hold them to the exact ones.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from satflow_tpu_torch.ops import _build
from satflow_tpu_torch.ops.fused_convlstm_step import (
    lstm_gates,
    pad_channels,
    pad_gate_columns,
    padded_hidden,
    slice_gate_columns,
)

ACT_SCALE = 127.0
#: hidden widths the kernel is compiled for (all of them a block)
KERNEL_HIDDEN_WIDTHS = (8, 16, 32, 64, 128)
#: largest input width whose staged window the kernel takes
KERNEL_MAX_CX = 256

_SOURCE = "fused_convlstm_int8"
_ENTRY = {
    torch.float32: "satflow_fused_convlstm_step_int8_f32",
    torch.bfloat16: "satflow_fused_convlstm_step_int8_bf16",
}
_SUMS_ENTRY = "satflow_fused_convlstm_int8_sums"


# ---------------------------------------------------------------------------
# Quantization helpers
# ---------------------------------------------------------------------------


def quantize_weights(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor):
    """(wx, wh, b) -> (w3q int8 (3, 3Cx+3Ch, 4Ch), dequant f32 (1, 4Ch), b f32 (1, 4Ch)).

    Per-output-channel symmetric scales over the merged gate tensor; the
    returned ``dequant`` folds the activation scale: accf = acc_i32 * dequant.
    """
    cx, ch4 = wx.shape[2], wx.shape[3]
    ch = wh.shape[2]
    w3 = torch.cat([wx.reshape(3, 3 * cx, ch4), wh.reshape(3, 3 * ch, ch4)], dim=1).float()
    s_w = w3.abs().amax(dim=(0, 1)) / 127.0  # (4Ch,)
    s_w = s_w.clamp_min(1e-12)
    w3q = torch.round(w3 / s_w).clamp(-127, 127).to(torch.int8)
    dequant = (s_w / ACT_SCALE).reshape(1, ch4).float()
    return w3q, dequant, b.reshape(1, ch4).float()


def quantize_activations(a: torch.Tensor) -> torch.Tensor:
    """f32/bf16 in (−1, 1) -> int8 at the fixed scale (halves to even)."""
    return torch.round(a.float() * ACT_SCALE).clamp(-127, 127).to(torch.int8)


def dequantize_activations(aq: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (aq.float() * (1.0 / ACT_SCALE)).to(dtype)


def packed_depth(cx: int, ch: int) -> int:
    """Bytes of a packed column a tap: Cx and Ch each rounded up to 32."""
    return -(-cx // 32) * 32 + -(-ch // 32) * 32


def pack_weights(w3q: torch.Tensor, cx: int) -> torch.Tensor:
    """``w3q`` in the layout K5 reads: int8 (9, 4Ch, :func:`packed_depth`),
    K-major.

    Tap (dy, dx), gate column n holds that column's weights of the tap along
    the contraction: x's Cx channels, zeros up to a multiple of 32, h's Ch
    channels, zeros up to a multiple of 32. That is the byte order of the
    window K5 stages, so each 32-byte k step of a column is read as it lies
    (the B fragment of ``mma.sync.m16n8k32.s8`` holds 4 K-consecutive bytes of
    one column a register).
    """
    ch4 = w3q.shape[2]
    ch = (w3q.shape[1] - 3 * cx) // 3
    cxp = -(-cx // 32) * 32
    wxq = F.pad(w3q[:, : 3 * cx].reshape(3, 3, cx, ch4), (0, 0, 0, cxp - cx))
    whq = F.pad(w3q[:, 3 * cx:].reshape(3, 3, ch, ch4), (0, 0, 0, packed_depth(cx, ch) - cxp - ch))
    taps = torch.cat([wxq, whq], dim=2).reshape(9, -1, ch4)
    return taps.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# The step: plain version, dispatch rule, wrapper
# ---------------------------------------------------------------------------


def int8_accumulate(xq: torch.Tensor, hq: torch.Tensor, w3q: torch.Tensor) -> torch.Tensor:
    """The integer gate sums of one step, exactly: (B, H, W, 4Ch) int32.

    One formulation for both devices: a float64 library conv. Every product
    (|·| <= 127²) and every partial sum (|·| <= 9·(Cx+Ch)·127² < 2^53) is an
    integer that float64 holds exactly, in any summation order; float32
    would not be (2^24 < 1152·127²), and CUDA has no integer conv.
    """
    cx, ch = xq.shape[-1], hq.shape[-1]
    ch4 = w3q.shape[2]
    w = torch.cat([w3q[:, : 3 * cx].reshape(3, 3, cx, ch4),
                   w3q[:, 3 * cx:].reshape(3, 3, ch, ch4)], dim=2)  # HWIO over [x | h]
    xh = torch.cat([xq, hq], dim=-1).permute(0, 3, 1, 2).double()
    acc = F.conv2d(xh, w.permute(3, 2, 0, 1).double(), padding=1)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def fused_convlstm_step_int8_ref(xq, hq, c, w3q, dequant, b, w_packed=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, ``_step_ref_int8`` on unpadded tensors: the exact
    integer sums, then the kernel's f32 epilogue. Returns (h'q int8, c').
    ``w_packed`` is the wrapper's argument and is not read here."""
    acc = int8_accumulate(xq, hq, w3q)
    accf = acc.float() * dequant.reshape(1, 1, 1, -1) + b.reshape(1, 1, 1, -1)
    h_next, c_next = lstm_gates(accf, c)
    hq_next = torch.round(h_next * ACT_SCALE).to(torch.int8)  # |h| < 1: in range
    return hq_next.contiguous(), c_next.to(c.dtype).contiguous()


WIDTH_RULE = (f"1 <= Ch <= {KERNEL_HIDDEN_WIDTHS[-1]} and 1 <= Cx <= {KERNEL_MAX_CX} (built "
              f"for Ch {KERNEL_HIDDEN_WIDTHS}; other hidden widths zero-padded to the next of "
              "them, Cx to a multiple of 4)")


def kernel_takes(cx: int, ch: int) -> bool:
    """K5's dispatch rule on CUDA tensors: 1 <= Ch <= 128 and 1 <= Cx <= 256."""
    return 1 <= ch <= KERNEL_HIDDEN_WIDTHS[-1] and 1 <= cx <= KERNEL_MAX_CX


def kernel_widths(cx: int, ch: int) -> Tuple[int, int]:
    """(Cx, Ch) as K5 runs them: Cx rounded up to a multiple of 4, Ch to the
    next of ``KERNEL_HIDDEN_WIDTHS``; raises outside :func:`kernel_takes`."""
    if not kernel_takes(cx, ch):
        raise ValueError(f"the int8 step takes {WIDTH_RULE}; got Cx={cx}, Ch={ch}")
    return -(-cx // 4) * 4, padded_hidden(ch, KERNEL_HIDDEN_WIDTHS)


def pad_quantized(w3q: torch.Tensor, dequant: torch.Tensor, b: torch.Tensor, cx: int,
                  cx_to: int, ch_to: int):
    """A cell's quantized (w3q, dequant, b) at Cx, Ch -> at cx_to >= Cx, ch_to
    >= Ch: zero rows of ``w3q`` for the added input channels of x and h, and
    for the added hidden channels of each gate zero columns of ``w3q`` and
    zeros of ``dequant`` and ``b``. The real rows and columns are unchanged,
    bit for bit."""
    ch4 = w3q.shape[2]
    ch = ch4 // 4
    wxq = F.pad(w3q[:, : 3 * cx].reshape(3, 3, cx, ch4), (0, 0, 0, cx_to - cx))
    whq = F.pad(w3q[:, 3 * cx:].reshape(3, 3, ch, ch4), (0, 0, 0, ch_to - ch))
    w3 = torch.cat([wxq.reshape(3, 3 * cx_to, ch4), whq.reshape(3, 3 * ch_to, ch4)], dim=1)
    return (pad_gate_columns(w3, ch_to).contiguous(), pad_gate_columns(dequant, ch_to),
            pad_gate_columns(b, ch_to))


def _check(xq, hq, c, w3q, dequant, b, w_packed=None) -> None:
    """Raise on anything the kernel does not take (the device type and then
    the alignment last, so that the other checks can be exercised without a
    card). ``c`` is None for the sums alone."""
    named = dict(xq=xq, hq=hq, c=c, w3q=w3q, dequant=dequant, b=b, w_packed=w_packed)
    named = {name: t for name, t in named.items() if t is not None}
    for name, t in named.items():
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, dtype in (("xq", xq, torch.int8), ("hq", hq, torch.int8),
                           ("w3q", w3q, torch.int8), ("w_packed", w_packed, torch.int8),
                           ("dequant", dequant, torch.float32), ("b", b, torch.float32)):
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if c is not None and c.dtype not in _ENTRY:
        raise TypeError(f"c must be float32 or bfloat16, got {c.dtype}")
    if xq.dim() != 4 or hq.dim() != 4:
        raise ValueError(f"xq and hq must be NHWC, got {tuple(xq.shape)}, {tuple(hq.shape)}")
    bsz, height, width, cx = xq.shape
    ch = hq.shape[-1]
    if hq.shape[:3] != xq.shape[:3] or (c is not None and c.shape != hq.shape):
        raise ValueError(
            f"xq {tuple(xq.shape)}, hq {tuple(hq.shape)} and c {tuple(c.shape)} "
            "must share (B, H, W), and hq and c their shape"
        )
    if not kernel_takes(cx, ch):
        raise ValueError(f"the int8 step takes {WIDTH_RULE}; got Cx={cx}, Ch={ch}")
    packed = None if w_packed is None else tuple(w_packed.shape)
    depth = packed_depth(cx, ch)
    if (tuple(w3q.shape) != (3, 3 * cx + 3 * ch, 4 * ch)
            or packed not in (None, (9, 4 * ch, depth))
            or dequant.numel() != 4 * ch or b.numel() != 4 * ch):
        raise ValueError(
            f"weights must be w3q (3,{3 * cx + 3 * ch},{4 * ch}), w_packed "
            f"(9,{4 * ch},{depth}), dequant and b of {4 * ch} elements; got "
            f"{tuple(w3q.shape)}, {packed}, {tuple(dequant.shape)}, {tuple(b.shape)}"
        )
    if min(bsz, height, width) <= 0 or bsz > 65535 or -(-height // 4) > 65535:
        raise ValueError(f"the kernel takes 1 <= B <= 65535, 1 <= H <= 262140 and W >= 1, "
                         f"got {tuple(xq.shape)}")
    if xq.device.type != "cuda":
        raise ValueError(f"the int8 step runs on cpu or cuda tensors, not {xq.device}")
    # hq and the packed weights are copied 16 bytes at a time, c read as pairs
    for name, align in (("hq", 16), ("w_packed", 16), ("c", 8)):
        if name in named and named[name].data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def _library() -> ctypes.CDLL:
    """K5's library, entry points typed: the step's 8 pointers (xq, hq, c,
    packed weights, dequant, b, h'q, c') and the sums' 4 (xq, hq, packed
    weights, sums), then (B, H, W, Cx, Ch, device), then the stream."""
    _build.load_typed(_SOURCE, [_SUMS_ENTRY],
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return _build.load_typed(
        _SOURCE, _ENTRY.values(),
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def build() -> None:
    """Build (or load) the kernel's library now rather than at first launch."""
    _build.load(_SOURCE)


def _padded(xq, hq, c, w3q, dequant, b, w_packed):
    """The operands at :func:`kernel_widths`, packed weights included: as
    given where the widths are built, else zero-padded (and packed) here."""
    cx, ch = xq.shape[-1], hq.shape[-1]
    cx_to, ch_to = kernel_widths(cx, ch)
    if (cx_to, ch_to) != (cx, ch):
        xq, hq = pad_channels(xq, cx_to), pad_channels(hq, ch_to)
        c = None if c is None else pad_channels(c, ch_to)
        w3q, dequant, b = pad_quantized(w3q, dequant, b, cx, cx_to, ch_to)
        w_packed = None
    if w_packed is None:
        w_packed = pack_weights(w3q, cx_to)
    return xq, hq, c, dequant, b, w_packed


def fused_convlstm_step_int8(xq, hq, c, w3q, dequant, b,
                             w_packed: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One int8 ConvLSTM step on unpadded NHWC int8 x and h.

    xq (B, H, W, Cx) and hq (B, H, W, Ch) int8; c (B, H, W, Ch) bf16 or f32;
    w3q, dequant, b from :func:`quantize_weights`. Returns (h'q int8, c').
    CPU tensors take :func:`fused_convlstm_step_int8_ref`; CUDA tensors of the
    widths in :func:`kernel_takes` launch K5 on the current stream (zero-padded
    to :func:`kernel_widths` where they are not those), counted in
    ``fused_convlstm_step_int8.launches``. ``w_packed`` is :func:`pack_weights`
    of ``w3q``, which a rollout makes once per cell; left out, or where the
    widths are padded here, the wrapper packs on every call.
    """
    if all(t.device.type == "cpu" for t in (xq, hq, c, w3q, dequant, b)):
        return fused_convlstm_step_int8_ref(xq, hq, c, w3q, dequant, b)
    _check(xq, hq, c, w3q, dequant, b, w_packed)
    ch = hq.shape[-1]
    xq, hq, c, dequant, b, w_packed = _padded(xq, hq, c, w3q, dequant, b, w_packed)
    lib = _library()
    h_out = torch.empty_like(hq)
    c_out = torch.empty_like(c)
    bsz, height, width, cx_to = xq.shape
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = getattr(lib, _ENTRY[c.dtype])(
        xq.data_ptr(), hq.data_ptr(), c.data_ptr(), w_packed.data_ptr(),
        dequant.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        bsz, height, width, cx_to, hq.shape[-1], xq.device.index, stream,
    )
    _build.raise_on(err, lib, "fused_convlstm_step_int8")
    fused_convlstm_step_int8.launches += 1
    if hq.shape[-1] != ch:
        return h_out[..., :ch].contiguous(), c_out[..., :ch].contiguous()
    return h_out, c_out


fused_convlstm_step_int8.launches = 0


def int8_gate_sums(xq, hq, w3q, w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The integer gate sums of one step, (B, H, W, 4Ch) int32: for CUDA
    tensors K5's own, from its contraction (the sums entry point, counted in
    ``int8_gate_sums.launches``), padded as the step pads; for CPU tensors
    :func:`int8_accumulate`. The two are equal bit for bit."""
    if all(t.device.type == "cpu" for t in (xq, hq, w3q)):
        return int8_accumulate(xq, hq, w3q)
    ch = hq.shape[-1]
    ch4 = torch.zeros(1, 4 * ch, device=xq.device)  # dequant and b: checked, padded, not read
    _check(xq, hq, None, w3q, ch4, ch4, w_packed)
    xq, hq, _, _, _, w_packed = _padded(xq, hq, None, w3q, ch4, ch4, w_packed)
    lib = _library()
    bsz, height, width, cx_to = xq.shape
    sums = torch.empty(bsz, height, width, 4 * hq.shape[-1], dtype=torch.int32, device=xq.device)
    err = lib.satflow_fused_convlstm_int8_sums(
        xq.data_ptr(), hq.data_ptr(), w_packed.data_ptr(), sums.data_ptr(), bsz, height, width,
        cx_to, hq.shape[-1], xq.device.index, torch.cuda.current_stream(xq.device).cuda_stream)
    _build.raise_on(err, lib, "int8_gate_sums")
    int8_gate_sums.launches += 1
    return slice_gate_columns(sums, ch).contiguous()


int8_gate_sums.launches = 0


# ---------------------------------------------------------------------------
# int8 rollout over a fused ConvLSTMCore
# ---------------------------------------------------------------------------


class Int8Cell(NamedTuple):
    """One cell's quantized weights: :func:`quantize_weights`' three tensors
    and :func:`pack_weights` of the first."""

    w3q: torch.Tensor
    dequant: torch.Tensor
    bias: torch.Tensor
    w_packed: torch.Tensor


def quantize_convlstm_params(core: torch.nn.Module, pad: Optional[bool] = None) -> Dict:
    """Quantize a fused-cell ``ConvLSTMCore`` for :func:`int8_rollout`.

    Reads the core's four fused cells (``encoder.encoder_{1,2}``,
    ``decoder.decoder_{1,2}``) and its head conv, as the JAX function reads
    the flax tree that ``params_from_flax`` fills them from; tensors stay on
    the core's device. With ``pad`` (by default: when the core is on a CUDA
    device, where the rollout launches K5) each cell's quantized weights are
    zero-padded once, here, to the widths K5 is built for
    (:func:`kernel_widths`, :func:`pad_quantized`): the rollout's carries then
    run at those widths and no call pads. Raises ``ValueError`` for a module
    without fused cells, and with ``pad`` for a hidden width above 128.
    """
    if pad is None:
        pad = next(core.parameters()).device.type == "cuda"

    def q(cell, x_is_hidden: bool) -> Int8Cell:
        wx, wh, bias = (getattr(cell, name, None)
                        for name in ("x_gates_kernel", "h_gates_kernel", "bias"))
        if wx is None or wh is None or bias is None:
            raise ValueError(
                "the int8 rollout reads fused-cell params (x_gates_kernel/"
                "h_gates_kernel/bias); build the model with cell_impl='fused'"
            )
        w3q, dequant, b = quantize_weights(wx.detach(), wh.detach(), bias.detach())
        cx = cx_to = wx.shape[2]
        if pad:
            cx_to, ch_to = kernel_widths(cx, wh.shape[2])
            # a cell whose x is the carry before it reads that carry's padded width
            cx_to = ch_to if x_is_hidden else cx_to
            w3q, dequant, b = pad_quantized(w3q, dequant, b, cx, cx_to, ch_to)
        return Int8Cell(w3q, dequant, b, pack_weights(w3q, cx_to))

    try:
        encoder, decoder = core.encoder, core.decoder
        cells = {name: q(group[name], name != "encoder_1")
                 for group, names in ((encoder, ("encoder_1", "encoder_2")),
                                      (decoder, ("decoder_1", "decoder_2")))
                 for name in names}
        head = decoder["head"]
    except (AttributeError, KeyError) as e:
        raise ValueError("the module is not a fused-cell ConvLSTMCore") from e
    cells["head"] = {
        "kernel": head.weight.detach().to(torch.bfloat16),  # OIHW
        "bias": head.bias.detach().to(torch.bfloat16),
    }
    return cells


def int8_rollout(qparams: Dict, x: torch.Tensor, forecast_steps: int,
                 step=fused_convlstm_step_int8) -> torch.Tensor:
    """(B, T, H, W, C) in [0, 1] -> (B, steps, H, W, out) bf16, the int8 path.

    Matches ``ConvLSTMCore``'s rollout (encoder -> autoregressive decoder ->
    per-step 3×3 head + sigmoid) with int8 cells: the inputs are quantized
    once, the h carries stay int8 and the c carries bf16 throughout, and the
    head runs in bf16 on the dequantized h4. ``step`` swaps the step's
    implementation for every cell (the chip smoke passes
    :func:`fused_convlstm_step_int8_ref`). Weights padded by
    :func:`quantize_convlstm_params` run the carries at the padded widths; the
    inputs' channels are padded to match and the head reads h4's real ones.
    """
    bsz, _, height, width, _ = x.shape
    ch = qparams["encoder_1"].w3q.shape[-1] // 4               # the carries' width
    cx = qparams["encoder_1"].w3q.shape[1] // 3 - ch           # the first cell's input width
    hidden = qparams["head"]["kernel"].shape[1]                # the model's hidden width
    xq = pad_channels(quantize_activations(x), cx).transpose(0, 1).contiguous()  # (T, B, H, W, C)
    zq = torch.zeros(bsz, height, width, ch, dtype=torch.int8, device=x.device)
    zc = torch.zeros(bsz, height, width, ch, dtype=torch.bfloat16, device=x.device)

    def cell(name, inp, hq, c):
        q = qparams[name]
        return step(inp, hq, c, q.w3q, q.dequant, q.bias, q.w_packed)

    (h1, c1), (h2, c2) = (zq, zc), (zq, zc)
    for x_t in xq:
        h1, c1 = cell("encoder_1", x_t, h1, c1)
        h2, c2 = cell("encoder_2", h1, h2, c2)

    head_k, head_b = qparams["head"]["kernel"], qparams["head"]["bias"]
    (h3, c3), (h4, c4), v = (zq, zc), (zq, zc), h2
    outs = []
    for _ in range(forecast_steps):
        h3, c3 = cell("decoder_1", v, h3, c3)
        h4, c4 = cell("decoder_2", h3, h4, c4)
        v = h4
        h4f = dequantize_activations(h4[..., :hidden]).permute(0, 3, 1, 2)
        # the bias is added to the conv's bf16 result, as the JAX rollout does
        outs.append(F.conv2d(h4f, head_k, padding=1).permute(0, 2, 3, 1) + head_b)
    return torch.sigmoid(torch.stack(outs, dim=1))
