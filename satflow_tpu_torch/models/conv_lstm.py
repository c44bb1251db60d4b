"""Encoder-decoder ConvLSTM nowcaster, counterpart of ``satflow_tpu/models/conv_lstm.py``.

A 2-cell ConvLSTM encoder consumes the history frames; the final hidden state
of its second cell seeds a 2-cell decoder that rolls forward
autoregressively (decoder cell 1 takes the previous step's output state h4),
and a 3×3 conv head + sigmoid maps each h4 to an output frame.

The JAX model's five cell formulations (identical math, different op
schedules) and four conv types are ported:

- ``cell_impl="concat"``: one conv over ``[x | h]`` per cell
  (:class:`~satflow_tpu_torch.nn.recurrent.ConvLSTMCell`), then the LSTM gate
  tail through the hand-written kernel K3 (``ops/fused_lstm.py``).
- ``cell_impl="split"``: ``conv_x(x) + conv_h(h)`` per cell
  (:class:`~satflow_tpu_torch.nn.recurrent.SplitConvLSTMCell`), the encoder's
  input-side convs hoisted out of the loop as one conv over the folded B·T
  batch (``encoder_input_gates``, outside the encoder's remat), then K3.
- ``cell_impl="hybrid"``: the split encoder and the concat decoder.
- ``cell_impl="fused"``: every cell step's forward is one call of the
  hand-written CUDA kernel K1 on the card and, under autograd, its backward
  one call of K2 (``ops/fused_convlstm_step.py``).
- ``cell_impl="cmajor"``: the fused encoder, then a decoder whose carries stay
  channel-major (B, C, H·W) across the whole rollout
  (``ops/cmajor_convlstm.py``): one layout change in, two K6a cell steps and
  one K6b head conv per step, one layout change back. As in the JAX model it
  needs ``head_in_scan`` and ``cmajor_supported(H, W, hidden)``, is skipped
  under the chunked remat layout, and runs the ``"fused"`` decoder elsewhere.
  The parameters are the fused ones, so the same weights serve both. It is
  the inference formulation: its backward goes through the plain NHWC step.

``conv_type`` is ``"standard"``, ``"coord"``, ``"antialiased"`` or ``"3d"``
(``nn/conv.py``); any but ``"standard"`` runs the concat cells with that conv
whatever ``cell_impl`` says, as in the JAX model.

Layout is NHWC (B, T, H, W, C) at the public functions, as in the JAX
package. The TPU's (W+2)-padded carry is dropped.

``remat`` and ``remat_chunk`` are the JAX model's rematerialisation
schedule, as ``torch.utils.checkpoint`` regions, active only while grad is
enabled: per-step remat checkpoints each encoder step and each decoder step
(two cells, plus the head); ``remat_chunk`` > 1 (sqrt remat) checkpoints the
whole encoder once and the decoder in chunks of
``_largest_divisor_at_most(steps, remat_chunk)`` steps. Remat changes memory
and recompute, never values. ``unroll`` and ``head_in_scan`` only shape
JAX's scan and parameter nesting, so the port accepts them as
hyperparameters and computes the same function for every value (the
weight bridge normalises the nesting), except that ``head_in_scan=False``
keeps ``"cmajor"`` on the fused decoder.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.base import BaseModel
from satflow_tpu_torch.nn.recurrent import (
    ConvLSTMCell,
    FusedConvLSTMCell,
    InputGateConv,
    SplitConvLSTMCell,
    lecun_normal_,
)
from satflow_tpu_torch.ops.cmajor_convlstm import (
    cmajor_conv3x3,
    cmajor_convlstm_step,
    cmajor_supported,
    from_cmajor_seq,
    to_cmajor,
)
from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates

CELL_IMPLS = ("concat", "split", "hybrid", "fused", "cmajor")
CONV_TYPES = ("standard", "coord", "antialiased", "3d")


def _largest_divisor_at_most(n: int, k: int) -> int:
    k = max(1, min(k, n))
    while n % k:
        k -= 1
    return k


def _remat(fn, *args):
    # the core draws no random numbers, so no RNG state needs replaying
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class ConvLSTMCore(nn.Module):
    """(B, T, H, W, C_in) -> (B, forecast_steps, H, W, C_out).

    Parameters sit where the flax tree has them: ``encoder.encoder_{1,2}``,
    ``decoder.decoder_{1,2}`` (the cells of the configured formulation),
    ``decoder.head`` (an ``nn.Conv2d``) and, with a split encoder,
    ``encoder_input_gates``.
    """

    def __init__(
        self,
        hidden_dim: int = 64,
        in_channels: int = 12,
        out_channels: int = 1,
        forecast_steps: int = 48,
        conv_type: str = "standard",
        cell_impl: str = "fused",
        remat: bool = False,
        remat_chunk: int = 0,
        head_in_scan: bool = True,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cell_impl not in CELL_IMPLS:
            raise ValueError(f"Unknown cell_impl {cell_impl!r}: expected one of {CELL_IMPLS}")
        if conv_type not in CONV_TYPES:
            raise ValueError(f"Unknown conv_type {conv_type!r}: expected one of {CONV_TYPES}")
        self.hidden_dim = hidden_dim
        self.forecast_steps = forecast_steps
        self.cell_impl = cell_impl
        self.conv_type = conv_type
        self.head_in_scan = head_in_scan
        self.remat = remat
        self.remat_chunk = remat_chunk
        self.dtype = dtype
        std = conv_type == "standard"
        fused = cell_impl in ("fused", "cmajor") and std
        split_enc = cell_impl in ("split", "hybrid") and std
        split_dec = cell_impl == "split" and std
        kw = dict(dtype=dtype, generator=generator)

        def concat(cin):
            return ConvLSTMCell(cin, hidden_dim, conv_type=conv_type, **kw)

        if fused:
            enc = [FusedConvLSTMCell(in_channels, hidden_dim, **kw),
                   FusedConvLSTMCell(hidden_dim, hidden_dim, **kw)]
        elif split_enc:
            enc = [SplitConvLSTMCell(in_channels, hidden_dim, x_precomputed=True, **kw),
                   SplitConvLSTMCell(hidden_dim, hidden_dim, **kw)]
        else:
            enc = [concat(in_channels), concat(hidden_dim)]
        self.encoder = nn.ModuleDict({"encoder_1": enc[0], "encoder_2": enc[1]})
        if split_enc:
            self.encoder_input_gates = InputGateConv(in_channels, hidden_dim, **kw)
        head = nn.Conv2d(hidden_dim, out_channels, 3, padding=1)
        lecun_normal_(head.weight, 9 * hidden_dim, generator)
        nn.init.zeros_(head.bias)
        if fused:
            dec = [FusedConvLSTMCell(hidden_dim, hidden_dim, **kw) for _ in range(2)]
        elif split_dec:
            dec = [SplitConvLSTMCell(hidden_dim, hidden_dim, **kw) for _ in range(2)]
        else:
            dec = [concat(hidden_dim), concat(hidden_dim)]
        self.decoder = nn.ModuleDict({"decoder_1": dec[0], "decoder_2": dec[1], "head": head})

    def _cells(self):
        yield from (self.encoder["encoder_1"], self.encoder["encoder_2"],
                    self.decoder["decoder_1"], self.decoder["decoder_2"])
        if hasattr(self, "encoder_input_gates"):
            yield self.encoder_input_gates

    @property
    def is_fused(self) -> bool:
        """Whether the cells are the fused ones (``fused`` or ``cmajor`` with
        the standard conv): what int8 serving and the channel-major decoder
        need."""
        return isinstance(self.encoder["encoder_1"], FusedConvLSTMCell)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in ``dtype`` from now on (None: the input's), keeping the
        f32 weights as they are."""
        self.dtype = dtype
        for cell in self._cells():
            cell.dtype = dtype

    def _head(self, h4: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
        head = self.decoder["head"]
        y = F.conv2d(h4.permute(0, 3, 1, 2), head.weight.to(cdtype),
                     head.bias.to(cdtype), padding=1)
        return y.permute(0, 2, 3, 1)

    def _encode(self, s1, s2, frames, impl):
        """The encoder over ``frames`` (T, B, H, W, ·): the input frames, or
        with a split encoder their precomputed input gates. ``impl`` is what
        the cells of this core take: the fused step, or the gate tail."""
        e1, e2 = self.encoder["encoder_1"], self.encoder["encoder_2"]
        for x_t in frames:
            s1, h1 = e1(s1, x_t, impl)
            s2, _ = e2(s2, h1, impl)
        return s1, s2

    def _decode(self, s3, s4, v, n: int, cdtype, impl):
        d1, d2 = self.decoder["decoder_1"], self.decoder["decoder_2"]
        frames: List[torch.Tensor] = []
        for _ in range(n):
            s3, h3 = d1(s3, v, impl)
            s4, v = d2(s4, h3, impl)
            frames.append(self._head(v, cdtype))
        return s3, s4, v, torch.stack(frames, dim=1)

    def _decode_cmajor(self, s3, s4, v, n: int, cdtype, height: int, width: int):
        """``n`` decoder steps on channel-major carries; the frames come back
        stacked as (B, n, C_out, H·W)."""
        cells = [tuple(p.to(cdtype) for p in (cell.x_gates_kernel, cell.h_gates_kernel,
                                              cell.bias))
                 for cell in (self.decoder["decoder_1"], self.decoder["decoder_2"])]
        head = self.decoder["head"]
        head_w = head.weight.permute(2, 3, 1, 0).to(cdtype).contiguous()  # OIHW -> HWIO
        head_b = head.bias.to(cdtype)
        frames: List[torch.Tensor] = []
        for _ in range(n):
            s3 = cmajor_convlstm_step(v, *s3, *cells[0], height, width)
            s4 = cmajor_convlstm_step(s3[0], *s4, *cells[1], height, width)
            v = s4[0]
            frames.append(cmajor_conv3x3(v, head_w, head_b, height, width))
        return s3, s4, v, torch.stack(frames, dim=1)

    def runs_cmajor(self, height: int, width: int) -> bool:
        """Whether a rollout at this geometry takes the channel-major decoder:
        ``cell_impl="cmajor"`` outside the chunked remat layout (fixed by the
        configuration, whatever the grad mode, as in the JAX model), with the head
        in the scan and a geometry :func:`cmajor_supported` admits. Anything
        else runs the fused decoder, as the JAX model does."""
        chunked = (self.remat and self.remat_chunk > 1
                   and _largest_divisor_at_most(self.forecast_steps, self.remat_chunk) > 1)
        return (self.cell_impl == "cmajor" and self.is_fused and not chunked
                and self.head_in_scan and cmajor_supported(height, width, self.hidden_dim))

    def forward(self, x: torch.Tensor, forecast_steps: Optional[int] = None,
                step: Callable = fused_convlstm_step,
                gate_tail: Callable = fused_lstm_gates) -> torch.Tensor:
        """``step`` swaps the fused step's implementation for every fused cell
        and ``gate_tail`` the LSTM gate tail's for every concat or split cell
        (tests and the chip smoke pass the plain versions to compare against)."""
        steps = forecast_steps if forecast_steps is not None else self.forecast_steps
        b, _, height, width, _ = x.shape
        cdtype = self.dtype or x.dtype
        x = x.to(cdtype)
        if hasattr(self, "encoder_input_gates"):
            # every encoder step's input-side gate conv as one folded conv,
            # outside the encoder's remat; (T, B, H, W, 4C) as a view
            frames_in = self.encoder_input_gates(x).transpose(0, 1)
        else:
            # (T, B, H, W, C): each step's frame is one contiguous tensor
            frames_in = x.transpose(0, 1).contiguous()
        impl = step if self.is_fused else gate_tail
        zero_state = FusedConvLSTMCell.init_carry(b, height, width, self.hidden_dim,
                                                  cdtype, x.device)
        remat = self.remat and torch.is_grad_enabled()
        # the JAX model fixes the chunked layout from the configured step
        # count and re-divides the step count of each call
        chunked = (remat and self.remat_chunk > 1
                   and _largest_divisor_at_most(self.forecast_steps, self.remat_chunk) > 1)
        chunk = _largest_divisor_at_most(steps, self.remat_chunk) if chunked else 1

        # states are read-only: every step writes fresh outputs
        if chunked:  # whole-encoder remat: its carries die before the decoder's backward
            s1, s2 = _remat(self._encode, zero_state, zero_state, frames_in, impl)
        elif remat:
            s1 = s2 = zero_state
            for x_t in frames_in:
                s1, s2 = _remat(self._encode, s1, s2, x_t[None], impl)
        else:
            s1, s2 = self._encode(zero_state, zero_state, frames_in, impl)

        v = s2[0]  # the encoder vector seeds decoder cell 1; states start at zero
        if self.runs_cmajor(height, width):
            # one layout change per rollout; the zero carries are born in-layout
            v = to_cmajor(v)
            zero = torch.zeros_like(v)
            s3 = s4 = (zero, zero)
            if not remat:
                *_, out = self._decode_cmajor(s3, s4, v, steps, cdtype, height, width)
            else:
                outs = []
                for _ in range(steps):
                    s3, s4, v, out = _remat(self._decode_cmajor, s3, s4, v, 1, cdtype,
                                            height, width)
                    outs.append(out)
                out = torch.cat(outs, dim=1)
            return torch.sigmoid(from_cmajor_seq(out, height, width))
        if not remat:
            *_, out = self._decode(zero_state, zero_state, v, steps, cdtype, impl)
            return torch.sigmoid(out)
        s3 = s4 = zero_state
        outs = []
        for _ in range(steps // chunk):
            s3, s4, v, out = _remat(self._decode, s3, s4, v, chunk, cdtype, impl)
            outs.append(out)
        return torch.sigmoid(torch.cat(outs, dim=1))


@register_model
class EncoderDecoderConvLSTM(BaseModel):
    """Registered task model, with the JAX model's hyperparameters."""

    def __init__(
        self,
        hidden_dim: int = 64,
        input_channels: int = 12,
        out_channels: int = 1,
        forecast_steps: int = 48,
        lr: float = 1e-3,
        visualize: bool = False,
        loss: str = "mse",
        pretrained: bool = False,
        conv_type: str = "standard",
        cell_impl: str = "fused",
        unroll: int = 1,
        remat: bool = True,
        remat_chunk: int = 0,
        head_in_scan: bool = True,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.hidden_dim = hidden_dim
        self.conv_type = conv_type
        self.cell_impl = cell_impl
        self.unroll = unroll
        self.remat = remat
        self.remat_chunk = remat_chunk
        self.head_in_scan = head_in_scan
        self.dtype = dtype
        self._generator = generator
        super().__init__(
            forecast_steps=forecast_steps,
            lr=lr,
            loss=loss,
            visualize=visualize,
            input_channels=input_channels,
            output_channels=out_channels,
            pretrained=pretrained,
        )

    def build_module(self) -> nn.Module:
        return ConvLSTMCore(
            hidden_dim=self.hidden_dim,
            in_channels=self.input_channels,
            out_channels=self.output_channels,
            forecast_steps=self.forecast_steps,
            conv_type=self.conv_type,
            cell_impl=self.cell_impl,
            remat=self.remat,
            remat_chunk=self.remat_chunk,
            head_in_scan=self.head_in_scan,
            dtype=self.dtype,
            generator=self._generator,
        )

    def state_dict_from_flax(self, variables):
        from satflow_tpu_torch.interop.jax_weights import params_from_flax

        return params_from_flax(variables)

    def prepare_batch(self, batch):
        x, y = super().prepare_batch(batch)
        # the model predicts out_channels: compare against the first ones
        if y.shape[-1] != self.output_channels:
            y = y[..., : self.output_channels]
        return x, y

    @classmethod
    def from_config(cls, config):
        """From the reference's config keys (``num_hidden``, ``in_channels``),
        as the JAX model reads them."""
        return cls(
            hidden_dim=config.get("num_hidden", 64),
            input_channels=config.get("in_channels", 12),
            out_channels=config.get("out_channels", 1),
            forecast_steps=config.get("forecast_steps", 1),
            lr=config.get("lr", 1e-3),
        )

    def enable_spatial(self, mesh, axis: str = "model") -> None:
        raise NotImplementedError(
            "spatial (H-sharded) rollout is not ported yet (ROADMAP queue 1 item 13)"
        )
