"""Encoder-decoder ConvLSTM nowcaster, counterpart of ``satflow_tpu/models/conv_lstm.py``.

A 2-cell ConvLSTM encoder consumes the history frames; the final hidden state
of its second cell seeds a 2-cell decoder that rolls forward
autoregressively (decoder cell 1 takes the previous step's output state h4),
and a 3×3 conv head + sigmoid maps each h4 to an output frame.

Only ``cell_impl="fused"`` with ``conv_type="standard"`` is ported: every
cell step's forward is one call of the hand-written CUDA kernel K1 on the
card and, under autograd, its backward one call of K2
(``ops/fused_convlstm_step.py``). Layout is NHWC (B, T, H, W, C) at the
public functions, as in the JAX package. The TPU's (W+2)-padded carry is
dropped.

``remat`` and ``remat_chunk`` are the JAX model's rematerialisation
schedule, as ``torch.utils.checkpoint`` regions, active only while grad is
enabled: per-step remat checkpoints each encoder step and each decoder step
(two cells, plus the head); ``remat_chunk`` > 1 (sqrt remat) checkpoints the
whole encoder once and the decoder in chunks of
``_largest_divisor_at_most(steps, remat_chunk)`` steps. Remat changes memory
and recompute, never values. ``unroll`` and ``head_in_scan`` only shape
JAX's scan and parameter nesting, so the port accepts them as
hyperparameters and computes the same function for every value (the
weight bridge normalises the nesting).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.base import BaseModel
from satflow_tpu_torch.nn.recurrent import FusedConvLSTMCell, lecun_normal_
from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step


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
    ``decoder.decoder_{1,2}`` (fused cells) and ``decoder.head`` (an
    ``nn.Conv2d``).
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
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cell_impl != "fused":
            raise NotImplementedError(
                f"cell_impl={cell_impl!r} is not ported; only 'fused' is "
                "(concat/split/hybrid need K3, cmajor K6: ROADMAP queue 2)"
            )
        if conv_type != "standard":
            raise NotImplementedError(
                f"conv_type={conv_type!r} is not ported; only 'standard' is"
            )
        self.hidden_dim = hidden_dim
        self.forecast_steps = forecast_steps
        self.remat = remat
        self.remat_chunk = remat_chunk
        self.dtype = dtype

        def cell(cin):
            return FusedConvLSTMCell(cin, hidden_dim, dtype=dtype, generator=generator)

        self.encoder = nn.ModuleDict(
            {"encoder_1": cell(in_channels), "encoder_2": cell(hidden_dim)}
        )
        head = nn.Conv2d(hidden_dim, out_channels, 3, padding=1)
        lecun_normal_(head.weight, 9 * hidden_dim, generator)
        nn.init.zeros_(head.bias)
        self.decoder = nn.ModuleDict(
            {"decoder_1": cell(hidden_dim), "decoder_2": cell(hidden_dim), "head": head}
        )

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in ``dtype`` from now on (None: the input's), keeping the
        f32 weights as they are."""
        self.dtype = dtype
        for name in ("encoder_1", "encoder_2"):
            self.encoder[name].dtype = dtype
        for name in ("decoder_1", "decoder_2"):
            self.decoder[name].dtype = dtype

    def _head(self, h4: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
        head = self.decoder["head"]
        y = F.conv2d(h4.permute(0, 3, 1, 2), head.weight.to(cdtype),
                     head.bias.to(cdtype), padding=1)
        return y.permute(0, 2, 3, 1)

    def _encode(self, s1, s2, frames, step):
        for x_t in frames:
            s1, h1 = self.encoder["encoder_1"](s1, x_t, step)
            s2, _ = self.encoder["encoder_2"](s2, h1, step)
        return s1, s2

    def _decode(self, s3, s4, v, n: int, cdtype, step):
        frames: List[torch.Tensor] = []
        for _ in range(n):
            s3, h3 = self.decoder["decoder_1"](s3, v, step)
            s4, v = self.decoder["decoder_2"](s4, h3, step)
            frames.append(self._head(v, cdtype))
        return s3, s4, v, torch.stack(frames, dim=1)

    def forward(self, x: torch.Tensor, forecast_steps: Optional[int] = None,
                step: Callable = fused_convlstm_step) -> torch.Tensor:
        """``step`` swaps the fused step's implementation for every cell (tests
        and the chip smoke pass the plain version to compare against)."""
        steps = forecast_steps if forecast_steps is not None else self.forecast_steps
        b, _, height, width, _ = x.shape
        cdtype = self.dtype or x.dtype
        # (T, B, H, W, C): each step's frame is one contiguous tensor
        frames_in = x.to(cdtype).transpose(0, 1).contiguous()
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
            s1, s2 = _remat(self._encode, zero_state, zero_state, frames_in, step)
        elif remat:
            s1 = s2 = zero_state
            for x_t in frames_in:
                s1, s2 = _remat(self._encode, s1, s2, x_t[None], step)
        else:
            s1, s2 = self._encode(zero_state, zero_state, frames_in, step)

        v = s2[0]  # the encoder vector seeds decoder cell 1; states start at zero
        if not remat:
            *_, out = self._decode(zero_state, zero_state, v, steps, cdtype, step)
            return torch.sigmoid(out)
        s3 = s4 = zero_state
        outs = []
        for _ in range(steps // chunk):
            s3, s4, v, out = _remat(self._decode, s3, s4, v, chunk, cdtype, step)
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

    def enable_spatial(self, mesh, axis: str = "model") -> None:
        raise NotImplementedError(
            "spatial (H-sharded) rollout is not ported yet (ROADMAP queue 1 item 13)"
        )
