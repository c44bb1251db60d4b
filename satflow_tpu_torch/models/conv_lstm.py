"""Encoder-decoder ConvLSTM nowcaster, counterpart of ``satflow_tpu/models/conv_lstm.py``.

A 2-cell ConvLSTM encoder consumes the history frames; the final hidden state
of its second cell seeds a 2-cell decoder that rolls forward
autoregressively (decoder cell 1 takes the previous step's output state h4),
and a 3×3 conv head + sigmoid maps each h4 to an output frame.

Only ``cell_impl="fused"`` with ``conv_type="standard"`` is ported: every
cell step is one call of the hand-written CUDA kernel on the card
(``ops/fused_convlstm_step.py``). Layout is NHWC (B, T, H, W, C) at the public
functions, as in the JAX package. The TPU's (W+2)-padded carry is dropped;
``remat``, ``remat_chunk``, ``unroll`` and ``head_in_scan`` only shape JAX's
backward, scan and parameter nesting, so this forward-only port accepts them
as hyperparameters and computes the same function for every value (the
weight bridge normalises the nesting).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.base import BaseModel
from satflow_tpu_torch.nn.recurrent import FusedConvLSTMCell, lecun_normal_
from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step


class ConvLSTMCore(nn.Module):
    """Pure forward: (B, T, H, W, C_in) -> (B, forecast_steps, H, W, C_out).

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

    def _head(self, h4: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
        head = self.decoder["head"]
        y = F.conv2d(h4.permute(0, 3, 1, 2), head.weight.to(cdtype),
                     head.bias.to(cdtype), padding=1)
        return y.permute(0, 2, 3, 1)

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
        s1 = s2 = zero_state  # read-only: every step writes fresh outputs
        for x_t in frames_in:
            s1, h1 = self.encoder["encoder_1"](s1, x_t, step)
            s2, _ = self.encoder["encoder_2"](s2, h1, step)
        v = s2[0]  # the encoder vector seeds decoder cell 1; states start at zero
        s3 = s4 = zero_state
        frames_out = []
        for _ in range(steps):
            s3, h3 = self.decoder["decoder_1"](s3, v, step)
            s4, v = self.decoder["decoder_2"](s4, h3, step)
            frames_out.append(self._head(v, cdtype))
        return torch.sigmoid(torch.stack(frames_out, dim=1))


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
            dtype=self.dtype,
            generator=self._generator,
        )

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
