"""MetNet-style axial-attention forecaster, counterpart of ``satflow_tpu/models/metnet.py``.

Architecture (Sønderby et al. 2020), as the JAX model builds it:

1. spatial preprocessor: center-crop x1/2, then space-to-depth x2 per frame;
2. lead-time conditioning: one-hot horizon channels, all lead times folded
   into the batch (F·B rows), so each stage below runs once at F·B;
3. image encoder (``_Downsampler``): conv 160, pool, BatchNorm, conv 256 x3,
   BatchNorm, pool: H -> H/4;
4. temporal encoder: a ConvLSTM scan over the history whose gate tail is
   kernel K3 on the card (``ops/fused_lstm.py``); the last hidden state goes on;
5. spatial aggregator: axial self-attention blocks over (H, W), whose
   attention is kernel K4 on the card (``ops/axial_attention.py``);
6. a 1x1 conv head, in f32 (it has no dtype in the JAX model).

Layout is NHWC / NTHWC, as in the JAX package. Input (B, T, H, W, C) gives
(B, F, H/16, W/16, out_channels). The downsampler's first conv and the
attention's positional embeddings take their widths from the first input (or
from a state_dict), as flax infers them: the datamodule's batch decides C.
The convs, BatchNorm, LayerNorm, Dense layers, pools and the head are
library calls, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.base import BaseModel
from satflow_tpu_torch.nn.attention import AxialAttentionBlock
from satflow_tpu_torch.nn.conv import Conv, DtypedModule
from satflow_tpu_torch.nn.losses import get_loss
from satflow_tpu_torch.nn.misc import (
    BatchNorm,
    compute_dtype,
    crop_center,
    max_pool,
    space_to_depth,
)
from satflow_tpu_torch.nn.recurrent import ConvLSTMCell
from satflow_tpu_torch.ops.axial_attention import axial_attention
from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates


class _Downsampler(DtypedModule):
    """MetNet image encoder: conv 160 -> pool -> BN -> conv 256 x3 (BN after
    the second) -> pool: H -> H/4. The first conv's input width comes from
    its first input or from a state_dict."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = Conv(None, 160, 3, generator=generator)
        self.bn0 = BatchNorm(160)
        self.c1 = Conv(160, 256, 3, generator=generator)
        self.c2 = Conv(256, 256, 3, generator=generator)
        self.bn1 = BatchNorm(256)
        self.c3 = Conv(256, 256, 3, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdtype = compute_dtype(self.dtype, x)
        x = max_pool(self.c0(x), 2)
        x = F.relu(self.bn0(x, cdtype))
        x = F.relu(self.c1(x))
        x = F.relu(self.c2(x))
        x = self.c3(self.bn1(x, cdtype))
        return F.relu(max_pool(x, 2))


class MetNetCore(nn.Module):
    """(B, T, H, W, C) -> (B, forecast_steps, H/16, W/16, out_channels).

    Parameters sit where the flax tree has them: ``image_encoder.{c0..c3,
    bn0, bn1}``, ``temporal_encoder.cell.gates``, ``axial{i}.*`` and
    ``head``; the BatchNorm running statistics (flax's ``batch_stats``) are
    the buffers ``image_encoder.bn{0,1}.{mean,var}``. Temporal dropout draws
    its mask from ``generator`` (the default generator when None).
    """

    def __init__(
        self,
        forecast_steps: int = 48,
        out_channels: int = 12,
        hidden_dim: int = 64,
        kernel_size: int = 3,
        num_att_layers: int = 1,
        att_heads: int = 8,
        temporal_dropout: float = 0.2,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.forecast_steps = forecast_steps
        self.hidden_dim = hidden_dim
        self.num_att_layers = num_att_layers
        self.temporal_dropout = temporal_dropout
        self.generator = generator
        self.dtype = dtype
        self.image_encoder = _Downsampler(dtype, generator)
        self.temporal_encoder = nn.ModuleDict({"cell": ConvLSTMCell(
            256, hidden_dim, kernel_size=kernel_size, dtype=dtype, generator=generator)})
        for i in range(num_att_layers):
            self.add_module(f"axial{i}", AxialAttentionBlock(
                hidden_dim, heads=att_heads, axes=(-3, -2), dtype=dtype, generator=generator))
        self.head = Conv(hidden_dim, out_channels, 1, generator=generator)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in ``dtype`` from now on (None: flax's promotion, f32 for
        f32 or bf16 input), keeping the f32 weights as they are."""
        self.dtype = dtype
        self.image_encoder.dtype = dtype
        self.temporal_encoder["cell"].dtype = dtype
        for i in range(self.num_att_layers):
            getattr(self, f"axial{i}").set_compute_dtype(dtype)

    def _temporal_dropout(self, x: torch.Tensor) -> torch.Tensor:
        """In training, each (B, T) frame of ``x`` zeroed with probability
        ``temporal_dropout`` and the kept ones scaled by 1 / (1 - p); the
        mask comes from ``generator`` (on the host). ``x`` as it is otherwise."""
        p = self.temporal_dropout
        if not (self.training and p > 0):
            return x
        b, t = x.shape[:2]
        keep = torch.bernoulli(torch.full((b, t) + (1,) * (x.dim() - 2), 1.0 - p),
                               generator=self.generator)
        return x * keep.to(x.device, x.dtype) / (1.0 - p)

    def forward(self, x: torch.Tensor, gate_tail: Callable = fused_lstm_gates,
                attention: Callable = axial_attention) -> torch.Tensor:
        """``gate_tail`` and ``attention`` swap the implementations of K3's
        and K4's ops (tests and the chip smoke pass the plain versions)."""
        b, t, h, w, _ = x.shape
        f = self.forecast_steps

        # 1. spatial preprocessor
        x = space_to_depth(crop_center(x, h // 2, w // 2), 2)  # (B, T, h/4, w/4, 4C)
        hh, ww = x.shape[2], x.shape[3]
        x = self._temporal_dropout(x)

        # 2. lead-time conditioning, all lead times folded into the batch:
        # (F, B, T, hh, ww, 4C + F) -> (F·B·T, hh, ww, ·)
        one_hot = torch.eye(f, dtype=x.dtype, device=x.device)
        xe = x[None].expand(f, b, t, hh, ww, x.shape[-1])
        ohe = one_hot[:, None, None, None, None, :].expand(f, b, t, hh, ww, f)
        frames = torch.cat([xe, ohe], dim=-1).reshape(f * b * t, hh, ww, -1)

        # 3. image encoder over every frame at once
        enc = self.image_encoder(frames)
        eh, ew = enc.shape[1], enc.shape[2]
        enc = enc.reshape(f * b, t, eh, ew, enc.shape[-1])

        # 4. temporal encoder: the ConvLSTM over the history, last hidden state
        cell = self.temporal_encoder["cell"]
        carry = ConvLSTMCell.init_carry(f * b, eh, ew, self.hidden_dim, enc.dtype, enc.device)
        for i in range(t):
            carry, _ = cell(carry, enc[:, i], gate_tail)
        z = carry[0]

        # 5. axial attention over (H, W)
        for i in range(self.num_att_layers):
            z = getattr(self, f"axial{i}")(z, attention)

        # 6. head, in flax's promotion of z and the f32 kernel (no dtype)
        out = self.head(z)
        return out.reshape(f, b, eh, ew, -1).transpose(0, 1)


@register_model
class LitMetNet(BaseModel):
    """Registered task model, with the JAX model's hyperparameters.

    ``prepare_batch`` concatenates the satellite channels, the topography
    repeated over T and the NWP fields resized to the satellite grid; the
    target is center-cropped and average-pooled to the output geometry.
    Optimizer: Adam under :func:`~satflow_tpu_torch.train.schedules.warmup_cosine`.
    A ``loss`` name containing ``"ssim"`` builds the SSIM-family criterion
    channel-aware, nonnegative and with the [-1, 1] -> [0, 1] range
    conversion (``metnet_ssim.yaml``), and keeps the name.
    ``image_encoder``, ``num_layers`` and ``head`` are accepted and ignored,
    and ``sat_channels`` and ``input_size`` stored and not read, as by the
    JAX model (the input width and geometry come from the data).
    """

    def __init__(
        self,
        image_encoder: str = "downsampler",
        input_channels: int = 12,
        sat_channels: int = 12,
        input_size: int = 256,
        output_channels: int = 12,
        hidden_dim: int = 64,
        kernel_size: int = 3,
        num_layers: int = 1,
        num_att_layers: int = 1,
        head: str = "identity",
        forecast_steps: int = 48,
        temporal_dropout: float = 0.2,
        lr: float = 1e-3,
        pretrained: bool = False,
        visualize: bool = False,
        loss: str = "mse",
        warmup_steps: int = 1000,
        total_steps: int = 100_000,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.sat_channels = sat_channels
        self.input_size = input_size
        self.hidden_dim = hidden_dim
        self.kernel_size = kernel_size
        self.num_att_layers = num_att_layers
        self.temporal_dropout = temporal_dropout
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.dtype = dtype
        self._generator = generator
        loss_name = loss
        # SSIM-family criteria are built channel-aware, nonnegative and with
        # the range conversion, as the JAX model builds them
        if isinstance(loss, str) and "ssim" in loss:
            loss = get_loss(loss, convert_range_flag=True, nonnegative=True,
                            channel=output_channels)
        super().__init__(
            forecast_steps=forecast_steps,
            lr=lr,
            loss=loss,
            visualize=visualize,
            input_channels=input_channels,
            output_channels=output_channels,
            pretrained=pretrained,
        )
        if isinstance(loss_name, str):
            self.loss_name = loss_name  # the registry name, for the hparams

    def build_module(self) -> nn.Module:
        return MetNetCore(
            forecast_steps=self.forecast_steps,
            out_channels=self.output_channels,
            hidden_dim=self.hidden_dim,
            kernel_size=self.kernel_size,
            num_att_layers=self.num_att_layers,
            temporal_dropout=self.temporal_dropout,
            dtype=self.dtype,
            generator=self._generator,
        )

    def prepare_batch(self, batch):
        from satflow_tpu_torch.data import consts

        x, y = batch
        if isinstance(x, dict):
            sat = torch.as_tensor(x[consts.SATELLITE_DATA])
            parts = [sat]
            topo = x.get(consts.TOPOGRAPHIC_DATA)
            if topo is not None:
                topo = torch.as_tensor(topo, device=sat.device)
                if topo.dim() == 3:
                    topo = topo[..., None]
                parts.append(topo[:, None].expand(sat.shape[0], sat.shape[1], *topo.shape[1:]))
            nwp = x.get(consts.NWP_DATA)
            if nwp is not None:
                # (B, C_nwp, T, h', w') -> nearest with half-pixel centres, as
                # jax.image.resize(..., "nearest"), over T, H and W
                nwp = F.interpolate(torch.as_tensor(nwp, device=sat.device),
                                    size=tuple(sat.shape[1:4]), mode="nearest-exact")
                parts.append(nwp.permute(0, 2, 3, 4, 1))
            x = torch.cat(parts, dim=-1)
        if isinstance(y, dict):
            y = torch.as_tensor(y[consts.SATELLITE_DATA])
        # the model predicts the center 1/4 crop at 1/4 resolution
        y = crop_center(y, x.shape[2] // 4, x.shape[3] // 4)
        y = _avg_pool_frames(y, factor=4)
        return x, y[..., : self.output_channels]

    def state_dict_from_flax(self, variables):
        from satflow_tpu_torch.interop.jax_weights import metnet_state_dict_from_flax

        return metnet_state_dict_from_flax(variables)

    @property
    def lr_schedule(self):
        # imported here: the train package pulls in the data module, which
        # serving does not need
        from satflow_tpu_torch.train.schedules import warmup_cosine

        return warmup_cosine(self.lr, self.warmup_steps, self.total_steps)

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adam (optax's defaults) with its learning rate set from
        :attr:`lr_schedule` before every update, as ``optax.adam(schedule)``."""
        from satflow_tpu_torch.train.schedules import scheduled

        return scheduled(super().make_optimizer(), self.lr_schedule)


def _avg_pool_frames(y: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool the spatial dims of a (B, T, H, W, C) target by ``factor``."""
    b, t, h, w, c = y.shape
    y = y.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    y = F.avg_pool2d(y, factor, factor).permute(0, 2, 3, 1)
    return y.reshape(b, t, h // factor, w // factor, c)
