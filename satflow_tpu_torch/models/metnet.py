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
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import UninitializedParameter

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.base import BaseModel
from satflow_tpu_torch.nn.attention import AxialAttentionBlock
from satflow_tpu_torch.nn.misc import compute_dtype, conv2d_nhwc, crop_center, space_to_depth
from satflow_tpu_torch.nn.recurrent import ConvLSTMCell, lecun_normal_
from satflow_tpu_torch.ops.axial_attention import axial_attention
from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` on NHWC ``x`` in ``dtype`` (its f32 weights cast per call)."""
    return conv2d_nhwc(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype))


def _flax_conv(in_channels: int, out_channels: int, kernel_size: int,
               generator: Optional[torch.Generator]) -> nn.Conv2d:
    """An ``nn.Conv2d`` (SAME padding) with flax's init: lecun-normal, zero bias."""
    conv = nn.Conv2d(in_channels, out_channels, kernel_size, padding="same")
    lecun_normal_(conv.weight, in_channels * kernel_size ** 2, generator)
    nn.init.zeros_(conv.bias)
    return conv


class _LazyConv(LazyModuleMixin, nn.Conv2d):
    """An ``nn.Conv2d`` (SAME padding, flax's init) whose input width comes
    from its first NHWC input or from a state_dict."""

    cls_to_become = None  # stays this class once the weights exist

    def __init__(self, out_channels: int, kernel_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(0, out_channels, kernel_size, padding="same")
        self.weight = UninitializedParameter()
        self.bias = UninitializedParameter()
        self._generator = generator

    def reset_parameters(self) -> None:
        """Nothing to reset before the width is known (``nn.Conv2d.__init__``
        calls this); :meth:`initialize_parameters` initialises."""

    def initialize_parameters(self, x: torch.Tensor, *args, **kwargs) -> None:  # noqa: ARG002
        if self.has_uninitialized_params():
            self.in_channels = x.shape[-1]
            shape = (self.out_channels, self.in_channels, *self.kernel_size)
            weight = torch.empty(shape)  # drawn on the host: the generator may be a CPU one
            lecun_normal_(weight, weight[0].numel(), self._generator)
            with torch.no_grad():
                self.weight.materialize(shape)
                self.weight.copy_(weight)
                self.bias.materialize((self.out_channels,))
                self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _conv(self, x, dtype)


class _BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the channels of an NHWC tensor.

    Training: normalise with the batch's f32 mean and biased variance and
    move the running statistics by flax's rule, ``ra = momentum·ra + (1 -
    momentum)·batch`` with momentum 0.99; ``torch.nn.BatchNorm2d`` would keep
    the unbiased variance. The variance is taken as E[(x - E[x])²]: flax's
    E[x²] - E[x]² is the same value up to f32 rounding, but its gradient,
    the difference of two nearly equal terms, loses most of its digits in
    f32 where a channel's mean is large against its spread.
    Eval: normalise with the running statistics. The normalisation is f32,
    rounded to the compute dtype.
    """

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=dims)
            var = torch.square(xf - mean).mean(dim=dims)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return ((xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias).to(dtype)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, of an NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class _Downsampler(nn.Module):
    """MetNet image encoder: conv 160 -> pool -> BN -> conv 256 x3 (BN after
    the second) -> pool: H -> H/4."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.c0 = _LazyConv(160, 3, generator)
        self.bn0 = _BatchNorm(160)
        self.c1 = _flax_conv(160, 256, 3, generator)
        self.c2 = _flax_conv(256, 256, 3, generator)
        self.bn1 = _BatchNorm(256)
        self.c3 = _flax_conv(256, 256, 3, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdtype = compute_dtype(self.dtype, x)
        x = _max_pool(self.c0(x, cdtype))
        x = F.relu(self.bn0(x, cdtype))
        x = F.relu(_conv(self.c1, x, cdtype))
        x = F.relu(_conv(self.c2, x, cdtype))
        x = _conv(self.c3, self.bn1(x, cdtype), cdtype)
        return F.relu(_max_pool(x))


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
        self.head = _flax_conv(hidden_dim, out_channels, 1, generator)

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
        out = _conv(self.head, z, compute_dtype(None, z))
        return out.reshape(f, b, eh, ew, -1).transpose(0, 1)


@register_model
class LitMetNet(BaseModel):
    """Registered task model, with the JAX model's hyperparameters.

    ``prepare_batch`` concatenates the satellite channels, the topography
    repeated over T and the NWP fields resized to the satellite grid; the
    target is center-cropped and average-pooled to the output geometry.
    Optimizer: Adam under :func:`~satflow_tpu_torch.train.schedules.warmup_cosine`.
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
        super().__init__(
            forecast_steps=forecast_steps,
            lr=lr,
            loss=loss,
            visualize=visualize,
            input_channels=input_channels,
            output_channels=output_channels,
            pretrained=pretrained,
        )

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
