"""U-Net model family, counterpart of ``satflow_tpu/models/unet_family.py``:
UNet, R2U-Net (``RUnet``), Attention U-Net, Attention R2U-Net.

Task shape: the past frames are stacked into channels and every forecast
frame comes out as channels in one pass (no recurrence): x (B, T, H, W, C)
-> (B, H, W, T·C) -> (B, H, W, forecast_steps·cpt) -> (B, forecast_steps,
H, W, cpt). :class:`StackedImageModel` is the task wrapper the segmentation
models and PixelCNN share.

Each core's submodules carry the flax names (``down{i}``, ``up{i}``,
``upconv{i}``, ``rrcnn{i}``, ``up_rrcnn{i}``, ``att{i}``, ``head``), so
:func:`~satflow_tpu_torch.interop.jax_weights.zoo_state_dict_from_flax`
converts the JAX model's variables with one tree walk. The first conv takes
its input width (T·C) from the data, as flax infers it: the model is
materialized from the first batch (``BaseModel.materialize``) or takes the
width from a state_dict. The 1x1 ``head`` has no dtype in the JAX cores, so
it computes in flax's promotion (f32 on f32 weights) whatever the blocks'
compute dtype. No kernel: convs, pools and resizes are library calls, as the
JAX cores leave them to XLA.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.base import BaseModel
from satflow_tpu_torch.nn.conv import BlurPool, Conv
from satflow_tpu_torch.nn.misc import max_pool
from satflow_tpu_torch.nn.unet_blocks import (
    AttentionBlock,
    ConvBlock,
    RRCNNBlock,
    UpConv,
    max_pool2,
)


def _level_features(features_start: int, depth: int) -> Tuple[int, ...]:
    return tuple(features_start * (2**i) for i in range(depth))


def _stack_time_into_channels(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, T·C)."""
    b, t, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


class _ZooCore(nn.Module):
    """A zoo core: ``set_compute_dtype`` re-types every block and conv below
    it but those listed in ``_fixed_dtype`` (the U-Net heads, which flax
    builds without a dtype)."""

    _fixed_dtype: Tuple[str, ...] = ()

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in ``dtype`` from now on (None: flax's promotion), the f32
        weights kept as they are."""
        fixed = {getattr(self, name) for name in self._fixed_dtype}
        self.dtype = dtype
        for m in self.modules():
            if m is not self and m not in fixed and hasattr(m, "dtype"):
                m.dtype = dtype


class _UNetBase(_ZooCore):
    """The encoder / decoder skeleton the four cores share: ``enc(i, cin,
    f)`` builds level i's block, ``dec(i, cin, f)`` the block after the i-th
    skip concat; ``attention`` puts an :class:`AttentionBlock` on each skip."""

    _fixed_dtype = ("head",)
    _enc_name = "down"
    _dec_name = "upconv"
    attention = False

    def __init__(self, out_channels: int, features_start: int = 64, depth: int = 5,
                 conv_type: str = "standard", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        self.conv_type = conv_type
        self.generator = generator
        feats = _level_features(features_start, depth)
        cin = None  # the first block's width comes from the data
        for i, f in enumerate(feats):
            self.add_module(f"{self._enc_name}{i}", self.enc(i, cin, f))
            cin = f
        for i, f in enumerate(reversed(feats[:-1])):
            self.add_module(f"up{i}", UpConv(cin, f, conv_type, generator=generator))
            if self.attention:
                self.add_module(f"att{i}", AttentionBlock(f, f, f // 2, conv_type,
                                                          generator=generator))
            self.add_module(f"{self._dec_name}{i}", self.dec(i, 2 * f, f))
            cin = f
        self.head = Conv(feats[0], out_channels, 1, generator=generator)
        self.set_compute_dtype(dtype)

    def enc(self, i: int, cin: Optional[int], f: int) -> nn.Module:
        return ConvBlock(cin, f, self.conv_type, generator=self.generator)

    def dec(self, i: int, cin: int, f: int) -> nn.Module:
        return ConvBlock(cin, f, self.conv_type, generator=self.generator)

    def downsample(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return max_pool2(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.depth):
            if i > 0:
                x = self.downsample(i, x)
            x = getattr(self, f"{self._enc_name}{i}")(x)
            if i < self.depth - 1:
                skips.append(x)
        for i in range(self.depth - 1):
            x = getattr(self, f"up{i}")(x)
            skip = skips.pop()
            if self.attention:
                skip = getattr(self, f"att{i}")(x, skip)
            x = torch.cat([skip, x], dim=-1)
            x = getattr(self, f"{self._dec_name}{i}")(x)
        return self.head(x)


class UNetCore(_UNetBase):
    """Plain U-Net: [conv -> BN -> ReLU] x 2 blocks, max-pool down, nearest
    upsample and conv up, skip concats."""


class R2UNetCore(_UNetBase):
    """R2U-Net: recurrent-residual blocks (``t`` weight-tied applications);
    with ``conv_type="antialiased"`` the downsampling is a stride-1 2x2
    max-pool (flax ``SAME``: the extra row and column last, -inf) and a
    stride-2 BlurPool."""

    _enc_name = "rrcnn"
    _dec_name = "up_rrcnn"
    _blur_pool = True

    def __init__(self, out_channels: int, features_start: int = 64, depth: int = 5,
                 t: int = 2, conv_type: str = "standard", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        self.t = t
        super().__init__(out_channels, features_start, depth, conv_type, dtype, generator)
        self.blur = self._blur_pool and conv_type == "antialiased"
        if self.blur:
            for i in range(1, depth):
                self.add_module(f"blur{i}", BlurPool(stride=2))

    def enc(self, i: int, cin: Optional[int], f: int) -> nn.Module:
        return RRCNNBlock(cin, f, self.t, self.conv_type, generator=self.generator)

    dec = enc

    def downsample(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.blur:
            return getattr(self, f"blur{i}")(max_pool(x, 2, 1, padding="SAME"))
        return max_pool2(x)


class AttUNetCore(_UNetBase):
    """Attention U-Net: the U-Net with an additive attention gate (F_int =
    f / 2) on each skip."""

    attention = True


class R2AttUNetCore(R2UNetCore):
    """Attention R2U-Net: R2U-Net's blocks with the attention gates; plain
    2x2 max-pool downsampling whatever the conv type."""

    attention = True
    _blur_pool = False


class StackedImageModel(BaseModel):
    """Base of the channels-stacked models: time folds into channels.

    x (B, T, H, W, C) -> (B, H, W, T·C); output (B, H, W, steps·cpt) ->
    (B, steps, H, W, cpt), cpt = ``channels_per_timestep``. ``prepare_batch``
    stacks x and keeps the first cpt channels of y; ``loss`` (BaseModel's)
    returns the loss and the per-lead-time ``frame_loss``. Weights come from
    ``generator`` (the default generator when None).
    """

    core_cls = UNetCore

    def __init__(
        self,
        input_channels: int = 12,
        forecast_steps: int = 48,
        channels_per_timestep: int = 1,
        features_start: int = 64,
        depth: int = 5,
        lr: float = 1e-3,
        loss: str = "mse",
        visualize: bool = False,
        conv_type: str = "standard",
        pretrained: bool = False,
        dtype: Any = None,
        generator: Optional[torch.Generator] = None,
        **core_kwargs,
    ):
        self.channels_per_timestep = channels_per_timestep
        self.features_start = features_start
        self.depth = depth
        self.conv_type = conv_type
        self.dtype = dtype
        self.core_kwargs = core_kwargs
        self._generator = generator
        super().__init__(
            forecast_steps=forecast_steps,
            lr=lr,
            loss=loss,
            visualize=visualize,
            input_channels=input_channels,
            output_channels=forecast_steps * channels_per_timestep,
            pretrained=pretrained,
        )

    def build_module(self) -> nn.Module:
        return self.core_cls(
            out_channels=self.output_channels,
            features_start=self.features_start,
            depth=self.depth,
            conv_type=self.conv_type,
            dtype=self.dtype,
            generator=self._generator,
            **self.core_kwargs,
        )

    def prepare_batch(self, batch):
        x, y = batch
        if isinstance(x, dict):
            x = x["sat_data"]
        if isinstance(y, dict):
            y = y["sat_data"]
        x = _stack_time_into_channels(torch.as_tensor(x))
        y = torch.as_tensor(y)[..., : self.channels_per_timestep]
        return x, y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5:
            x = _stack_time_into_channels(x)
        return self._unstack(self.module(x))

    def _unstack(self, out: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = out.shape
        out = out.reshape(b, h, w, self.forecast_steps, self.channels_per_timestep)
        return out.permute(0, 3, 1, 2, 4)  # (B, T_f, H, W, cpt)

    def state_dict_from_flax(self, variables):
        from satflow_tpu_torch.interop.jax_weights import zoo_state_dict_from_flax

        return zoo_state_dict_from_flax(variables)


@register_model
class Unet(StackedImageModel):
    """The U-Net task model."""

    core_cls = UNetCore


@register_model
class RUnet(StackedImageModel):
    """The R2U-Net task model."""

    core_cls = R2UNetCore


@register_model
class AttentionUnet(StackedImageModel):
    """The Attention U-Net task model."""

    core_cls = AttUNetCore


@register_model
class AttentionRUnet(StackedImageModel):
    """The Attention R2U-Net task model."""

    core_cls = R2AttUNetCore
