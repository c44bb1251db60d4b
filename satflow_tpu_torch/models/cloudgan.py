"""CloudGAN, counterpart of ``satflow_tpu/models/cloudgan.py``: past frames to
future frames as a conditional GAN.

- generator: an R2U-Net over the channels-stacked frames (``runet``,
  :class:`_StackedGenWrapper` reads its output back time-major), the port's
  :class:`~satflow_tpu_torch.models.conv_lstm.ConvLSTMCore` (``convlstm``;
  its default fused cell, so on the card every cell step of every generator
  forward is a launch of K1, and the backward of every generator update
  launches K2), or any :func:`~satflow_tpu_torch.nn.gan.define_generator` name;
- discriminator: :func:`~satflow_tpu_torch.nn.gan.define_discriminator`
  (``enhanced`` by default), scoring concat(input stack, candidate stack), or
  with ``condition_time`` each candidate frame alone, the frames folded into
  the batch;
- objective: GANLoss (``loss`` is the GAN mode) + ``lambda_l1`` times the
  ``l1_loss`` reconstruction criterion, two Adams with the plateau / cosine /
  warmup schedulers (models/gan_base.py).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore
from satflow_tpu_torch.models.gan_base import GANBase
from satflow_tpu_torch.models.unet_family import (
    R2UNetCore,
    _stack_time_into_channels,
    _unstack_channels_into_time,
)
from satflow_tpu_torch.nn.gan import define_discriminator, define_generator
from satflow_tpu_torch.nn.losses import get_loss


class _StackedGenWrapper(nn.Module):
    """A channels-stacked generator (``gen``) as video in, video out:
    (B, T, H, W, C) -> (B, H, W, T·C) -> gen -> (B, forecast_steps, H, W, cpt)."""

    def __init__(self, gen: nn.Module, forecast_steps: int, channels_per_timestep: int):
        super().__init__()
        self.gen = gen
        self.forecast_steps = forecast_steps
        self.channels_per_timestep = channels_per_timestep

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self.gen.set_compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5:
            x = _stack_time_into_channels(x)
        return _unstack_channels_into_time(self.gen(x), self.forecast_steps,
                                           self.channels_per_timestep)


@register_model
class CloudGAN(GANBase):
    def __init__(
        self,
        forecast_steps: int = 48,
        input_channels: int = 12,
        lr: float = 2e-4,
        beta1: float = 0.5,
        beta2: float = 0.999,
        num_filters: int = 64,
        generator_model: str = "runet",
        norm: str = "batch",
        use_dropout: bool = False,
        discriminator_model: str = "enhanced",
        discriminator_layers: int = 3,
        loss: str = "vanilla",
        scheduler: str = "plateau",
        lr_epochs: int = 10,
        lambda_l1: float = 100.0,
        l1_loss: str = "l1",
        channels_per_timestep: int = 12,
        condition_time: bool = False,
        pretrained: bool = False,
        features_start: int = 16,
        unet_depth: int = 5,
        dtype: Any = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.num_filters = num_filters
        self.generator_model = generator_model
        self.norm = norm
        self.use_dropout = use_dropout
        self.discriminator_model = discriminator_model
        self.discriminator_layers = discriminator_layers
        self.scheduler = scheduler
        self.lr_epochs = lr_epochs
        self.channels_per_timestep = channels_per_timestep
        self.condition_time = condition_time
        self.features_start = features_start
        self.unet_depth = unet_depth
        self.dtype = dtype
        self._generator = generator
        super().__init__(
            gen_lr=lr,
            disc_lr=lr,
            gan_mode=loss,
            lambda_l1=lambda_l1,
            beta1=beta1,
            beta2=beta2,
            forecast_steps=forecast_steps,
            loss=get_loss(l1_loss, channels=channels_per_timestep),
            input_channels=input_channels,
            output_channels=forecast_steps * channels_per_timestep,
            pretrained=pretrained,
        )
        # the constructor's `loss` is the GAN mode, `l1_loss` the criterion's name
        self.loss_name = loss
        self.l1_loss = l1_loss

    def build_module(self) -> nn.Module:
        kw = dict(dtype=self.dtype, generator=self._generator)
        if self.generator_model == "runet":
            gen = R2UNetCore(out_channels=self.output_channels,
                             features_start=self.features_start, depth=self.unet_depth,
                             t=3, **kw)
            return _StackedGenWrapper(gen, self.forecast_steps, self.channels_per_timestep)
        if self.generator_model == "convlstm":
            return ConvLSTMCore(hidden_dim=self.num_filters, in_channels=self.input_channels,
                                out_channels=self.channels_per_timestep,
                                forecast_steps=self.forecast_steps, **kw)
        gen = define_generator(self.generator_model, output_channels=self.output_channels,
                               ngf=self.num_filters, norm=self.norm,
                               use_dropout=self.use_dropout, dtype=self.dtype,
                               weights_generator=self._generator)
        return _StackedGenWrapper(gen, self.forecast_steps, self.channels_per_timestep)

    def build_discriminator(self) -> nn.Module:
        return define_discriminator(ndf=self.num_filters, discriminator=self.discriminator_model,
                                    n_layers=self.discriminator_layers or 3, norm=self.norm,
                                    dtype=self.dtype, generator=self._generator)

    def prepare_batch(self, batch):
        x, y = super().prepare_batch(batch)
        return x, y[..., : self.channels_per_timestep]

    def disc_input(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.condition_time:
            # each candidate frame scored alone (the reference's per-timestep
            # mode, whose input conditioning is commented out upstream)
            b, t, h, w, c = y.shape
            return y.reshape(b * t, h, w, c)
        return torch.cat([_stack_time_into_channels(x), _stack_time_into_channels(y)], dim=-1)
