"""Pix2Pix, counterpart of ``satflow_tpu/models/pix2pix.py``: the past
frames stacked into channels -> every future frame as channels, a
``unet_128`` generator (128² inputs) and a PatchGAN discriminator scoring
concat(condition, candidate), vanilla GAN loss + ``lambda_l1`` times L1.

Training works on the stacked layout; :meth:`Pix2Pix.forward` and
:meth:`Pix2Pix.sample` (what a session serves) take (B, T, H, W, C) and
return time-major (B, forecast_steps, H, W, cpt), as the JAX ``forward``
does for the evaluator.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.gan_base import GANBase
from satflow_tpu_torch.models.unet_family import (
    _stack_time_into_channels,
    _unstack_channels_into_time,
)
from satflow_tpu_torch.nn.gan import define_discriminator, define_generator


@register_model
class Pix2Pix(GANBase):
    def __init__(
        self,
        forecast_steps: int = 48,
        input_channels: int = 12,
        lr: float = 2e-4,
        beta1: float = 0.5,
        beta2: float = 0.999,
        num_filters: int = 64,
        generator_model: str = "unet_128",
        norm: str = "batch",
        use_dropout: bool = False,
        discriminator_model: str = "basic",
        discriminator_layers: int = 3,
        loss: str = "vanilla",
        scheduler: str = "plateau",
        lr_epochs: int = 10,
        lambda_l1: float = 100.0,
        channels_per_timestep: int = 12,
        pretrained: bool = False,
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
            loss="l1",
            input_channels=input_channels,
            output_channels=forecast_steps * channels_per_timestep,
            pretrained=pretrained,
        )
        self.loss_name = loss  # the GAN mode

    def build_module(self) -> nn.Module:
        return define_generator(self.generator_model, output_channels=self.output_channels,
                                ngf=self.num_filters, norm=self.norm,
                                use_dropout=self.use_dropout, dtype=self.dtype,
                                weights_generator=self._generator)

    def build_discriminator(self) -> nn.Module:
        return define_discriminator(ndf=self.num_filters, discriminator=self.discriminator_model,
                                    n_layers=self.discriminator_layers or 3, norm=self.norm,
                                    dtype=self.dtype, generator=self._generator)

    def prepare_batch(self, batch):
        x, y = self.eval_batch(batch)
        return x, _stack_time_into_channels(y)

    def eval_batch(self, batch):
        """The stacked input and the time-major target the evaluator reads."""
        x, y = super().prepare_batch(batch)
        return _stack_time_into_channels(x), y[..., : self.channels_per_timestep]

    def disc_input(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, y], dim=-1)

    @torch.no_grad()
    def frame_metrics(self, y_hat: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-frame MSE over the stacked channel groups."""
        b, h, w, _ = y_hat.shape
        diff = torch.square(y_hat - y).reshape(b, h, w, self.forecast_steps,
                                               self.channels_per_timestep)
        return {"frame_loss": diff.mean(dim=(0, 1, 2, 4))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) or stacked (B, H, W, T·C) -> (B, forecast_steps,
        H, W, cpt)."""
        if x.dim() == 5:
            x = _stack_time_into_channels(x)
        return _unstack_channels_into_time(self.module(x), self.forecast_steps,
                                           self.channels_per_timestep)

    def sample(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        self.module.eval()
        return self(x)
