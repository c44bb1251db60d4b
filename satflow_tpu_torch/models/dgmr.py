"""NowcastingGAN (DGMR), counterpart of ``satflow_tpu/models/dgmr.py``: a
generator of conditioning stacks and a ConvGRU sampler, a spatial and a
temporal discriminator, the hinge losses and the grid-cell regularizer.

The JAX generator runs its sampler under ``nn.scan`` over the lead times;
here one shared :class:`~satflow_tpu_torch.nn.dgmr_blocks.SamplerStep` runs
in a Python loop, the latent the same at every lead time. ``num_samples``
samples fold into the batch as ``jnp.repeat`` folds them
(``repeat_interleave``: the samples of one input are adjacent) and are read
back as (B, n, ...). The latent noise comes from a ``torch.Generator`` or is
passed as ``z`` (the port cannot reproduce JAX's random stream, so tests
feed both packages the same noise).

The state follows the JAX steps: in the generator step the generator is in
training mode (its stateful spectral norms' ``u`` move) and the dual
discriminator in eval mode (nothing moves); in the discriminator step the
sample is drawn in eval mode and the discriminator, in training mode, moves
its ``u`` on the real pass and again on the fake one. The temporal
discriminator's first 3-D convs take a depth of 2 frames where the sequence
has an even length and 1 otherwise, as the JAX module builds them per call;
their weights are made from the first input. No kernel: every conv, pool and
attention is a library call, as in JAX.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.parameter import is_lazy

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.gan_base import GANBase
from satflow_tpu_torch.nn.dgmr_blocks import (
    ContextConditioningStack,
    DBlock,
    LatentConditioningStack,
    SamplerStep,
    avg_pool2,
    avg_pool_axes,
)
from satflow_tpu_torch.nn.misc import DtypedModule, space_to_depth
from satflow_tpu_torch.nn.norm import SNConv, SNDense, frozen_state


class DGMRGenerator(DtypedModule):
    """(B, T_ctx, H, W, C) + noise -> (B, forecast_steps, H, W, C_out):
    ``context_stack`` (scales H/4 … H/32), ``latent_stack`` (H/32) and the
    ``sampler`` step applied once per lead time."""

    def __init__(self, in_channels: int = 1, forecast_steps: int = 24, out_channels: int = 1,
                 context_channels: int = 384, latent_channels: int = 768,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.forecast_steps = forecast_steps
        cc = context_channels
        scale_channels = (cc // 8, cc // 4, cc // 2, cc)
        kw = dict(generator=generator)
        self.context_stack = ContextConditioningStack(in_channels, scale_channels, **kw)
        self.latent_stack = LatentConditioningStack(latent_channels, **kw)
        self.sampler = SamplerStep(latent_channels, tuple(reversed(scale_channels)),
                                   out_channels, **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, _, h, w, _ = x.shape
        states = tuple(reversed(self.context_stack(x)))  # coarsest first
        latent = self.latent_stack(b, h // 32, w // 32, generator, z)
        frames = []
        for _ in range(self.forecast_steps):
            states, frame = self.sampler(states, latent)
            frames.append(frame)
        return torch.stack(frames, dim=1)


class SpatialDiscriminator(DtypedModule):
    """Per-frame 2-D discriminator on ``num_frames`` frames taken with a
    uniform stride: 2x mean pool, space-to-depth, the D-blocks ``d{i}``
    (downsampling while the map is larger than 1), ReLU, a spatial sum, the
    SN dense ``out``; the frame scores summed."""

    def __init__(self, in_channels: int = 1, num_frames: int = 8, base_channels: int = 48,
                 num_layers: int = 4, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_frames = num_frames
        self.num_layers = num_layers
        width = 4 * in_channels
        for i in range(num_layers):
            ch = base_channels * 2**i
            self.add_module(f"d{i}", DBlock(width, ch, first=(i == 0), generator=generator))
            width = ch
        self.out = SNDense(width, 1, generator=generator)
        self.dtype = dtype

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = video.shape
        n = min(self.num_frames, t)
        stride = max(t // n, 1)
        x = video[:, ::stride][:, :n].reshape(b * n, h, w, c)
        x = space_to_depth(avg_pool2(x), 2)
        for i in range(self.num_layers):
            x = getattr(self, f"d{i}")(x, downsample=x.shape[1] > 1)
        score = self.out(torch.sum(F.relu(x), dim=(1, 2)))
        return torch.sum(score.reshape(b, n), dim=1)


class TemporalDiscriminator(DtypedModule):
    """3-D video discriminator: space-to-depth, two 3-D residual stages
    (``t{i}_c0`` over 2 frames where the length is even, else 1, then
    ``t{i}_c1``, a (2 or 1, 2, 2) mean pool, the skip pooled and projected
    by ``t{i}_skip`` where the width changes), then per-frame D-blocks
    ``d{i}``, ReLU, a spatial sum and the SN dense ``out``, summed over the
    remaining frames."""

    def __init__(self, in_channels: int = 1, base_channels: int = 48, num_layers: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        width = 4 * in_channels
        for i in range(2):
            ch = base_channels * 2**i
            # the depth of t{i}_c0 comes from the first input (see forward)
            self.add_module(f"t{i}_c0", SNConv(None, ch, (2, 3, 3), generator=generator))
            self.add_module(f"t{i}_c1", SNConv(ch, ch, (1, 3, 3), generator=generator))
            if width != ch:
                self.add_module(f"t{i}_skip", SNConv(width, ch, (1, 1, 1), use_bias=False,
                                                     generator=generator))
            width = ch
        for i in range(num_layers):
            ch = base_channels * 2 ** (i + 2)
            self.add_module(f"d{i}", DBlock(width, ch, generator=generator))
            width = ch
        self.out = SNDense(width, 1, generator=generator)
        self.dtype = dtype

    @staticmethod
    def _depth_conv(conv: SNConv, x: torch.Tensor, depth: int) -> torch.Tensor:
        if not is_lazy(conv.weight) and conv.weight.shape[2] != depth:
            raise ValueError(
                f"temporal conv weight {tuple(conv.weight.shape)} was made for a depth of "
                f"{conv.weight.shape[2]} frames; a {x.shape[1]}-frame input takes {depth} "
                "(as flax's ScopeParamShapeError)")
        conv.kernel_size = (depth, 3, 3)
        return conv(x)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b = video.shape[0]
        x = space_to_depth(video, 2)
        for i in range(2):
            down_t = x.shape[1] % 2 == 0 and x.shape[1] > 1
            h = x if i == 0 else F.relu(x)
            h = self._depth_conv(getattr(self, f"t{i}_c0"), h, 2 if down_t else 1)
            h = getattr(self, f"t{i}_c1")(F.relu(h))
            pool = (2 if down_t else 1, 2, 2)
            h, skip = avg_pool_axes(h, pool), avg_pool_axes(x, pool)
            if hasattr(self, f"t{i}_skip"):
                skip = getattr(self, f"t{i}_skip")(skip)
            x = h + skip
        t_rem = x.shape[1]
        x = x.reshape(b * t_rem, *x.shape[2:])
        for i in range(self.num_layers):
            x = getattr(self, f"d{i}")(x, downsample=x.shape[1] > 1)
        score = self.out(torch.sum(F.relu(x), dim=(1, 2)))
        return torch.sum(score.reshape(b, t_rem), dim=1)


class _DualDiscriminator(DtypedModule):
    """``spatial`` on the future frames and ``temporal`` on the context and
    future as one sequence; returns (spatial, temporal) scores."""

    def __init__(self, in_channels: int = 1, base_channels: int = 48, spatial_layers: int = 4,
                 temporal_layers: int = 3, num_spatial_frames: int = 8,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spatial = SpatialDiscriminator(in_channels, num_spatial_frames, base_channels,
                                            spatial_layers, generator=generator)
        self.temporal = TemporalDiscriminator(in_channels, base_channels, temporal_layers,
                                              generator=generator)
        self.dtype = dtype

    def forward(self, context: torch.Tensor, video: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.spatial(video), self.temporal(torch.cat([context, video], dim=1))


@register_model(name="nowcastinggan")
class NowcastingGAN(GANBase):
    """The configuration of ``configs/model/nowcasting_gan.yaml``; weights
    come from ``generator`` (the default generator when None)."""

    def __init__(
        self,
        forecast_steps: int = 24,
        input_channels: int = 1,
        output_shape: int = 128,
        gen_lr: float = 5e-5,
        disc_lr: float = 2e-4,
        visualize: bool = False,
        pretrained: bool = False,
        conv_type: str = "standard",
        num_samples: int = 3,
        disc_steps: int = 2,
        grid_lambda: float = 20.0,
        latent_channels: int = 768,
        context_channels: int = 384,
        disc_channels: int = 48,
        disc_spatial_layers: int = 4,
        disc_temporal_layers: int = 3,
        beta1: float = 0.0,
        beta2: float = 0.999,
        dtype: Any = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.output_shape = output_shape
        self.num_samples = num_samples
        self.disc_steps = disc_steps
        self.grid_lambda = grid_lambda
        self.latent_channels = latent_channels
        self.context_channels = context_channels
        self.disc_channels = disc_channels
        self.disc_spatial_layers = disc_spatial_layers
        self.disc_temporal_layers = disc_temporal_layers
        self.conv_type = conv_type
        self.dtype = dtype
        self._generator = generator
        super().__init__(
            gen_lr=gen_lr,
            disc_lr=disc_lr,
            gan_mode="vanilla",  # the hinge losses are applied explicitly
            lambda_l1=grid_lambda,
            beta1=beta1,
            beta2=beta2,
            forecast_steps=forecast_steps,
            loss="l1",
            input_channels=input_channels,
            output_channels=input_channels,
            pretrained=pretrained,
            visualize=visualize,
        )

    def build_module(self):
        return DGMRGenerator(self.input_channels, self.forecast_steps, self.output_channels,
                             self.context_channels, self.latent_channels, dtype=self.dtype,
                             generator=self._generator)

    def build_discriminator(self):
        return _DualDiscriminator(self.input_channels, self.disc_channels,
                                  self.disc_spatial_layers, self.disc_temporal_layers,
                                  dtype=self.dtype, generator=self._generator)

    def prepare_batch(self, batch):
        x, y = super().prepare_batch(batch)
        return x[..., : self.input_channels], y[..., : self.output_channels]

    def generate(self, x: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 z: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
        self.module.train(train)
        return self.module(x, generator=generator, z=z)

    def _sample(self, x: torch.Tensor, generator: Optional[torch.Generator], train: bool,
                n_samples: int, z: Optional[torch.Tensor] = None):
        """``n_samples`` samples per input folded into the batch of one
        generator call; returns ((B, n, F, H, W, C) samples, None). ``z``
        (B·n, H/32, W/32, 8), the latent noise, is drawn from ``generator``
        unless given."""
        b = x.shape[0]
        y_hat = self.generate(x.repeat_interleave(n_samples, dim=0), train, generator, z)
        return y_hat.reshape(b, n_samples, *y_hat.shape[1:]), None

    def materialize(self, batch) -> None:
        """The lazy weights (the context mixes, the temporal 3-D convs) from
        one sample of ``batch``: the generator and the discriminator on
        (x, y), as the JAX ``init_gan_variables`` initialises it."""
        if not any(is_lazy(p) for p in self.parameters()):
            return
        x, y = self.prepare_batch(batch)
        device = next(p for p in self.parameters() if not is_lazy(p)).device
        training = self.training
        with torch.no_grad(), frozen_state(self):
            self.generate(x[:1], False, torch.Generator(device=device).manual_seed(0))
            self.disc_module.eval()
            self.disc_module(x[:1], y[:1])
        self.train(training)

    def generator_loss(self, batch, generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None, **kwargs):
        """``num_samples`` samples in training mode scored by the dual
        discriminator in eval mode: ``-(mean spatial + mean temporal)`` plus
        ``grid_lambda`` times the grid-cell regularizer of the sample mean."""
        x, y = self.prepare_batch(batch)
        samples, _ = self._sample(x, generator, True, self.num_samples, z)
        b, n = samples.shape[:2]
        flat = samples.reshape(b * n, *samples.shape[2:])
        self.disc_module.eval()
        s_score, t_score = self.disc_module(x.repeat_interleave(n, dim=0), flat)
        adv = -(torch.mean(_f32(s_score)) + torch.mean(_f32(t_score)))
        mean_pred = torch.mean(samples, dim=1)
        reg = grid_cell_regularizer(mean_pred, y)
        loss = adv + self.grid_lambda * reg
        return loss, {"loss": loss, "adv_loss": adv, "grid_reg": reg,
                      **self.frame_metrics(mean_pred, y)}

    def discriminator_loss(self, batch, generator: Optional[torch.Generator] = None,
                           z: Optional[torch.Tensor] = None, **kwargs):
        """Hinge losses of both discriminators on the real frames and one
        eval-mode sample, the discriminator in training mode (its ``u``
        moving on each pass)."""
        x, y = self.prepare_batch(batch)
        with torch.no_grad():
            fake = self._sample(x, generator, False, 1, z)[0][:, 0]
        self.disc_module.train()
        s_real, t_real = self.disc_module(x, y)
        s_fake, t_fake = self.disc_module(x, fake)
        real = hinge_real(s_real) + hinge_real(t_real)
        fake_loss = hinge_fake(s_fake) + hinge_fake(t_fake)
        loss = real + fake_loss
        return loss, {"loss": loss, "real_loss": real, "fake_loss": fake_loss}

    def make_optimizers(self):
        """Adam at ``gen_lr`` and ``disc_lr``, betas (``beta1`` (0 for
        DGMR), ``beta2``), constant rates."""
        kw = dict(betas=(self.beta1, self.beta2), eps=1e-8)
        return (torch.optim.Adam(self.module.parameters(), lr=self.gen_lr, **kw),
                torch.optim.Adam(self.disc_module.parameters(), lr=self.disc_lr, **kw))


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 at least."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def hinge_real(score: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.relu(1.0 - _f32(score)))


def hinge_fake(score: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.relu(1.0 + _f32(score)))


def grid_cell_regularizer(mean_pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Weighted L1 of the sample mean, heavier on high-intensity cells
    (Ravuri et al. eq. 2), for [0, 1]-scaled imagery."""
    weights = torch.clamp(target, 0.0, 1.0)
    return torch.mean(torch.abs(mean_pred - target) * (1.0 + 23.0 * weights) / 24.0)
