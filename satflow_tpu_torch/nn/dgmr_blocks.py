"""DGMR building blocks (NHWC), counterpart of ``satflow_tpu/nn/dgmr_blocks.py``:
the G, D and L residual blocks, the context and latent conditioning stacks and
the sampler's per-lead-time step.

Every conv is spectrally normalised (:class:`~satflow_tpu_torch.nn.norm.SNConv`,
the stateful form outside the sampler, the stateless one inside it), and the
submodules carry the flax names, so a flax tree converts leaf by leaf
(:func:`~satflow_tpu_torch.interop.jax_weights.gan_state_dict_from_flax`). The
JAX sampler runs :class:`SamplerStep` under ``nn.scan`` over the lead times
with its parameters broadcast; the port's generator calls one shared
:class:`SamplerStep` in a Python loop (``models/dgmr.py``). No kernel: the
convs, pools and the latent stack's attention are library calls, as the JAX
blocks leave them to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.nn.attention import SAGANAttention2d
from satflow_tpu_torch.nn.misc import (
    BatchNorm,
    DtypedModule,
    LayerNorm,
    compute_dtype,
    reverse_space_to_depth,
    space_to_depth,
)
from satflow_tpu_torch.nn.norm import ConditionalNorm, SNConv
from satflow_tpu_torch.nn.recurrent import ConvGRUCell
from satflow_tpu_torch.nn.unet_blocks import upsample2


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 mean pool of an NHWC tensor (flax ``avg_pool``, VALID)."""
    return F.avg_pool2d(x.movedim(-1, 1), 2, 2).movedim(1, -1)


def avg_pool_axes(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Mean pool over the spatial axes of a channels-last tensor, stride =
    ``window`` (flax ``avg_pool``, VALID); 2 or 3 spatial axes."""
    pool = F.avg_pool2d if len(window) == 2 else F.avg_pool3d
    return pool(x.movedim(-1, 1), tuple(window), tuple(window)).movedim(1, -1)


class _SNBlock(DtypedModule):
    """A block whose ``dtype`` every conv and norm below it follows."""

    def _norm(self, norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if isinstance(norm, BatchNorm):
            return norm(x, compute_dtype(self.dtype, x))
        return norm(x)


class GBlock(_SNBlock):
    """Generator residual block: norm -> ReLU -> (2x up) -> ``c0`` -> norm ->
    ReLU -> ``c1``, plus the (upsampled, 1x1-projected where the width
    changes: ``skip``) input. ``norm`` is "batch" (flax BatchNorm, batch
    statistics in training mode) or "layer"; ``sn_stateless`` makes the
    convs' spectral norm stateless (the sampler's)."""

    def __init__(self, in_features: int, features: int, upsample: bool = False,
                 norm: str = "batch", sn_stateless: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsample = upsample

        def make_norm(width):
            return LayerNorm(width) if norm == "layer" else BatchNorm(width)

        sn = dict(stateless=sn_stateless, generator=generator)
        self.bn0 = make_norm(in_features)
        self.c0 = SNConv(in_features, features, 3, **sn)
        self.bn1 = make_norm(features)
        self.c1 = SNConv(features, features, 3, **sn)
        if in_features != features:
            self.skip = SNConv(in_features, features, 1, use_bias=False, **sn)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self._norm(self.bn0, x))
        if self.upsample:
            h = upsample2(h)
        h = self.c1(F.relu(self._norm(self.bn1, self.c0(h))))
        skip = upsample2(x) if self.upsample else x
        if hasattr(self, "skip"):
            skip = self.skip(skip)
        return h + skip


class ConditionalGBlock(_SNBlock):
    """:class:`GBlock` with conditional batch norms (``cbn0``, ``cbn1``)
    whose affine comes from ``condition`` (B, cond_features)."""

    def __init__(self, in_features: int, features: int, cond_features: int,
                 upsample: bool = False, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsample = upsample
        self.cbn0 = ConditionalNorm(in_features, cond_features)
        self.c0 = SNConv(in_features, features, 3, generator=generator)
        self.cbn1 = ConditionalNorm(features, cond_features)
        self.c1 = SNConv(features, features, 3, generator=generator)
        if in_features != features:
            self.skip = SNConv(in_features, features, 1, use_bias=False, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.cbn0(x, condition))
        if self.upsample:
            h = upsample2(h)
        h = self.c1(F.relu(self.cbn1(self.c0(h), condition)))
        skip = upsample2(x) if self.upsample else x
        if hasattr(self, "skip"):
            skip = self.skip(skip)
        return h + skip


class DBlock(_SNBlock):
    """Discriminator residual block: (ReLU unless ``first``) -> ``c0`` ->
    ReLU -> ``c1`` -> (mean pool), plus the (pooled, projected where the
    width changes) input. ``conv_3d`` makes the convs 3x3x3 and the pool
    (1, 2, 2) over an NTHWC input. ``forward``'s ``downsample`` overrides
    the constructor's for one call (the DGMR discriminators decide it from
    the input's size, as the JAX ones build each block)."""

    def __init__(self, in_features: int, features: int, downsample: bool = True,
                 first: bool = False, conv_3d: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.downsample = downsample
        self.first = first
        self.conv_3d = conv_3d
        k = (3, 3, 3) if conv_3d else 3
        self.c0 = SNConv(in_features, features, k, generator=generator)
        self.c1 = SNConv(features, features, k, generator=generator)
        if in_features != features:
            self.skip = SNConv(in_features, features, (1,) * (3 if conv_3d else 2),
                               use_bias=False, generator=generator)
        self.dtype = dtype

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_axes(x, (1, 2, 2)) if self.conv_3d else avg_pool2(x)

    def forward(self, x: torch.Tensor, downsample: Optional[bool] = None) -> torch.Tensor:
        down = self.downsample if downsample is None else downsample
        h = x if self.first else F.relu(x)
        h = self.c1(F.relu(self.c0(h)))
        skip = x
        if down:
            h, skip = self._pool(h), self._pool(skip)
        if hasattr(self, "skip"):
            skip = self.skip(skip)
        return h + skip


class LBlock(_SNBlock):
    """Latent-stack residual block: ReLU -> ``c0`` -> ReLU -> ``c1``, plus
    the input widened by concatenating a 1x1 projection to the missing
    channels (``skip``), or projected down where it is wider."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = SNConv(in_features, features, 3, generator=generator)
        self.c1 = SNConv(features, features, 3, generator=generator)
        self.widen = in_features < features
        if in_features != features:
            self.skip = SNConv(in_features, features - in_features if self.widen else features,
                               1, use_bias=False, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c1(F.relu(self.c0(F.relu(x))))
        skip = x
        if hasattr(self, "skip"):
            extra = self.skip(skip)
            skip = torch.cat([skip, extra], dim=-1) if self.widen else extra
        return h + skip


class ContextConditioningStack(_SNBlock):
    """Past frames (B, T, H, W, C) -> the context states at H/4, H/8, H/16,
    H/32 with ``scale_channels`` channels: space-to-depth x2, then per scale
    a D-block ``d{i}`` over every frame, the T frames' features stacked on
    the channels and mixed by ``mix{i}`` (its width, T times the block's,
    comes from the first input), then ReLU."""

    def __init__(self, in_channels: int, scale_channels: Sequence[int] = (48, 96, 192, 384),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = 4 * in_channels
        for i, ch in enumerate(scale_channels):
            feat = max(ch // 2, 4)
            self.add_module(f"d{i}", DBlock(width, feat, first=(i == 0), generator=generator))
            self.add_module(f"mix{i}", SNConv(None, ch, 3, generator=generator))
            width = feat
        self.n_scales = len(scale_channels)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        b, t, h, w, c = x.shape
        feat = space_to_depth(x, 2).reshape(b * t, h // 2, w // 2, 4 * c)
        contexts = []
        for i in range(self.n_scales):
            feat = getattr(self, f"d{i}")(feat)
            fh, fw, fc = feat.shape[1:]
            stacked = feat.reshape(b, t, fh, fw, fc).permute(0, 2, 3, 1, 4).reshape(
                b, fh, fw, t * fc)
            contexts.append(F.relu(getattr(self, f"mix{i}")(stacked)))
        return tuple(contexts)


class LatentConditioningStack(_SNBlock):
    """Noise -> the coarsest latent (B, h, w, ``latent_channels``): z ~ N(0,
    1) over an (h, w, ``shape_channels``) grid (drawn from ``generator``, or
    passed as ``z``), then ``in_`` (flax's ``in``), the L-blocks ``l0``-``l2``
    growing the channels, the SAGAN attention ``attn`` and the L-block
    ``out``."""

    def __init__(self, latent_channels: int = 768, shape_channels: int = 8,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shape_channels = shape_channels
        self.in_ = SNConv(shape_channels, shape_channels, 3, generator=generator)
        width = shape_channels
        lc = latent_channels
        for i, ch in enumerate((lc // 32, lc // 16, lc // 4)):
            self.add_module(f"l{i}", LBlock(width, max(ch, 4), generator=generator))
            width = max(ch, 4)
        self.attn = SAGANAttention2d(width, pool_kv=False, generator=generator)
        self.out = LBlock(width, lc, generator=generator)
        self.dtype = dtype

    def forward(self, batch: int, height: int, width: int,
                generator: Optional[torch.Generator] = None,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        if z is None:
            device = self.in_.weight.device
            z = torch.randn(batch, height, width, self.shape_channels, generator=generator,
                            device=device)
        elif tuple(z.shape) != (batch, height, width, self.shape_channels):
            raise ValueError(f"z has shape {tuple(z.shape)}, the stack draws "
                             f"{(batch, height, width, self.shape_channels)}")
        h = self.in_(z)
        for i in range(3):
            h = getattr(self, f"l{i}")(h)
        return self.out(self.attn(h))


class SamplerStep(_SNBlock):
    """One lead time through the 4-scale ConvGRU stack (coarsest first):
    ``gru{i}`` updates scale i's state from the input (the latent at the
    coarsest scale, else the previous scale's output), ``proj{i}`` (1x1)
    and the upsampling layer-norm G-block ``g{i}`` make the next scale's
    input; then ``ln_out``, ReLU, the 1x1 ``head`` to 4·C_out channels and
    depth-to-space x2. All spectral norms stateless. ``(states, latent) ->
    (new states, frame)``."""

    def __init__(self, latent_channels: int, scale_channels: Sequence[int] = (384, 192, 96, 48),
                 out_channels: int = 1, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(generator=generator)
        width = latent_channels
        for i, ch in enumerate(scale_channels):
            self.add_module(f"gru{i}", ConvGRUCell(width, ch, sn=True, sn_stateless=True, **kw))
            self.add_module(f"proj{i}", SNConv(ch, ch, 1, stateless=True, **kw))
            self.add_module(f"g{i}", GBlock(ch, ch, upsample=True, norm="layer",
                                            sn_stateless=True, **kw))
            width = ch
        self.ln_out = LayerNorm(width)
        self.head = SNConv(width, 4 * out_channels, 1, stateless=True, **kw)
        self.n_scales = len(scale_channels)
        self.dtype = dtype

    def forward(self, states: Sequence[torch.Tensor], latent: torch.Tensor):
        inp = latent
        new_states = []
        for i in range(self.n_scales):
            (h,), _ = getattr(self, f"gru{i}")((states[i],), inp)
            new_states.append(h)
            inp = getattr(self, f"g{i}")(getattr(self, f"proj{i}")(h))
        out = self.head(F.relu(self.ln_out(inp)))
        return tuple(new_states), reverse_space_to_depth(out, 2)
