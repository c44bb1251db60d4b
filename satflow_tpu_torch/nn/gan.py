"""GAN building blocks (NHWC), counterpart of ``satflow_tpu/nn/gan.py``: the
pix2pix generators and discriminators, their factories, the norm factory and
the weight-init factory.

- :func:`define_generator`: ``resnet_6blocks`` / ``resnet_9blocks``
  (:class:`ResnetGenerator`, optionally with BlurPool downsampling),
  ``unet_128`` / ``unet_256`` (:class:`UnetGenerator`, which needs 128² /
  256² inputs), or a module passed through.
- :func:`define_discriminator`: ``basic`` / ``n_layers``
  (:class:`NLayerDiscriminator`, PatchGAN), ``pixel``
  (:class:`PixelDiscriminator`), ``enhanced`` (:class:`CloudGANDiscriminator`).
- :func:`get_norm_layer`: ``batch`` (the shared flax BatchNorm under
  ``BatchNorm_0``, as flax names the wrapped module), ``instance``
  (:class:`InstanceNorm`, no statistics kept), ``none``.

Submodules carry the flax names (a keyword, ``in``, takes a trailing
underscore), so a flax tree converts leaf by leaf. The first conv of each
network takes its width from the first input, as flax infers it. The U-Net's
levels are the generator's children (``inner``, ``mid{i}``, ``outer{i}``,
``top``), as flax registers them, and each level calls the next one given to
it. A network computes in its ``dtype`` (None: the input's, at least
float32); its norms, which the JAX networks build without a dtype, return
flax's promotion of their input (f32 for bf16 activations). Training mode is
flax's ``train=True``: batch statistics (moved unless
:func:`~satflow_tpu_torch.nn.norm.frozen_state` holds them) and dropout. No
kernel: the convs, pads and pools are library calls, as the JAX networks
leave them to XLA.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.nn.conv import BlurPool, Conv, ConvTranspose, lecun_normal_
from satflow_tpu_torch.nn.misc import BatchNorm, DtypedModule, compute_dtype


def get_initializer(init_type: str = "normal", gain: float = 0.02) -> Callable:
    """Weight-init factory: ``init(weight, generator=None)`` fills a torch-layout
    weight ((O, I, *k) or (O, I)) in place with flax's initializer of that
    name: ``normal`` (N(0, gain²)), ``xavier`` (glorot normal), ``kaiming``
    (he normal), ``orthogonal`` (scale ``gain``). flax's glorot and he
    normals are truncated at ±2σ and rescaled; so are these."""

    def variance_scaling(scale: float, mode: str):
        def init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
            receptive = w[0, 0].numel() if w.dim() > 2 else 1
            fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
            fan = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2
            std = math.sqrt(scale / fan) / 0.87962566103423978
            with torch.no_grad():
                return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

        return init

    if init_type == "normal":
        def normal(w, generator=None):
            with torch.no_grad():
                return w.normal_(0.0, gain, generator=generator)

        return normal
    if init_type == "xavier":
        return variance_scaling(1.0, "fan_avg")
    if init_type == "kaiming":
        return variance_scaling(2.0, "fan_in")
    if init_type == "orthogonal":
        def orthogonal(w, generator=None):
            with torch.no_grad():
                return nn.init.orthogonal_(w.view(w.shape[0], -1), gain, generator=generator)

        return orthogonal
    raise ValueError(f"initialization method {init_type!r} is not implemented")


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over the spatial axes (torch's
    InstanceNorm2d, no affine, no statistics kept)."""

    def __init__(self, features: Optional[int] = None, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        mean = x.mean(dim=axes, keepdim=True)
        var = torch.square(x - mean).mean(dim=axes, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.epsilon)


class _BatchNormWrap(nn.Module):
    """flax BatchNorm wrapped as the JAX norm factory wraps it (the
    parameters under ``BatchNorm_0``); built without a dtype there, so the
    output is flax's promotion of the input."""

    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x, compute_dtype(None, x))


class _NoNorm(nn.Module):
    def __init__(self, features: Optional[int] = None):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def get_norm_layer(norm: str = "batch") -> Callable[[int], nn.Module]:
    """The norm constructor (taking the channel width) by name: ``batch``,
    ``instance`` or ``none``."""
    if norm == "batch":
        return _BatchNormWrap
    if norm == "instance":
        return InstanceNorm
    if norm == "none":
        return _NoNorm
    raise ValueError(f"normalization layer {norm!r} is not found")


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad the H and W axes of an NHWC tensor by ``p`` (``jnp.pad``'s
    ``reflect``: the edge is not repeated)."""
    return F.pad(x.movedim(-1, 1), (p, p, p, p), mode="reflect").movedim(1, -1)


def _dropout(x: torch.Tensor, training: bool) -> torch.Tensor:
    return F.dropout(x, 0.5, training)


class ResnetBlock(DtypedModule):
    """reflect pad -> 3x3 ``c0`` -> ``n0`` -> ReLU -> (dropout) -> reflect
    pad -> 3x3 ``c1`` -> ``n1``, plus the input."""

    def __init__(self, features: int, norm: str = "batch", use_dropout: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_cls = get_norm_layer(norm)
        self.use_dropout = use_dropout
        self.c0 = Conv(features, features, (3, 3), padding="VALID", generator=generator)
        self.n0 = norm_cls(features)
        self.c1 = Conv(features, features, (3, 3), padding="VALID", generator=generator)
        self.n1 = norm_cls(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.n0(self.c0(_reflect_pad(x, 1))))
        if self.use_dropout:
            h = _dropout(h, self.training)
        return x + self.n1(self.c1(_reflect_pad(h, 1)))


class ResnetGenerator(DtypedModule):
    """c7s1-ngf (``in_``), two stride-2 downsamples (``down{i}``; with
    ``antialiased`` a stride-1 conv and ``blur{i}``), ``n_blocks`` resnet
    blocks, two stride-2 transposed convs (``up{i}``), c7s1-out (``out``),
    tanh."""

    def __init__(self, output_channels: int, ngf: int = 64, n_blocks: int = 6,
                 norm: str = "batch", use_dropout: bool = False, antialiased: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_cls = get_norm_layer(norm)
        self.antialiased = antialiased
        self.n_blocks = n_blocks
        self.in_ = Conv(None, ngf, (7, 7), padding="VALID", generator=generator)
        self.in_norm = norm_cls(ngf)
        width = ngf
        for i in range(2):
            feat = ngf * 2 ** (i + 1)
            self.add_module(f"down{i}", Conv(width, feat, (3, 3), 1 if antialiased else 2,
                                             "SAME", generator=generator))
            if antialiased:
                self.add_module(f"blur{i}", BlurPool(stride=2))
            self.add_module(f"down{i}_norm", norm_cls(feat))
            width = feat
        for i in range(n_blocks):
            self.add_module(f"block{i}", ResnetBlock(ngf * 4, norm, use_dropout,
                                                     generator=generator))
        for i in range(2):
            feat = ngf * 2 ** (2 - i) // 2
            self.add_module(f"up{i}", ConvTranspose(width, feat, (3, 3), (2, 2),
                                                    generator=generator))
            self.add_module(f"up{i}_norm", norm_cls(feat))
            width = feat
        self.out = Conv(width, output_channels, (7, 7), padding="VALID", generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.in_norm(self.in_(_reflect_pad(x, 3))))
        for i in range(2):
            h = getattr(self, f"down{i}")(h)
            if self.antialiased:
                h = getattr(self, f"blur{i}")(h)
            h = F.relu(getattr(self, f"down{i}_norm")(h))
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h)
        for i in range(2):
            h = F.relu(getattr(self, f"up{i}_norm")(getattr(self, f"up{i}")(h)))
        return torch.tanh(self.out(_reflect_pad(h, 3)))


class UnetSkipBlock(DtypedModule):
    """One level of the pix2pix U-Net: (LeakyReLU 0.2 unless outermost) ->
    4x4 stride-2 ``down`` -> (``down_norm`` unless outer- or innermost) ->
    the inner levels (``sub``, given per call) -> ReLU -> 4x4 stride-2
    transposed ``up`` -> tanh when outermost, else ``up_norm``, (dropout),
    and the input concatenated before the result."""

    def __init__(self, outer_features: int, inner_features: int, outermost: bool = False,
                 innermost: bool = False, norm: str = "batch", use_dropout: bool = False,
                 output_channels: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_cls = get_norm_layer(norm)
        self.outermost, self.innermost = outermost, innermost
        self.use_dropout = use_dropout
        self.down = Conv(None if outermost else outer_features, inner_features, (4, 4), 2, 1,
                         generator=generator)
        if not outermost and not innermost:
            self.down_norm = norm_cls(inner_features)
        out_features = output_channels if outermost else outer_features
        self.up = ConvTranspose(inner_features if innermost else 2 * inner_features,
                                out_features, (4, 4), (2, 2), generator=generator)
        if not outermost:
            self.up_norm = norm_cls(out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, sub: Optional[Callable] = None) -> torch.Tensor:
        down = self.down(x if self.outermost else F.leaky_relu(x, 0.2))
        if hasattr(self, "down_norm"):
            down = self.down_norm(down)
        up = self.up(F.relu(down if sub is None else sub(down)))
        if self.outermost:
            return torch.tanh(up)
        up = self.up_norm(up)
        if self.use_dropout:
            up = _dropout(up, self.training)
        return torch.cat([x, up], dim=-1)


class UnetGenerator(DtypedModule):
    """pix2pix U-Net of ``num_downs`` levels (7: ``unet_128``, 8:
    ``unet_256``); the input's sides must be multiples of 2^num_downs."""

    def __init__(self, output_channels: int, num_downs: int = 7, ngf: int = 64,
                 norm: str = "batch", use_dropout: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(norm=norm, generator=generator)
        levels: List[str] = ["inner"]
        self.inner = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True, **kw)
        for i in range(num_downs - 5):
            self.add_module(f"mid{i}", UnetSkipBlock(ngf * 8, ngf * 8, use_dropout=use_dropout,
                                                     **kw))
            levels.append(f"mid{i}")
        for i, mult in enumerate((4, 2, 1)):
            self.add_module(f"outer{i}", UnetSkipBlock(ngf * mult, ngf * mult * 2, **kw))
            levels.append(f"outer{i}")
        self.top = UnetSkipBlock(ngf, ngf, outermost=True, output_channels=output_channels,
                                 **kw)
        levels.append("top")
        self._levels = levels[::-1]  # outermost first
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def level(i: int) -> Callable:
            block = getattr(self, self._levels[i])
            if i == len(self._levels) - 1:
                return block
            return lambda h: block(h, level(i + 1))

        return level(0)(x)


def define_generator(generator, output_channels: int = 12, ngf: int = 64, norm: str = "batch",
                     use_dropout: bool = False,
                     weights_generator: Optional[torch.Generator] = None,
                     **kwargs) -> nn.Module:
    """Generator by name (``resnet_9blocks``, ``resnet_6blocks``, ``unet_128``,
    ``unet_256``), or a module passed through; ``weights_generator`` is the
    ``torch.Generator`` its weights are drawn from (``generator`` is the
    name, as in JAX)."""
    if isinstance(generator, nn.Module):
        return generator
    kwargs["generator"] = weights_generator
    if generator == "resnet_9blocks":
        return ResnetGenerator(output_channels, ngf, 9, norm, use_dropout, **kwargs)
    if generator == "resnet_6blocks":
        return ResnetGenerator(output_channels, ngf, 6, norm, use_dropout, **kwargs)
    if generator == "unet_128":
        return UnetGenerator(output_channels, 7, ngf, norm, use_dropout, **kwargs)
    if generator == "unet_256":
        return UnetGenerator(output_channels, 8, ngf, norm, use_dropout, **kwargs)
    raise ValueError(f"Generator model name {generator!r} is not recognized")


class NLayerDiscriminator(DtypedModule):
    """PatchGAN: 4x4 stride-2 ``in_``, LeakyReLU 0.2, ``n_layers`` - 1 more
    stride-2 convs ``c{i}`` with norms ``n{i}``, a stride-1 ``pre`` with
    ``pre_norm``, and the 1-channel stride-1 ``out``; every conv padded by
    1. Raises where the patch map collapses to nothing."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, norm: str = "batch",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_cls = get_norm_layer(norm)
        self.n_layers = n_layers
        self.in_ = Conv(None, ndf, (4, 4), 2, 1, generator=generator)
        width = ndf
        for i in range(1, n_layers):
            feat = ndf * min(2**i, 8)
            self.add_module(f"c{i}", Conv(width, feat, (4, 4), 2, 1, generator=generator))
            self.add_module(f"n{i}", norm_cls(feat))
            width = feat
        feat = ndf * min(2**n_layers, 8)
        self.pre = Conv(width, feat, (4, 4), 1, 1, generator=generator)
        self.pre_norm = norm_cls(feat)
        self.out = Conv(feat, 1, (4, 4), 1, 1, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax pads and convolves an image smaller than a kernel to an empty
        # map without complaint; torch refuses first, so the size is checked here
        h, w = x.shape[1:3]
        for _ in range(self.n_layers):
            h, w = (h + 2 - 4) // 2 + 1, (w + 2 - 4) // 2 + 1
        if min(h, w) - 2 < 1:
            raise ValueError(
                f"PatchGAN output collapsed: input {x.shape[1]}x{x.shape[2]} is too small "
                f"for n_layers={self.n_layers}; use fewer layers or larger images")
        h = F.leaky_relu(self.in_(x), 0.2)
        for i in range(1, self.n_layers):
            h = F.leaky_relu(getattr(self, f"n{i}")(getattr(self, f"c{i}")(h)), 0.2)
        h = F.leaky_relu(self.pre_norm(self.pre(h)), 0.2)
        return self.out(h)


class PixelDiscriminator(DtypedModule):
    """1x1 convs ``c0`` (LeakyReLU), ``c1`` with ``n1`` (LeakyReLU), ``out``:
    one score per pixel."""

    def __init__(self, ndf: int = 64, norm: str = "batch", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = Conv(None, ndf, (1, 1), generator=generator)
        self.c1 = Conv(ndf, ndf * 2, (1, 1), generator=generator)
        self.n1 = get_norm_layer(norm)(ndf * 2)
        self.out = Conv(ndf * 2, 1, (1, 1), generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.c0(x), 0.2)
        h = F.leaky_relu(self.n1(self.c1(h)), 0.2)
        return self.out(h)


class CloudGANDiscriminator(DtypedModule):
    """``n_stages`` 4x4 stride-2 SAME convs ``c{i}`` with norms ``n{i}`` and
    LeakyReLU 0.2, a global mean pool and the Dense ``head`` to one score."""

    def __init__(self, ndf: int = 64, n_stages: int = 4, norm: str = "batch",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_cls = get_norm_layer(norm)
        self.n_stages = n_stages
        width = None
        for i in range(n_stages):
            feat = ndf * min(2**i, 8)
            self.add_module(f"c{i}", Conv(width, feat, (4, 4), 2, "SAME", generator=generator))
            self.add_module(f"n{i}", norm_cls(feat))
            width = feat
        self.head = nn.Linear(width, 1)
        lecun_normal_(self.head.weight, width, generator)
        nn.init.zeros_(self.head.bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_stages):
            h = F.leaky_relu(getattr(self, f"n{i}")(getattr(self, f"c{i}")(h)), 0.2)
        h = h.mean(dim=(1, 2))
        cd = compute_dtype(self.dtype, h)
        return F.linear(h.to(cd), self.head.weight.to(cd), self.head.bias.to(cd))


def define_discriminator(input_channels: int = 12, ndf: int = 64, discriminator: str = "basic",
                         n_layers: int = 3, norm: str = "batch", **kwargs) -> nn.Module:
    """Discriminator by name: ``basic`` (3-layer PatchGAN), ``n_layers``,
    ``pixel``, ``enhanced``. ``input_channels`` is unused: the first conv
    takes its width from the data."""
    del input_channels
    if discriminator == "basic":
        return NLayerDiscriminator(ndf, 3, norm, **kwargs)
    if discriminator == "n_layers":
        return NLayerDiscriminator(ndf, n_layers, norm, **kwargs)
    if discriminator == "pixel":
        return PixelDiscriminator(ndf, norm, **kwargs)
    if discriminator == "enhanced":
        return CloudGANDiscriminator(ndf, norm=norm, **kwargs)
    raise ValueError(f"Discriminator model name {discriminator!r} is not recognized")
