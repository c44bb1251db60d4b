"""Convolution primitives, counterpart of ``satflow_tpu/nn/conv.py``: the conv
factory with its four variants, CoordConv and BlurPool (antialiased
downsampling).

Tensors are NHWC in and out, like the port's other modules; the convs are
library convs (the JAX ones are plain XLA). Parameters sit where the flax
modules have theirs: :class:`Conv` is flax's ``nn.Conv`` (``weight`` OIHW for
its HWIO ``kernel``, ``bias``), and :class:`CoordConv` and
:class:`AntialiasedConv` hold theirs one level down, under ``Conv_0``. Each
takes ``in_features=None`` for an input width that comes from the data (a
lazy weight, as flax infers it).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter, is_lazy

from satflow_tpu_torch.nn.misc import compute_dtype, same_padding


def _pair(k: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(k, int):
        return (k, k)
    return tuple(k)  # type: ignore[return-value]


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, rescaled so that
    the variance is 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """flax's ``nn.Conv`` on NHWC tensors: ``weight`` (O, I, kh, kw) and
    ``bias``, padding ``"SAME"``, ``"VALID"`` or an int (pair), an optional
    ``kernel_dilation``, computing in ``dtype`` (None: the input's, at least
    float32).

    ``in_features=None`` makes the weight lazy, as flax infers a kernel's
    input width: it is created (flax's lecun-normal init, drawn on the host
    from ``generator``) from the first input's channels, or takes its shape
    from a state_dict it is loaded from.
    """

    def __init__(self, in_features: Optional[int], features: int,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 strides: Union[int, Sequence[int]] = 1, padding: Union[str, int] = "SAME",
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 kernel_dilation: Union[int, Sequence[int]] = 1):
        super().__init__()
        self.features = features
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.dilation = _pair(kernel_dilation)
        self.padding = padding if isinstance(padding, str) else _pair(padding)
        self.dtype = dtype
        if in_features is None:
            self._generator = generator
            self.weight = UninitializedParameter()
            self.register_load_state_dict_pre_hook(Conv._materialize_from_state)
        else:
            self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel_size))
            lecun_normal_(self.weight, in_features * self.kernel_size[0] * self.kernel_size[1],
                          generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _materialize(self, in_features: int) -> None:
        shape = (self.features, in_features, *self.kernel_size)
        weight = torch.empty(shape)  # on the host: the generator may be a CPU one
        lecun_normal_(weight, weight[0].numel(), self._generator)
        with torch.no_grad():
            self.weight.materialize(shape)
            self.weight.copy_(weight)

    @staticmethod
    def _materialize_from_state(module, state_dict, prefix, *args) -> None:
        """A lazy weight takes its shape from the state_dict it is loaded from."""
        saved = state_dict.get(prefix + "weight")
        if is_lazy(module.weight) and saved is not None and not is_lazy(saved):
            with torch.no_grad():
                module.weight.materialize(saved.shape)

    def weight_for(self, x: torch.Tensor) -> torch.Tensor:
        """The (O, I, kh, kw) weight, created first from ``x``'s channels if lazy."""
        if is_lazy(self.weight):
            self._materialize(x.shape[-1])
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight_for(x))

    def conv(self, x: torch.Tensor, weight: torch.Tensor, with_bias: bool = True) -> torch.Tensor:
        """This conv of NHWC ``x`` with ``weight`` (the parameter, or a masked
        copy of it) and, ``with_bias``, the bias, in the compute dtype."""
        cdtype = compute_dtype(self.dtype, x)
        x = x.to(cdtype).permute(0, 3, 1, 2)
        if self.padding == "SAME" and self.strides == (1, 1) and all(
                k % 2 for k in self.kernel_size):
            # symmetric: the conv's own
            padding = tuple(d * (k // 2) for k, d in zip(self.kernel_size, self.dilation))
        elif self.padding == "SAME":
            x = F.pad(x, same_padding(self.kernel_size, self.strides, x.shape[2], x.shape[3],
                                      self.dilation))
            padding = 0
        elif self.padding == "VALID":
            padding = 0
        else:
            padding = self.padding
        bias = self.bias.to(cdtype) if with_bias and self.bias is not None else None
        y = F.conv2d(x, weight.to(cdtype), bias, stride=self.strides, padding=padding,
                     dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


class DtypedModule(nn.Module):
    """A module whose ``dtype`` (the compute dtype; None: the input's, at
    least float32) every :class:`Conv` below it follows, so that assigning
    ``module.dtype`` re-types the whole module."""

    _dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return self._dtype

    @dtype.setter
    def dtype(self, value: Optional[torch.dtype]) -> None:
        self._dtype = value
        for m in self.modules():
            if isinstance(m, Conv):
                m.dtype = value


class AddCoords(nn.Module):
    """Append normalised x/y (and optionally radius) channels to an NHWC
    tensor: coordinates linspaced over [-1, 1] per spatial dim, in the input's
    dtype; ``with_r`` adds sqrt(x² + y²)."""

    def __init__(self, with_r: bool = False):
        super().__init__()
        self.with_r = with_r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        # linspace in f32 (f64 for f64 input), then rounded to the input's
        # dtype, as jnp.linspace does
        ldtype = torch.promote_types(x.dtype, torch.float32)
        yy = torch.linspace(-1.0, 1.0, h, device=x.device, dtype=ldtype).to(x.dtype)[:, None]
        xx = torch.linspace(-1.0, 1.0, w, device=x.device, dtype=ldtype).to(x.dtype)[None, :]
        yy, xx = yy.expand(h, w), xx.expand(h, w)
        coords = [xx, yy]
        if self.with_r:
            coords.append(torch.sqrt(xx * xx + yy * yy))
        stack = torch.stack(coords, dim=-1)[None].expand(b, h, w, len(coords))
        return torch.cat([x, stack], dim=-1)


class CoordConv(nn.Module):
    """Conv over the input with appended coordinate channels; the conv's
    parameters are under ``Conv_0``."""

    def __init__(self, in_features: Optional[int], features: int,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 strides: Union[int, Sequence[int]] = 1, padding: Union[str, int] = "SAME",
                 use_bias: bool = True, with_r: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.add_coords = AddCoords(with_r)
        extra = 3 if with_r else 2
        self.Conv_0 = Conv(None if in_features is None else in_features + extra, features,
                           kernel_size, strides, padding, use_bias, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(self.add_coords(x))


def _binomial_filter(size: int) -> np.ndarray:
    """1-D binomial (Pascal) filter of the antialiased BlurPool."""
    a = np.poly1d([0.5, 0.5]) ** (size - 1)
    return a.coeffs.astype(np.float32)


class BlurPool(nn.Module):
    """Antialiased downsampling: a fixed binomial blur as a depthwise conv,
    then a strided subsample. No parameters."""

    def __init__(self, filter_size: int = 4, stride: int = 2):
        super().__init__()
        self.filter_size = filter_size
        self.stride = stride
        f1 = _binomial_filter(filter_size)
        f2 = np.outer(f1, f1)
        self.register_buffer("kernel", torch.from_numpy(f2 / f2.sum()), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        kernel = self.kernel.to(x.dtype)[None, None].expand(c, 1, -1, -1)
        pad = (self.filter_size - 1) // 2
        pad_hi = self.filter_size - 1 - pad
        y = F.pad(x.permute(0, 3, 1, 2), (pad, pad_hi, pad, pad_hi))
        return F.conv2d(y, kernel, stride=self.stride, groups=c).permute(0, 2, 3, 1)


class AntialiasedConv(nn.Module):
    """Conv at stride 1 (parameters under ``Conv_0``), then a
    :class:`BlurPool` when a stride is asked for."""

    def __init__(self, in_features: Optional[int], features: int,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 strides: Union[int, Sequence[int]] = 1, padding: Union[str, int] = "SAME",
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        stride = _pair(strides)[0]
        self.Conv_0 = Conv(in_features, features, kernel_size, 1, padding, use_bias, dtype,
                           generator)
        self.blur = BlurPool(stride=stride) if stride > 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        return x if self.blur is None else self.blur(x)


def get_conv_layer(conv_type: str = "standard") -> Callable[..., nn.Module]:
    """The conv factory's four variants: a Module class taking (in_features,
    features, kernel_size, strides, padding, ...). ``"3d"`` is :class:`Conv`
    as well, as the flax factory returns ``nn.Conv`` for it."""
    if conv_type in ("standard", "3d"):
        return Conv
    if conv_type == "coord":
        return CoordConv
    if conv_type == "antialiased":
        return AntialiasedConv
    raise ValueError(f"Unknown conv_type {conv_type!r}")
