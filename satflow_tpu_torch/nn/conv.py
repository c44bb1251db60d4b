"""Convolution primitives, counterpart of ``satflow_tpu/nn/conv.py``: the conv
factory with its four variants, CoordConv, BlurPool (antialiased
downsampling) and flax's ``ConvTranspose``.

Tensors are NHWC in and out, like the port's other modules; the convs are
library convs (the JAX ones are plain XLA). Parameters sit where the flax
modules have theirs: :class:`Conv` is flax's ``nn.Conv`` (``weight`` OIHW,
or OIDHW for a 3-D kernel, for its HWIO ``kernel``, ``bias``), and
:class:`CoordConv` and :class:`AntialiasedConv` hold theirs one level down,
under ``Conv_0``. Each takes ``in_features=None`` for an input width that
comes from the data (:class:`LazyWeight`, as flax infers it).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter, is_lazy

from satflow_tpu_torch.nn.misc import DtypedModule, compute_dtype, same_padding


def _pair(k: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(k, int):
        return (k, k)
    return tuple(k)  # type: ignore[return-value]


def _ntuple(k: Union[int, Sequence[int]], n: int) -> Tuple[int, ...]:
    return (k,) * n if isinstance(k, int) else tuple(k)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, rescaled so that
    the variance is 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class LazyWeight(DtypedModule):
    """A layer with a ``weight`` (O, I, ...) and an optional ``bias`` (O,),
    drawn as flax draws a kernel (lecun-normal, fan-in ``weight[0].numel()``,
    on the host from ``generator``; the bias zeros).

    ``in_features=None`` makes both lazy, as flax infers a kernel's input
    width: they are created from the first input's channels (its last
    axis), or take their shapes from a state_dict they are loaded from.
    Until then neither is saved nor reported missing, as flax's tree has no
    such leaves before the module has seen an input."""

    def _weight_shape(self, in_features: int) -> Tuple[int, ...]:
        raise NotImplementedError

    def _make_weight(self, in_features: Optional[int], features: int, use_bias: bool,
                     generator: Optional[torch.Generator]) -> None:
        self.features = features
        self._generator = generator
        if in_features is None:
            self.weight = UninitializedParameter()
            self.bias = UninitializedParameter() if use_bias else None
        else:
            self.weight = nn.Parameter(torch.empty(self._weight_shape(in_features)))
            lecun_normal_(self.weight, self.weight[0].numel(), generator)
            self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _materialize(self, shape: Tuple[int, ...]) -> None:
        with torch.no_grad():
            self.weight.materialize(shape)
            if self.bias is not None:
                self.bias.materialize((self.features,))

    def weight_for(self, x: torch.Tensor) -> torch.Tensor:
        """The weight, created first from ``x``'s channels if lazy."""
        if is_lazy(self.weight):
            weight = torch.empty(self._weight_shape(x.shape[-1]))  # on the host
            lecun_normal_(weight, weight[0].numel(), self._generator)
            self._materialize(weight.shape)
            with torch.no_grad():
                self.weight.copy_(weight)
                if self.bias is not None:
                    self.bias.zero_()
        elif x.shape[-1] != self.weight.shape[1]:
            # a shared module whose weight was made from another input's channels
            raise ValueError(
                f"{type(self).__name__} weight {tuple(self.weight.shape)} was made for "
                f"{self.weight.shape[1]} input channels, got an input of shape "
                f"{tuple(x.shape)} (as flax's ScopeParamShapeError)")
        return self.weight

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        if not is_lazy(self.weight):
            super()._save_to_state_dict(destination, prefix, keep_vars)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        if is_lazy(self.weight):
            saved = state_dict.get(prefix + "weight")
            if saved is None:
                return  # never created: nothing to load, nothing missing
            self._materialize(saved.shape)
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)


class Conv(LazyWeight):
    """flax's ``nn.Conv`` over the N spatial axes of a channels-last tensor
    (N = 2, or 3 for a 3-tuple ``kernel_size``): ``weight`` (O, I, *k) for
    its (*k, I, O) ``kernel``, and ``bias``; padding ``"SAME"``, ``"VALID"``
    or an int, an optional ``kernel_dilation``, computing in ``dtype``
    (None: the input's, at least float32). ``in_features=None`` makes the
    weight lazy (:class:`LazyWeight`)."""

    def __init__(self, in_features: Optional[int], features: int,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 strides: Union[int, Sequence[int]] = 1, padding: Union[str, int] = "SAME",
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 kernel_dilation: Union[int, Sequence[int]] = 1):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        n = len(self.kernel_size)
        if n not in (2, 3):
            raise ValueError(f"Conv takes a 2-D or 3-D kernel, got {self.kernel_size}")
        self.strides = _ntuple(strides, n)
        self.dilation = _ntuple(kernel_dilation, n)
        self.padding = padding if isinstance(padding, str) else _ntuple(padding, n)
        self.dtype = dtype
        self._make_weight(in_features, features, use_bias, generator)

    def _weight_shape(self, in_features: int) -> Tuple[int, ...]:
        return (self.features, in_features, *self.kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight_for(x))

    def conv(self, x: torch.Tensor, weight: torch.Tensor, with_bias: bool = True) -> torch.Tensor:
        """This conv of channels-last ``x`` with ``weight`` (the parameter,
        or a masked copy of it) and, ``with_bias``, the bias, in the compute
        dtype."""
        cdtype = compute_dtype(self.dtype, x)
        x = x.to(cdtype).movedim(-1, 1)
        if self.padding == "SAME" and all(s == 1 for s in self.strides) and all(
                k % 2 for k in self.kernel_size):
            # symmetric: the conv's own
            padding = tuple(d * (k // 2) for k, d in zip(self.kernel_size, self.dilation))
        elif self.padding == "SAME":
            x = F.pad(x, same_padding(self.kernel_size, self.strides, x.shape[2:],
                                      self.dilation))
            padding = 0
        elif self.padding == "VALID":
            padding = 0
        else:
            padding = self.padding
        bias = self.bias.to(cdtype) if with_bias and self.bias is not None else None
        conv = F.conv2d if len(self.kernel_size) == 2 else F.conv3d
        y = conv(x, weight.to(cdtype), bias, stride=self.strides, padding=padding,
                 dilation=self.dilation)
        return y.movedim(1, -1)


class ConvTranspose(DtypedModule):
    """flax ``nn.ConvTranspose`` (2-D, padding ``SAME``, the kernel not
    flipped): ``weight`` (O, I, kh, kw) for its (kh, kw, I, O) ``kernel``,
    as a :class:`~satflow_tpu_torch.nn.conv.Conv` holds its own, and
    ``bias``. ``F.conv_transpose2d`` correlates the stride-dilated input
    with the flipped (I, O, kh, kw) weight, so the weight is flipped and its
    two channel axes swapped here; the padding and output padding are
    derived from ``lax.conv_transpose``'s ``SAME`` pads (an end pad short of
    the start one crops the output's end)."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int], use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel_size))
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.padding, self.output_padding = [], []
        for k, s in zip(self.kernel_size, self.strides):
            # lax.conv_transpose's SAME: (pad_a, pad_b) of the dilated input
            pad_len = k + s - 2
            pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
            pad_b = pad_len - pad_a
            p, op = k - 1 - pad_a, pad_b - pad_a
            if p < 0 or op >= s:
                raise ValueError(f"ConvTranspose kernel {k} stride {s}: SAME padding has "
                                 f"no conv_transpose2d form")
            self.padding.append(p)
            self.output_padding.append(op)  # < 0: that many cropped at the end
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype(self.dtype, x)
        w = self.weight.to(cd).transpose(0, 1).flip(2, 3)  # (I, O, kh, kw)
        b = None if self.bias is None else self.bias.to(cd)
        y = F.conv_transpose2d(x.to(cd).movedim(-1, 1), w, b, stride=self.strides,
                               padding=self.padding,
                               output_padding=[max(op, 0) for op in self.output_padding])
        crop = [min(op, 0) for op in self.output_padding]
        if any(crop):  # flax's end pad is short of the start one (k = 3, stride 2)
            y = y[..., : y.shape[2] + crop[0], : y.shape[3] + crop[1]]
        return y.movedim(1, -1)


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
