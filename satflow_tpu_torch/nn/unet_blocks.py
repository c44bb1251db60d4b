"""U-Net building blocks (NHWC), counterpart of ``satflow_tpu/nn/unet_blocks.py``.

- :class:`ConvBlock`: [conv3x3 -> BatchNorm -> ReLU] x 2 (``conv0``/``bn0``,
  ``conv1``/``bn1``).
- :class:`UpConv`: nearest x2 upsample -> conv3x3 -> BatchNorm -> ReLU.
- :class:`SingleConv`: conv3x3 -> BatchNorm -> ReLU.
- :class:`RecurrentBlock`: the weight-tied recurrence ``x1 = relu(bn(conv(x +
  x1)))``, the conv applied t + 1 times with one set of weights (t = 2).
- :class:`RRCNNBlock`: 1x1 projection, two recurrent blocks, additive skip.
- :class:`AttentionBlock`: the additive attention gate on a skip,
  ``x · sigmoid(bn(psi(relu(bn(Wg·g) + bn(Wx·x)))))``.

Every conv is of the block's ``conv_type`` ("standard", "coord" or
"antialiased", :func:`~satflow_tpu_torch.nn.conv.get_conv_layer`; a
"standard" one with flax's reading of an int kernel size, see
:func:`_conv`), and each
BatchNorm is the shared flax one (:class:`~satflow_tpu_torch.nn.misc.BatchNorm`).
Submodules carry the flax names, so the flax tree converts leaf by leaf. A
block computes in its ``dtype`` (None: the input's, at least float32): every
conv below it and its BatchNorms' outputs follow it. ``in_features=None``
gives a block whose first conv takes its input width from the data. The
convs, pools and resizes are library calls, as the JAX blocks are plain XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.nn.conv import Conv, DtypedModule, get_conv_layer
from satflow_tpu_torch.nn.misc import BatchNorm, compute_dtype, max_pool


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool (NHWC)."""
    return max_pool(x, 2, 2)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample (NHWC): each pixel repeated 2 x 2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class _Block(DtypedModule):
    """A block whose ``dtype`` every conv below it follows."""

    def _conv_bn_relu(self, conv: nn.Module, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
        y = conv(x)
        return F.relu(bn(y, compute_dtype(self.dtype, y)))


def _conv(conv_type: str, in_features: Optional[int], features: int, kernel_size: int,
          generator: Optional[torch.Generator]) -> nn.Module:
    """The block's conv of ``conv_type`` with an int ``kernel_size``, as the
    JAX blocks build it. The JAX factory returns flax's ``nn.Conv`` itself
    for "standard" (and "3d"), which reads an int kernel size as a 1-D
    kernel: the conv runs along W only, over a (k, I, O) kernel, with (B, H)
    as batch axes. That is a (1, k) conv here, so the flax weights load as
    they are; "coord" and "antialiased" pair the size into k x k, there as
    here."""
    if conv_type in ("standard", "3d"):
        return Conv(in_features, features, (1, kernel_size), padding="SAME",
                    generator=generator)
    return get_conv_layer(conv_type)(in_features, features, kernel_size, padding="SAME",
                                     generator=generator)


class ConvBlock(_Block):
    def __init__(self, in_features: Optional[int], features: int,
                 conv_type: str = "standard", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv0 = _conv(conv_type, in_features, features, 3, generator)
        self.bn0 = BatchNorm(features)
        self.conv1 = _conv(conv_type, features, features, 3, generator)
        self.bn1 = BatchNorm(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._conv_bn_relu(self.conv0, self.bn0, x)
        return self._conv_bn_relu(self.conv1, self.bn1, x)


class UpConv(_Block):
    def __init__(self, in_features: int, features: int, conv_type: str = "standard",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = _conv(conv_type, in_features, features, 3, generator)
        self.bn = BatchNorm(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_bn_relu(self.conv, self.bn, upsample2(x))


class SingleConv(_Block):
    def __init__(self, in_features: Optional[int], features: int,
                 conv_type: str = "standard", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = _conv(conv_type, in_features, features, 3, generator)
        self.bn = BatchNorm(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_bn_relu(self.conv, self.bn, x)


class RecurrentBlock(_Block):
    """Weight-tied conv recurrence: ``x1 = step(x)``, then t times
    ``x1 = step(x + x1)``, ``step`` = conv -> BatchNorm -> ReLU with one
    ``conv`` and one ``bn`` (in training each application moves the running
    statistics once, as in flax)."""

    def __init__(self, features: int, t: int = 2, conv_type: str = "standard",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.t = t
        self.conv = _conv(conv_type, features, features, 3, generator)
        self.bn = BatchNorm(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self._conv_bn_relu(self.conv, self.bn, x)
        for _ in range(self.t):
            x1 = self._conv_bn_relu(self.conv, self.bn, x + x1)
        return x1


class RRCNNBlock(_Block):
    """Recurrent-residual block: 1x1 ``proj``, recurrent blocks ``rec0`` and
    ``rec1``, additive skip from the projection."""

    def __init__(self, in_features: Optional[int], features: int, t: int = 2,
                 conv_type: str = "standard", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = _conv(conv_type, in_features, features, 1, generator)
        self.rec0 = RecurrentBlock(features, t, conv_type, dtype, generator)
        self.rec1 = RecurrentBlock(features, t, conv_type, dtype, generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        return x + self.rec1(self.rec0(x))


class AttentionBlock(_Block):
    """Additive attention gate: psi = sigmoid(bn(conv(relu(bn(Wg·g) +
    bn(Wx·x))))); returns x · psi. ``features`` is F_int; the 1x1 convs are
    ``w_g``, ``w_x`` and ``psi`` (one output channel)."""

    def __init__(self, g_features: int, x_features: int, features: int,
                 conv_type: str = "standard", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_g = _conv(conv_type, g_features, features, 1, generator)
        self.bn_g = BatchNorm(features)
        self.w_x = _conv(conv_type, x_features, features, 1, generator)
        self.bn_x = BatchNorm(features)
        self.psi = _conv(conv_type, features, 1, 1, generator)
        self.bn_psi = BatchNorm(1)
        self.dtype = dtype

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        g1 = self.w_g(g)
        g1 = self.bn_g(g1, compute_dtype(self.dtype, g1))
        x1 = self.w_x(x)
        x1 = self.bn_x(x1, compute_dtype(self.dtype, x1))
        psi = self.psi(F.relu(g1 + x1))
        psi = self.bn_psi(psi, compute_dtype(self.dtype, psi))
        return x * torch.sigmoid(psi)
