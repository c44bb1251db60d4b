"""ResNet backbones (50/101) for the segmentation heads, counterpart of
``satflow_tpu/nn/resnet.py``.

Bottleneck ResNet-v1, NHWC, with optional dilation of the later stages
(DeepLab's output stride 8 / 16). The strided convs and the stem's max-pool
pad as flax's ``SAME`` does (the extra row and column last: the 7x7 stride-2
stem pads 2 before and 3 after at an even size, a 3x3 stride-2 conv 0 and 1,
the pool with -inf), which torch's symmetric ``padding=`` does not; the
port's :class:`~satflow_tpu_torch.nn.conv.Conv` and
:func:`~satflow_tpu_torch.nn.misc.max_pool` pad that way. Submodules carry
the flax names (``stem``, ``stem_bn``, ``stage{i}_block{b}.{c0,c1,c2,proj}``
and their ``bn*``). Convs and pools are library calls, as in the JAX module.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from satflow_tpu_torch.nn.conv import Conv, DtypedModule
from satflow_tpu_torch.nn.misc import BatchNorm, compute_dtype, max_pool


class Bottleneck(DtypedModule):
    """1x1 ``c0`` -> 3x3 ``c1`` (strided, dilated) -> 1x1 ``c2`` to 4x the
    features, each with its BatchNorm; a strided 1x1 ``proj`` on the skip
    when ``project``."""

    def __init__(self, in_features: int, features: int, strides: int = 1, dilation: int = 1,
                 project: bool = False, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = Conv(in_features, features, 1, use_bias=False, generator=generator)
        self.bn0 = BatchNorm(features)
        self.c1 = Conv(features, features, 3, strides=strides, use_bias=False,
                       generator=generator, kernel_dilation=dilation)
        self.bn1 = BatchNorm(features)
        self.c2 = Conv(features, features * 4, 1, use_bias=False, generator=generator)
        self.bn2 = BatchNorm(features * 4)
        if project:
            self.proj = Conv(in_features, features * 4, 1, strides=strides, use_bias=False,
                             generator=generator)
            self.bn_proj = BatchNorm(features * 4)
        else:
            self.proj = None
        self.dtype = dtype

    def _bn(self, bn: BatchNorm, y: torch.Tensor) -> torch.Tensor:
        return bn(y, compute_dtype(self.dtype, y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self._bn(self.bn0, self.c0(x)))
        h = F.relu(self._bn(self.bn1, self.c1(h)))
        h = self._bn(self.bn2, self.c2(h))
        residual = x if self.proj is None else self._bn(self.bn_proj, self.proj(x))
        return F.relu(h + residual)


class ResNetBackbone(DtypedModule):
    """ResNet-50/101 body: returns (C5, C4), the last stage's feature map and
    the one before it. ``output_stride`` < 32 dilates the stages after the
    stride is reached instead of striding them. ``in_features=None`` takes
    the stem's input width from the data."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_stride: int = 16, dtype: Optional[torch.dtype] = None,
                 in_features: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stem = Conv(in_features, width, 7, strides=2, use_bias=False, generator=generator)
        self.stem_bn = BatchNorm(width)
        current_stride, dilation, cin = 4, 1, width
        for i, blocks in enumerate(self.stage_sizes):
            features = width * (2**i)
            if i == 0:
                stride = 1
            elif current_stride >= output_stride:
                stride = 1
                dilation *= 2
            else:
                stride = 2
                current_stride *= 2
            for b in range(blocks):
                self.add_module(f"stage{i}_block{b}", Bottleneck(
                    cin, features, strides=stride if b == 0 else 1, dilation=dilation,
                    project=(b == 0), dtype=dtype, generator=generator))
                cin = features * 4
        self.out_features = cin
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.stem(x)
        h = F.relu(self.stem_bn(h, compute_dtype(self.dtype, h)))
        h = max_pool(h, 3, 2, padding="SAME")
        c4 = h
        for i, blocks in enumerate(self.stage_sizes):
            for b in range(blocks):
                h = getattr(self, f"stage{i}_block{b}")(h)
            if i == len(self.stage_sizes) - 2:
                c4 = h
        return h, c4


def resnet50(output_stride: int = 16, dtype=None, **kwargs) -> ResNetBackbone:
    return ResNetBackbone((3, 4, 6, 3), output_stride=output_stride, dtype=dtype, **kwargs)


def resnet101(output_stride: int = 16, dtype=None, **kwargs) -> ResNetBackbone:
    return ResNetBackbone((3, 4, 23, 3), output_stride=output_stride, dtype=dtype, **kwargs)
