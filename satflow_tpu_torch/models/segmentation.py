"""Segmentation-style forecasters, counterpart of ``satflow_tpu/models/segmentation.py``:
FCN and DeepLabV3 heads on ResNet-50 / -101 backbones.

The channels-stacked task of :class:`~satflow_tpu_torch.models.unet_family.StackedImageModel`:
past frames stacked into channels, forecast_steps output channels. The core
runs the backbone (output stride 16: C5 at 1/16 of the input), the head
(:class:`FCNHead`, or :class:`ASPP` then a 1x1 ``out`` conv), then a
bilinear resize back to the input size. ``jax.image.resize(..., "bilinear")``
upsamples with half-pixel centres and renormalises the weights at the edges,
which for an upsampling is ``F.interpolate(mode="bilinear",
align_corners=False)``'s clamped edge (held to the JAX function, edge rows and
columns included, in the tests). No kernel: convs and the resize are
library calls, as the JAX module leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.unet_family import StackedImageModel, _ZooCore
from satflow_tpu_torch.nn.conv import Conv, DtypedModule
from satflow_tpu_torch.nn.misc import BatchNorm, compute_dtype
from satflow_tpu_torch.nn.resnet import ResNetBackbone


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, height, width, C), "bilinear")`` of an NHWC
    tensor, for an upsampling (half-pixel centres, the edge clamped)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


class FCNHead(DtypedModule):
    """3x3 ``c0`` to C/4 (no bias) -> BatchNorm -> ReLU -> 1x1 ``out``."""

    def __init__(self, in_features: int, out_channels: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = Conv(in_features, in_features // 4, 3, use_bias=False, generator=generator)
        self.bn = BatchNorm(in_features // 4)
        self.out = Conv(in_features // 4, out_channels, 1, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c0(x)
        h = F.relu(self.bn(h, compute_dtype(self.dtype, h)))
        return self.out(h)


class ASPP(DtypedModule):
    """Atrous spatial pyramid pooling: a 1x1 branch, a dilated 3x3 branch
    per rate (12, 24, 36), and the image-pooling branch (the spatial mean, a
    1x1 conv, BatchNorm over the B pooled values, broadcast back), each
    -> BatchNorm -> ReLU; concatenated, projected 1x1 -> BatchNorm -> ReLU."""

    def __init__(self, in_features: int, features: int = 256, rates: tuple = (12, 24, 36),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.rates = tuple(rates)
        self.c_1x1 = Conv(in_features, features, 1, use_bias=False, generator=generator)
        self.bn_1x1 = BatchNorm(features)
        for rate in self.rates:
            self.add_module(f"c_r{rate}", Conv(in_features, features, 3, use_bias=False,
                                               generator=generator, kernel_dilation=rate))
            self.add_module(f"bn_r{rate}", BatchNorm(features))
        self.c_pool = Conv(in_features, features, 1, use_bias=False, generator=generator)
        self.bn_pool = BatchNorm(features)
        self.proj = Conv(features * (len(self.rates) + 2), features, 1, use_bias=False,
                         generator=generator)
        self.bn_proj = BatchNorm(features)
        self.dtype = dtype

    def _bn_relu(self, bn: BatchNorm, h: torch.Tensor) -> torch.Tensor:
        return F.relu(bn(h, compute_dtype(self.dtype, h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self._bn_relu(self.bn_1x1, self.c_1x1(x))]
        for rate in self.rates:
            branches.append(self._bn_relu(getattr(self, f"bn_r{rate}"),
                                          getattr(self, f"c_r{rate}")(x)))
        pooled = self._bn_relu(self.bn_pool, self.c_pool(x.mean(dim=(1, 2), keepdim=True)))
        branches.append(pooled.expand(x.shape[0], x.shape[1], x.shape[2], self.features))
        return self._bn_relu(self.bn_proj, self.proj(torch.cat(branches, dim=-1)))


class SegmentationCore(_ZooCore):
    """backbone -> head -> bilinear resize to the input's H and W."""

    def __init__(self, out_channels: int, backbone: str = "resnet50", head: str = "fcn",
                 output_stride: int = 16, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.head_name = head
        stages = (3, 4, 6, 3) if backbone == "resnet50" else (3, 4, 23, 3)
        self.backbone = ResNetBackbone(stages, output_stride=output_stride, generator=generator)
        c5 = self.backbone.out_features
        if head == "aspp":
            self.aspp = ASPP(c5, generator=generator)
            self.out = Conv(self.aspp.features, out_channels, 1, generator=generator)
        else:
            self.head = FCNHead(c5, out_channels, generator=generator)
        self.set_compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5, _ = self.backbone(x)
        h = self.out(self.aspp(c5)) if self.head_name == "aspp" else self.head(c5)
        return resize_bilinear(h, x.shape[1], x.shape[2])


class _SegModelBase(StackedImageModel):
    backbone_name = "resnet50"
    head_name = "fcn"

    def __init__(
        self,
        forecast_steps: int = 48,
        input_channels: int = 12,
        lr: float = 1e-3,
        backbone: str = None,  # type: ignore[assignment]
        loss: str = "mse",
        channels_per_timestep: int = 1,
        pretrained: bool = False,
        visualize: bool = False,
        dtype: Any = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.backbone = backbone or self.backbone_name
        super().__init__(
            input_channels=input_channels,
            forecast_steps=forecast_steps,
            channels_per_timestep=channels_per_timestep,
            lr=lr,
            loss=loss,
            visualize=visualize,
            pretrained=pretrained,
            dtype=dtype,
            generator=generator,
        )

    def build_module(self) -> nn.Module:
        return SegmentationCore(
            out_channels=self.output_channels,
            backbone=self.backbone,
            head=self.head_name,
            dtype=self.dtype,
            generator=self._generator,
        )


@register_model
class FCN(_SegModelBase):
    """The FCN task model (``fcn_r50.yaml``, ``fcn_r101.yaml``)."""

    head_name = "fcn"


@register_model
class DeeplabV3(_SegModelBase):
    """The DeepLabV3 task model (``deeplabv3_r50.yaml``, ``deeplabv3_r101.yaml``)."""

    head_name = "aspp"
