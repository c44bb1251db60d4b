"""PixelCNN, counterpart of ``satflow_tpu/models/pixel_cnn.py``.

An autoregressive masked-convolution image model on the channels-stacked
task: a type-A masked 7x7 conv (flax's ``in``, ``in_`` here: a module name
is an attribute), residual blocks of two type-B
masked 3x3 convs (``b{i}_c0``, ``b{i}_c1``) and a 1x1 head (``out``), NHWC.
A mask is a constant multiplier on the conv kernel (rows above the centre,
and the centre row left of it; B also keeps the centre), so the parameters
are plain conv weights and carry over from flax as they are. As in the JAX
module a masked conv adds its f32 bias after the conv, so its output is
float32 whatever the compute dtype. No kernel: the convs are library calls.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.models.unet_family import StackedImageModel, _ZooCore
from satflow_tpu_torch.nn.conv import Conv


def _causal_mask(kh: int, kw: int, mask_type: str) -> np.ndarray:
    """Spatial causality mask over (kh, kw): rows above and the pixels left
    of the centre (A excludes the centre pixel, B includes it), (kh, kw, 1, 1)."""
    mask = np.zeros((kh, kw, 1, 1), dtype=np.float32)
    ch, cw = kh // 2, kw // 2
    mask[:ch] = 1.0
    mask[ch, :cw] = 1.0
    if mask_type == "B":
        mask[ch, cw] = 1.0
    return mask


class MaskedConv(Conv):
    """A SAME conv whose (O, I, k, k) weight is multiplied by the causal mask
    before every call; ``weight`` and ``bias`` are the flax ``kernel`` and
    ``bias`` (the mask is a non-persistent buffer). The conv runs in the
    compute dtype and the f32 bias is added after it."""

    def __init__(self, in_features: Optional[int], features: int, kernel_size: int = 3,
                 mask_type: str = "B", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, kernel_size, dtype=dtype, generator=generator)
        mask = _causal_mask(kernel_size, kernel_size, mask_type)[..., 0, 0]
        self.register_buffer("mask", torch.from_numpy(mask)[None, None], persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x, self.weight_for(x) * self.mask, with_bias=False)
        return y + self.bias


class PixelCNNCore(_ZooCore):
    def __init__(self, out_channels: int, hidden_channels: int = 64, num_blocks: int = 5,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_blocks = num_blocks
        self.in_ = MaskedConv(None, hidden_channels, 7, "A", generator=generator)
        for i in range(num_blocks):
            for j in range(2):
                self.add_module(f"b{i}_c{j}", MaskedConv(hidden_channels, hidden_channels, 3,
                                                         "B", generator=generator))
        self.out = Conv(hidden_channels, out_channels, 1, generator=generator)
        self.set_compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_(x)
        for i in range(self.num_blocks):
            r = getattr(self, f"b{i}_c0")(F.relu(h))
            r = getattr(self, f"b{i}_c1")(F.relu(r))
            h = h + r
        return self.out(F.relu(h))


@register_model
class PixelCNN(StackedImageModel):
    """The PixelCNN task model."""

    def __init__(
        self,
        forecast_steps: int = 48,
        input_channels: int = 12,
        lr: float = 1e-3,
        loss: str = "mse",
        hidden_channels: int = 64,
        num_blocks: int = 5,
        channels_per_timestep: int = 1,
        pretrained: bool = False,
        visualize: bool = False,
        dtype: Any = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.hidden_channels = hidden_channels
        self.num_blocks = num_blocks
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
        return PixelCNNCore(
            out_channels=self.output_channels,
            hidden_channels=self.hidden_channels,
            num_blocks=self.num_blocks,
            dtype=self.dtype,
            generator=self._generator,
        )
