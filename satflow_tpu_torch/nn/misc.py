"""Tensor helpers, counterpart of ``satflow_tpu/nn/misc.py`` (NHWC / NTHWC)."""

from __future__ import annotations

from typing import Optional

import torch


def compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor) -> torch.dtype:
    """``dtype``, or with None flax's promotion of ``x`` and f32 parameters:
    the input's dtype, at least float32."""
    return dtype or torch.promote_types(x.dtype, torch.float32)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """``b [t] (h dh) (w dw) c -> b [t] h w (dh dw c)`` for 4-D or 5-D input."""
    if x.dim() not in (4, 5):
        raise ValueError(f"space_to_depth expects 4D/5D NHWC input, got shape {tuple(x.shape)}")
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // block, block, w // block, block, c)
    n = len(lead)
    # (..., h, dh, w, dw, c) -> (..., h, w, dh, dw, c)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, h // block, w // block, block * block * c)


def crop_center(x: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    """Center-crop the spatial dims of an (..., H, W, C) tensor."""
    h, w = x.shape[-3], x.shape[-2]
    start_h = (h - crop_h) // 2
    start_w = (w - crop_w) // 2
    return x[..., start_h : start_h + crop_h, start_w : start_w + crop_w, :]


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias=None, padding="same") -> torch.Tensor:
    """2-D conv of an NHWC tensor with an OIHW weight, returning NHWC. The
    NCHW view of an NHWC tensor is channels-last in memory, which cuDNN
    takes as it is; ``"same"`` pads as flax's ``SAME`` does (the extra row
    and column of an even kernel at the end)."""
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=padding)
    return y.permute(0, 2, 3, 1)
