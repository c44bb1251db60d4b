"""SSIM and MS-SSIM, counterpart of ``satflow_tpu/ops/ssim.py``.

Channel-aware, with the nonnegative option and the range conversion of the
JAX module. Inputs are NHWC, or NTHWC with the time axis folded into the
batch. The Gaussian window is applied as two separable 1-D depthwise
convolutions (``F.conv2d(groups=C)`` on an NCHW view, VALID), as the JAX
module applies two depthwise XLA convs; every statistic is in float32
whatever the input dtype, which keeps the variance subtraction stable in
bf16 training.

On a CUDA card these float32 convs run with TF32 off, forward and backward
(:class:`_DepthwiseConv`): cuDNN's default ``allow_tf32`` rounds the inputs
to 10 mantissa bits, which costs the variance subtraction ``E[x²] - E[x]²``
about 1e-3.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Standard MS-SSIM level weights (Wang et al. 2003).
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@contextlib.contextmanager
def no_tf32():
    """cuDNN convs in full float32 inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _DepthwiseConv(torch.autograd.Function):
    """VALID depthwise ``conv2d`` of an NCHW input with a constant weight
    (C, 1, kh, kw); its backward (the input's gradient) is a conv too, and
    both run with TF32 off."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(weight)
        ctx.in_shape = x.shape
        with no_tf32():
            return F.conv2d(x, weight, groups=x.shape[1])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (weight,) = ctx.saved_tensors
        with no_tf32():
            dx = torch.nn.grad.conv2d_input(ctx.in_shape, weight, grad, groups=weight.shape[0])
        return dx, None


def _depthwise_blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian filter over NHWC, VALID padding."""
    c = x.shape[-1]
    k = window.shape[0]
    kh = window.reshape(1, 1, k, 1).expand(c, 1, k, 1).contiguous()
    kw = window.reshape(1, 1, 1, k).expand(c, 1, 1, k).contiguous()
    y = _DepthwiseConv.apply(x.permute(0, 3, 1, 2), kh)
    return _DepthwiseConv.apply(y, kw).permute(0, 2, 3, 1)


def convert_range(
    x: torch.Tensor, current: Tuple[float, float] = (-1.0, 1.0),
    new: Tuple[float, float] = (0.0, 1.0),
) -> torch.Tensor:
    """Affine range remap (the loss registry's ``convert_range``), in the
    input's dtype."""
    lo, hi = current
    nlo, nhi = new
    return (x - lo) / (hi - lo) * (nhi - nlo) + nlo


def _ssim_components(
    x: torch.Tensor,
    y: torch.Tensor,
    window: torch.Tensor,
    data_range: float,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel SSIM map and contrast-structure (cs) map over NHWC inputs."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    x = x.float()
    y = y.float()
    mu_x = _depthwise_blur(x, window)
    mu_y = _depthwise_blur(y, window)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _depthwise_blur(x * x, window) - mu_xx
    sigma_yy = _depthwise_blur(y * y, window) - mu_yy
    sigma_xy = _depthwise_blur(x * y, window) - mu_xy
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map, cs


def _window(win_size: int, win_sigma: float, device) -> torch.Tensor:
    return torch.from_numpy(_gaussian_kernel1d(win_size, win_sigma)).to(device)


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    nonnegative: bool = False,
    per_channel: bool = False,
) -> torch.Tensor:
    """Mean SSIM between NHWC batches (NTHWC: time folded into the batch);
    ``per_channel`` gives one value per channel (C,)."""
    ssim_map = _ssim_map(_flatten_video(x), _flatten_video(y), data_range, win_size, win_sigma,
                         nonnegative)
    if per_channel:
        return torch.mean(ssim_map, dim=(0, 1, 2))
    return torch.mean(ssim_map)


def _ssim_map(x, y, data_range, win_size, win_sigma, nonnegative) -> torch.Tensor:
    """The SSIM map (N, H', W', C) of NHWC batches."""
    win_size = _clamp_win(win_size, min(x.shape[1], x.shape[2]))
    ssim_map, _ = _ssim_components(x, y, _window(win_size, win_sigma, x.device), data_range)
    return torch.relu(ssim_map) if nonnegative else ssim_map


def ms_ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    weights: Sequence[float] = _MSSSIM_WEIGHTS,
    per_channel: bool = False,
) -> torch.Tensor:
    """Multi-scale SSIM (up to 5 dyadic scales, Wang et al. weights) over
    NHWC batches.

    The levels are cut to ``floor(log2(min_dim / win)) + 1`` so that the
    smallest scale still fits the window, with the weights renormalised.
    Each level's per-sample (and per-channel) mean is ReLU'd; the weighted
    geometric product is taken per sample and the batch mean last.
    """
    per_sample = _ms_ssim_per_sample(_flatten_video(x), _flatten_video(y), data_range, win_size,
                                     win_sigma, weights)
    if per_channel:
        return torch.mean(per_sample, dim=0)
    return torch.mean(per_sample)


def _ms_ssim_per_sample(x, y, data_range, win_size, win_sigma, weights) -> torch.Tensor:
    """MS-SSIM of each sample and channel (N, C) of NHWC batches."""
    min_dim = min(x.shape[1], x.shape[2])
    win_size = _clamp_win(win_size, min_dim)
    window = _window(win_size, win_sigma, x.device)
    max_levels = max(1, int(np.floor(np.log2(min_dim / win_size))) + 1)
    weights = tuple(weights)[: min(len(weights), max_levels)]
    levels = len(weights)
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    w = w / torch.sum(w)

    vals = []
    for i in range(levels):
        ssim_map, cs_map = _ssim_components(x, y, window, data_range)
        if i < levels - 1:
            vals.append(torch.relu(torch.mean(cs_map, dim=(1, 2))))  # (N, C)
            x = _avg_pool2(x)
            y = _avg_pool2(y)
        else:
            vals.append(torch.relu(torch.mean(ssim_map, dim=(1, 2))))
    stack = torch.stack(vals)  # (levels, N, C)
    return torch.prod(stack ** w[:, None, None], dim=0)  # (N, C)


def ssim_frames(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0, win_size: int = 11,
                win_sigma: float = 1.5, nonnegative: bool = False) -> torch.Tensor:
    """:func:`ssim` of each frame of (B, T, H, W, C) batches, (T,): one pass
    over all B·T images where a loop would call :func:`ssim` T times (the JAX
    package's ``vmap`` over the time axis)."""
    b, t = x.shape[:2]
    ssim_map = _ssim_map(_flatten_video(x), _flatten_video(y), data_range, win_size, win_sigma,
                         nonnegative)
    return torch.mean(ssim_map.reshape(b, t, -1), dim=(0, 2))


def ms_ssim_frames(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
                   win_size: int = 11, win_sigma: float = 1.5,
                   weights: Sequence[float] = _MSSSIM_WEIGHTS) -> torch.Tensor:
    """:func:`ms_ssim` of each frame of (B, T, H, W, C) batches, (T,), in one
    pass over all B·T images."""
    b, t = x.shape[:2]
    per_sample = _ms_ssim_per_sample(_flatten_video(x), _flatten_video(y), data_range, win_size,
                                     win_sigma, weights)
    return torch.mean(per_sample.reshape(b, t, -1), dim=(0, 2))


def _clamp_win(win_size: int, min_dim: int) -> int:
    """Clamp the Gaussian window to the image, odd and >= 1: an 11-wide VALID
    blur on a smaller image yields an empty map whose mean is NaN (MetNet's
    small output grids)."""
    w = min(win_size, min_dim)
    if w % 2 == 0:
        w -= 1
    return max(w, 1)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean over NHWC, VALID: an odd size is floored."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _flatten_video(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B·T, H, W, C); 4D passes through."""
    if x.dim() == 5:
        return x.reshape(-1, *x.shape[2:])
    if x.dim() == 4:
        return x
    raise ValueError(f"ssim expects NHWC or NTHWC input, got shape {tuple(x.shape)}")
