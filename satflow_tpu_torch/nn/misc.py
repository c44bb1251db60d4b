"""Tensor helpers, counterpart of ``satflow_tpu/nn/misc.py`` (NHWC / NTHWC):
lead-time conditioning (:func:`condition_time`, :class:`ConditionTime`),
space-to-depth and its inverse, center crop, the per-timestep wrappers
``time_distributed`` / :class:`TimeDistributed`, the dtype-following base
:class:`DtypedModule`, and the flax layers the port's models share that
torch has no exact match for: :class:`BatchNorm`, :class:`LayerNorm` and
:func:`max_pool` (flax's ``SAME`` padding, -inf in the padded cells).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor) -> torch.dtype:
    """``dtype``, or with None flax's promotion of ``x`` and f32 parameters:
    the input's dtype, at least float32."""
    return dtype or torch.promote_types(x.dtype, torch.float32)


class DtypedModule(nn.Module):
    """A module with a compute ``dtype`` (None: the input's, at least
    float32) that every :class:`DtypedModule` below it follows, so that
    assigning ``module.dtype`` re-types the whole module."""

    _dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return self._dtype

    @dtype.setter
    def dtype(self, value: Optional[torch.dtype]) -> None:
        for m in self.modules():
            if isinstance(m, DtypedModule):
                m._dtype = value

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in ``dtype`` from now on (None: flax's promotion), the f32
        weights kept as they are."""
        self.dtype = dtype


def condition_time(x: torch.Tensor, fstep: int, horizon: int) -> torch.Tensor:
    """``x`` (B, [T,] H, W, C) with ``horizon`` one-hot channels appended that
    mark lead time ``fstep``, in ``x``'s dtype."""
    one_hot = torch.zeros(horizon, dtype=x.dtype, device=x.device)
    if 0 <= fstep < horizon:  # jax.nn.one_hot of an index out of range is all zeros
        one_hot[fstep] = 1
    return torch.cat([x, one_hot.expand(*x.shape[:-1], horizon)], dim=-1)


class ConditionTime(nn.Module):
    """Module form of :func:`condition_time`."""

    def __init__(self, horizon: int):
        super().__init__()
        self.horizon = horizon

    def forward(self, x: torch.Tensor, fstep: int = 0) -> torch.Tensor:
        return condition_time(x, fstep, self.horizon)


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


def reverse_space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """``b [t] h w (dh dw c) -> b [t] (h dh) (w dw) c`` for 4-D or 5-D input:
    the inverse of :func:`space_to_depth`."""
    if x.dim() not in (4, 5):
        raise ValueError(
            f"reverse_space_to_depth expects 4D/5D input, got shape {tuple(x.shape)}")
    *lead, h, w, c = x.shape
    c //= block * block
    x = x.reshape(*lead, h, w, block, block, c)
    n = len(lead)
    # (..., h, w, dh, dw, c) -> (..., h, dh, w, dw, c)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, h * block, w * block, c)


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


def time_distributed(fn: Callable, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """Apply ``fn`` per timestep of a (B, T, ...) tensor by folding T into
    the batch: one reshape in, one reshape out."""
    b, t = x.shape[:2]
    y = fn(x.reshape(b * t, *x.shape[2:]), *args, **kwargs)
    return y.reshape(b, t, *y.shape[1:])


class TimeDistributed(nn.Module):
    """Wraps a module to apply it independently per timestep (T folded into
    the batch); its parameters are the wrapped module's, under ``module``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return time_distributed(self.module, x, *args, **kwargs)


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the channels of an NHWC tensor.

    Training: normalise with the batch's f32 mean and biased variance and
    move the running statistics by flax's rule, ``ra = momentum·ra + (1 -
    momentum)·batch`` with momentum 0.99; ``torch.nn.BatchNorm2d`` would keep
    the unbiased variance and the other momentum convention. The variance is
    taken as E[(x - E[x])²]: flax's E[x²] - E[x]² is the same value up to f32
    rounding, but its gradient, the difference of two nearly equal terms,
    loses most of its digits in f32 where a channel's mean is large against
    its spread. Under a process group whose ``data`` axis holds more than one
    rank, the statistics are the global batch's, as GSPMD gives them in JAX
    (:func:`_batch_moments`). Eval: normalise with the running statistics. The
    normalisation is f32, rounded to ``dtype`` (the caller's compute dtype).
    Parameters and buffers carry flax's names: ``scale``, ``bias`` (absent
    with ``use_scale`` / ``use_bias`` False, as in flax) and the
    ``batch_stats`` ``mean``, ``var``. ``state_frozen`` (set by
    :func:`~satflow_tpu_torch.nn.norm.frozen_state`) keeps the running
    statistics where they are in training mode: flax's ``batch_stats``
    applied without being mutable.
    """

    state_frozen = False

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5,
                 use_scale: bool = True, use_bias: bool = True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, var = _batch_moments(xf, tuple(range(x.dim() - 1)))
            if not self.state_frozen:
                with torch.no_grad():
                    self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                    self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (xf - mean) * mul
        return (y if self.bias is None else y + self.bias).to(dtype)


def _batch_moments(xf: torch.Tensor, dims: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over ``dims``: this process's batch, or
    under a ``data`` group of more than one rank the global batch's, in two
    differentiable all-reduces over the group (the sums with the count, then
    the squared deviations from the global mean)."""
    from satflow_tpu_torch.parallel.mesh import data_group

    group = data_group()
    if group is None:
        mean = xf.mean(dim=dims)
        return mean, torch.square(xf - mean).mean(dim=dims)
    from satflow_tpu_torch.parallel.distributed import all_reduce_sum

    count = xf.new_tensor([float(np.prod([xf.shape[d] for d in dims]))])
    sums = all_reduce_sum(torch.cat([xf.sum(dim=dims), count]), group)
    mean = sums[:-1] / sums[-1]
    var = all_reduce_sum(torch.square(xf - mean).sum(dim=dims), group) / sums[-1]
    return mean, var


def same_padding(kernel: Sequence[int], strides: Sequence[int], sizes: Sequence[int],
                 dilation: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """flax's ``SAME`` over spatial axes of ``sizes`` as F.pad's (before,
    after) pairs, last axis first: the output is ceil(size / stride), and an
    odd total puts the extra element last (a dilated kernel counts as its
    spread, (k - 1)·d + 1)."""
    dilation = dilation or (1,) * len(sizes)
    pads = []
    for size, k, s, d in reversed(list(zip(sizes, kernel, strides, dilation))):
        total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class LayerNorm(DtypedModule):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (torch's
    default is 1e-5), f32 statistics and normalisation (float64 for a
    float64 input), ``scale`` and
    ``bias`` under flax's names, the result in the compute dtype."""

    def __init__(self, features: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(f), (x.shape[-1],), self.scale.to(f), self.bias.to(f), self.eps)
        return y.to(compute_dtype(self.dtype, x))


def max_pool(x: torch.Tensor, window: Union[int, Sequence[int]],
             strides: Union[int, Sequence[int], None] = None,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool`` of an NHWC tensor: ``"VALID"``, or ``"SAME"``
    padded as flax pads (the extra row and column last) with -inf, which
    ``F.max_pool2d``'s symmetric padding is not."""
    window = (window, window) if isinstance(window, int) else tuple(window)
    strides = window if strides is None else (
        (strides, strides) if isinstance(strides, int) else tuple(strides))
    y = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        y = F.pad(y, same_padding(window, strides, y.shape[2:]),
                  value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return F.max_pool2d(y, window, strides).permute(0, 2, 3, 1)
