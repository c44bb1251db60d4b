"""Axial attention layers, counterpart of ``satflow_tpu/nn/attention.py``.

:class:`AxialAttentionBlock` is the pre-LN axial transformer block of the
MetNet aggregator: attention along each given axis, then an MLP, each with a
residual. Every attention goes through
:func:`satflow_tpu_torch.ops.axial_attention.axial_attention` (kernel K4 on
the card). The parameters keep flax's names; the weight bridge reshapes the
DenseGeneral kernels, (C, heads, d) and (heads, d, C), into ``nn.Linear``
weights.

flax's defaults are kept where torch's differ: LayerNorm's epsilon is 1e-6
and ``gelu`` is the tanh approximation. The compute dtype of each layer is
``dtype``, or with None what flax promotes to: the input's, at least
float32. A LayerNorm computes its statistics and its normalisation in f32 and
rounds to that dtype, as flax does.

The GAN attentions (:class:`SAGANAttention2d`, :class:`SelfAttention3d`,
:class:`SeparableAttention` with its :class:`_GatedAxialCell`) are the JAX
einsums as matmuls and a softmax in f32, with k and v max-pooled and a
``gamma`` residual gate that starts at 0. Their 1x1 projections are
:class:`~satflow_tpu_torch.nn.conv.Conv` layers named ``query``, ``key``,
``value``. They do not go through K4: the JAX layers do not reach
``_axis_attention`` either.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import UninitializedParameter

from satflow_tpu_torch.nn.conv import Conv
from satflow_tpu_torch.nn.misc import DtypedModule, compute_dtype, max_pool
from satflow_tpu_torch.nn.recurrent import lecun_normal_
from satflow_tpu_torch.ops.axial_attention import axial_attention


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (its f32 weights cast per call)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm``: f32 statistics and normalisation, then ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(dtype)


def _axis_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention: Callable = axial_attention) -> torch.Tensor:
    """Multi-head attention along the -2 axis of (..., heads, L, d) tensors,
    the batch dims folded into one for ``attention``."""
    lead = q.shape[:-2]
    length, d = q.shape[-2:]
    out = attention(q.reshape(-1, length, d), k.reshape(-1, k.shape[-2], d),
                    v.reshape(-1, v.shape[-2], d))
    return out.reshape(*lead, length, d)


class AxialSelfAttention(LazyModuleMixin, nn.Module):
    """Multi-head self-attention along one axis of an NHWC/NTHWC tensor.

    ``pos_emb`` (L, C), the learned positional embedding of the attended
    axis, takes its length from the first input (or from a state_dict), as
    flax infers it; the projections ``q``, ``k``, ``v`` and ``out`` are
    ``nn.Linear`` layers over the channel width ``features``.
    """

    cls_to_become = None  # stays this class once ``pos_emb`` exists

    def __init__(self, features: int, heads: int = 4, axis: int = -2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        self.axis = axis
        self.dtype = dtype
        self._generator = generator
        self.pos_emb = UninitializedParameter()
        self.q = nn.Linear(features, features)
        self.k = nn.Linear(features, features)
        self.v = nn.Linear(features, features)
        self.out = nn.Linear(features, features)
        for layer in (self.q, self.k, self.v, self.out):
            _lecun_dense_(layer, generator)

    def _axis(self, x: torch.Tensor) -> int:
        axis = self.axis if self.axis >= 0 else self.axis + x.dim()
        if axis >= x.dim() - 1:
            raise ValueError(f"axis {self.axis} resolves to the channel axis of shape {tuple(x.shape)}")
        return axis

    def initialize_parameters(self, x: torch.Tensor, *args, **kwargs) -> None:  # noqa: ARG002
        if self.has_uninitialized_params():
            shape = (x.shape[self._axis(x)], x.shape[-1])
            with torch.no_grad():
                self.pos_emb.materialize(shape)
                self.pos_emb.copy_(torch.randn(shape, generator=self._generator) * 0.02)

    def forward(self, x: torch.Tensor, attention: Callable = axial_attention) -> torch.Tensor:
        axis = self._axis(x)
        cdtype = compute_dtype(self.dtype, x)
        xm = torch.movedim(x, axis, -2)  # (..., L, C)
        xp = xm + self.pos_emb.to(xm.dtype)

        def heads(layer):  # (..., L, h*d) -> (..., h, L, d)
            y = dense(layer, xp, cdtype)
            return y.reshape(*y.shape[:-1], self.heads, -1).transpose(-3, -2)

        out = _axis_attention(heads(self.q), heads(self.k), heads(self.v), attention)
        out = out.transpose(-3, -2)  # (..., L, h, d)
        out = dense(self.out, out.reshape(*out.shape[:-2], -1), cdtype)
        return torch.movedim(out, -2, axis)


class AxialAttentionBlock(nn.Module):
    """Pre-LN axial transformer block: attention along each of ``axes`` and
    an MLP (2x wide, tanh gelu), each with a residual."""

    def __init__(self, features: int, heads: int = 4, axes: Sequence[int] = (-3, -2),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.axes = tuple(axes)
        self.dtype = dtype
        for i, axis in enumerate(self.axes):
            self.add_module(f"ln{i}", nn.LayerNorm(features, eps=1e-6))
            self.add_module(f"attn{i}", AxialSelfAttention(features, heads=heads, axis=axis,
                                                           dtype=dtype, generator=generator))
        self.ln_mlp = nn.LayerNorm(features, eps=1e-6)
        self.mlp_in = nn.Linear(features, 2 * features)
        self.mlp_out = nn.Linear(2 * features, features)
        for layer in (self.mlp_in, self.mlp_out):
            _lecun_dense_(layer, generator)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self.dtype = dtype
        for i in range(len(self.axes)):
            getattr(self, f"attn{i}").dtype = dtype

    def forward(self, x: torch.Tensor, attention: Callable = axial_attention) -> torch.Tensor:
        cdtype = compute_dtype(self.dtype, x)
        for i in range(len(self.axes)):
            h = layer_norm(getattr(self, f"ln{i}"), x, cdtype)
            x = x + getattr(self, f"attn{i}")(h, attention)
        h = layer_norm(self.ln_mlp, x, cdtype)
        h = F.gelu(dense(self.mlp_in, h, cdtype), approximate="tanh")
        return x + dense(self.mlp_out, h, cdtype)


def _lecun_dense_(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """flax's Dense init: lecun-normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    nn.init.zeros_(layer.bias)


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q kᵀ) v`` over the last two axes, the softmax in f32 at
    least."""
    logits = torch.matmul(q, k.transpose(-1, -2))
    weights = torch.softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def _max_pool_axes(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """flax ``nn.max_pool`` (VALID, stride = window) over the spatial axes of
    a channels-last tensor."""
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    return pool(x.movedim(-1, 1), tuple(window), tuple(window)).movedim(1, -1)


class _GammaGated(DtypedModule):
    """``query``, ``key`` and ``value`` 1x1 convs and the scalar ``gamma``
    (0 at the start) of the SAGAN attentions."""

    def __init__(self, features: int, qk_features: int, ndim: int,
                 dtype: Optional[torch.dtype], generator: Optional[torch.Generator]):
        super().__init__()
        k = (1,) * ndim
        self.query = Conv(features, qk_features, k, generator=generator)
        self.key = Conv(features, qk_features, k, generator=generator)
        self.value = Conv(features, features, k, generator=generator)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.dtype = dtype

    def qkv(self, x: torch.Tensor):
        return self.query(x), self.key(x), self.value(x)


class SAGANAttention2d(_GammaGated):
    """SAGAN self-attention over an NHWC image: q and k to max(C // 8, 1)
    channels, v to C, k and v 2x2 max-pooled (``pool_kv``, on even sizes),
    softmax over the pooled positions, ``gamma * out + x``."""

    def __init__(self, features: int, pool_kv: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(features, max(features // 8, 1), 2, dtype, generator)
        self.pool_kv = pool_kv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        q, k, v = self.qkv(x)
        if self.pool_kv and h % 2 == 0 and w % 2 == 0:
            k, v = max_pool(k, 2, 2), max_pool(v, 2, 2)
        out = _softmax_attention(q.reshape(b, h * w, -1), k.reshape(b, -1, k.shape[-1]),
                                 v.reshape(b, -1, c))
        return self.gamma * out.reshape(b, h, w, c) + x


class SelfAttention3d(_GammaGated):
    """Attention over the T·H·W tokens of an NTHWC video: q and k to C // 2
    channels, v to C, k and v max-pooled along T by ``pooling_factor`` where
    it divides T (T > 1), ``gamma * out + x``."""

    def __init__(self, features: int, pooling_factor: int = 2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(features, features // 2, 3, dtype, generator)
        self.pooling_factor = pooling_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        q, k, v = self.qkv(x)
        if t % self.pooling_factor == 0 and t > 1:
            window = (self.pooling_factor, 1, 1)
            k, v = _max_pool_axes(k, window), _max_pool_axes(v, window)
        out = _softmax_attention(q.reshape(b, t * h * w, -1), k.reshape(b, -1, k.shape[-1]),
                                 v.reshape(b, -1, c))
        return self.gamma * out.reshape(b, t, h, w, c) + x


class _GatedAxialCell(_GammaGated):
    """One axis of :class:`SeparableAttention`: the tokens are the positions
    along ``axis`` (1, 2 or 3 of an NTHWC video), every other axis a batch
    axis; k and v max-pooled along it where ``pooling_factor`` divides its
    length (> 1)."""

    def __init__(self, features: int, axis: int, pooling_factor: int = 2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(features, features // 2, 3, dtype, generator)
        self.axis = axis
        self.pooling_factor = pooling_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x)
        length = x.shape[self.axis]
        if length % self.pooling_factor == 0 and length > 1:
            window = [1, 1, 1]
            window[self.axis - 1] = self.pooling_factor
            k, v = _max_pool_axes(k, window), _max_pool_axes(v, window)
        out = _softmax_attention(*(torch.movedim(t, self.axis, -2) for t in (q, k, v)))
        return self.gamma * torch.movedim(out, -2, self.axis) + x


class SeparableAttention(nn.Module):
    """Gated axial attention along T, then W, then H of an NTHWC video
    (``cell_t``, ``cell_w``, ``cell_h``)."""

    def __init__(self, features: int, pooling_factor: int = 2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, axis in zip("twh", (1, 3, 2)):
            self.add_module(f"cell_{name}", _GatedAxialCell(features, axis, pooling_factor,
                                                            dtype, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in "twh":
            x = getattr(self, f"cell_{name}")(x)
        return x
