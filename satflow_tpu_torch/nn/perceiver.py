"""Perceiver IO layers, counterpart of ``satflow_tpu/nn/perceiver.py``.

Fourier position features, the modality spec, multi-head attention, the
cross- and self-attention blocks, :class:`MultiPerceiverIO`, the learnable
decoder query and the image pre- and post-processors. Tensors are
channels-last (B, *index_dims, C), as in the JAX package.

Parameters keep the flax leaves' names, one torch parameter a leaf, and
the flax shapes but for the kernels that torch lays out otherwise, which
take the port's shared layouts: a ``Dense`` ``weight`` (out, in) and a
conv's (O, I, *k) (:class:`~satflow_tpu_torch.nn.conv.Conv`, shared with
the rest of the port, and :class:`ConvTranspose`); the attention's
DenseGeneral ``to_q`` / ``to_k`` / ``to_v`` ``kernel`` (in, heads,
dim_head) with ``bias`` (heads, dim_head) and ``to_out`` ``kernel`` (heads,
dim_head, out), the LayerNorms' ``scale`` and ``bias``, and the raw
``latents``, ``modality_emb`` and ``query`` grids as flax has them. LAMB,
whose trust ratio is taken per tensor, sees the tensors optax sees (a norm
does not depend on the order of the axes). A weight whose input width comes
from the data (a modality's projection, the query mix conv, the image
encoder's conv) is lazy (:class:`~satflow_tpu_torch.nn.conv.LazyWeight`):
one never seen stays out of the state_dict, as it stays out of the flax
tree.

flax's numerics are kept where torch's differ: LayerNorm's epsilon is 1e-6
with f32 statistics, ``gelu`` is the tanh approximation, and a layer computes
in its ``dtype`` (None: the input's, at least float32). The attention is
``torch.matmul`` and a softmax taken in float32, the JAX package's plain
einsum and softmax: no kernel of the repo is on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.nn.conv import Conv, LazyWeight, lecun_normal_
from satflow_tpu_torch.nn.misc import (
    DtypedModule,
    LayerNorm,
    compute_dtype,
    crop_center,
    reverse_space_to_depth,
    space_to_depth,
)

# ---------------------------------------------------------------------------
# Fourier position encoding
# ---------------------------------------------------------------------------


def fourier_features(index_dims: Sequence[int], num_bands: int, max_frequency: float,
                     sine_only: bool = False, dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """Fourier position features over an N-D index grid, (prod(index_dims),
    n_axes * (num_bands * (1 if sine_only else 2) + 1)): per axis, sin (and
    cos) at ``num_bands`` frequencies linspaced 1..max_frequency/2, then the
    raw coordinate in [-1, 1]. Computed in ``dtype`` op by op, as the JAX
    function is (each linspace in f32, then rounded to ``dtype``)."""
    ldtype = torch.promote_types(dtype, torch.float32)
    grids = [torch.linspace(-1.0, 1.0, d, dtype=ldtype, device=device).to(dtype)
             for d in index_dims]
    pos = torch.stack(torch.meshgrid(*grids, indexing="ij"), dim=-1)
    pos = pos.reshape(-1, len(index_dims))  # (N, n_axes)
    freqs = torch.linspace(1.0, max_frequency / 2.0, num_bands, dtype=ldtype,
                           device=device).to(dtype)
    angles = math.pi * pos[..., None] * freqs  # (N, n_axes, bands)
    feats = [torch.sin(angles)] + ([] if sine_only else [torch.cos(angles)])
    feats = torch.cat(feats, dim=-1).reshape(pos.shape[0], -1)
    return torch.cat([feats, pos], dim=-1)


def encode_position(batch: int, axis: Sequence[int], num_frequency_bands: int,
                    max_frequency: float, sine_only: bool = False,
                    device=None) -> torch.Tensor:
    """Batched f32 Fourier features, (B, *axis, feat) (an expanded view)."""
    ff = fourier_features(axis, num_frequency_bands, max_frequency, sine_only, device=device)
    ff = ff.reshape(*axis, ff.shape[-1])
    return ff[None].expand(batch, *ff.shape)


@dataclasses.dataclass(frozen=True)
class InputModality:
    """Modality spec: its name in the inputs, channels, index axes (3 video,
    2 image, 1 series) and its Fourier encoding."""

    name: str
    input_channels: int
    input_axis: int
    num_freq_bands: int = 32
    max_freq: float = 4.0
    sin_only: bool = False
    fourier_encode: bool = True

    @property
    def fourier_dim(self) -> int:
        if not self.fourier_encode:
            return 0
        per_axis = self.num_freq_bands * (1 if self.sin_only else 2) + 1
        return self.input_axis * per_axis


# ---------------------------------------------------------------------------
# flax layers the rest of the port does not have
# ---------------------------------------------------------------------------


class Dense(LazyWeight):
    """flax ``nn.Dense``: ``weight`` (features, in) for its (in, features)
    ``kernel``, and ``bias``; ``in_features=None`` takes the input width
    from the data (:class:`~satflow_tpu_torch.nn.conv.LazyWeight`)."""

    def __init__(self, in_features: Optional[int], features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self._make_weight(in_features, features, use_bias, generator)

    def _weight_shape(self, in_features: int) -> Tuple[int, ...]:
        return (self.features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight_for(x)
        cd = compute_dtype(self.dtype, x)
        return F.linear(x.to(cd), weight.to(cd), None if self.bias is None else self.bias.to(cd))


class DenseGeneral(DtypedModule):
    """flax ``nn.DenseGeneral`` as the attention uses it: ``"in"`` maps the
    last axis to (heads, dim_head) (``kernel`` (in, heads, dim_head), ``bias``
    (heads, dim_head)); ``"out"`` maps the last two axes (heads, dim_head)
    to ``features`` (``kernel`` (heads, dim_head, features), ``bias``)."""

    def __init__(self, kind: str, in_features: int, heads: int, dim_head: int,
                 features: Optional[int] = None, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kind = kind
        if kind == "in":
            shape, fan_in, bias = (in_features, heads, dim_head), in_features, (heads, dim_head)
        elif kind == "out":
            shape, fan_in, bias = (heads, dim_head, features), heads * dim_head, (features,)
        else:
            raise ValueError(f"kind must be 'in' or 'out', got {kind!r}")
        self.kernel = nn.Parameter(torch.empty(shape))
        lecun_normal_(self.kernel, fan_in, generator)
        self.bias = nn.Parameter(torch.zeros(bias)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype(self.dtype, x)
        k = self.kernel.to(cd)
        if self.kind == "in":
            y = torch.matmul(x.to(cd), k.reshape(k.shape[0], -1))
            y = y.reshape(*x.shape[:-1], *k.shape[1:])
        else:
            y = torch.matmul(x.to(cd).flatten(-2), k.reshape(-1, k.shape[-1]))
        return y if self.bias is None else y + self.bias.to(cd)


class ConvTranspose(DtypedModule):
    """flax ``nn.ConvTranspose`` (2-D, padding ``SAME``, the kernel not
    flipped): ``weight`` (O, I, kh, kw) for its (kh, kw, I, O) ``kernel``,
    as a :class:`~satflow_tpu_torch.nn.conv.Conv` holds its own, and
    ``bias``. ``F.conv_transpose2d`` correlates the stride-dilated input
    with the flipped (I, O, kh, kw) weight, so the weight is flipped and its
    two channel axes swapped here; the padding and output padding are
    derived from ``lax.conv_transpose``'s ``SAME`` pads."""

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
            if p < 0 or not 0 <= op < s:
                raise ValueError(f"ConvTranspose kernel {k} stride {s}: SAME padding has "
                                 f"no conv_transpose2d form")
            self.padding.append(p)
            self.output_padding.append(op)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype(self.dtype, x)
        w = self.weight.to(cd).transpose(0, 1).flip(2, 3)  # (I, O, kh, kw)
        b = None if self.bias is None else self.bias.to(cd)
        y = F.conv_transpose2d(x.to(cd).movedim(-1, 1), w, b, stride=self.strides,
                               padding=self.padding, output_padding=self.output_padding)
        return y.movedim(1, -1)


def _normal(shape, generator: Optional[torch.Generator], std: float = 0.02) -> nn.Parameter:
    """flax ``initializers.normal(std)``."""
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


# ---------------------------------------------------------------------------
# Attention blocks
# ---------------------------------------------------------------------------


class MHAttention(DtypedModule):
    """Multi-head attention: queries (B, M, Dq) attend over the context (B,
    N, Dc) -> (B, M, out_features or Dq). ``qkv_bias`` gives the q, k, v
    projections biases (HF's Perceiver has them, perceiver-pytorch not)."""

    def __init__(self, q_features: int, kv_features: int, heads: int = 8, dim_head: int = 64,
                 out_features: Optional[int] = None, qkv_bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim_head = dim_head
        self.dtype = dtype
        for name, width in (("to_q", q_features), ("to_k", kv_features), ("to_v", kv_features)):
            self.add_module(name, DenseGeneral("in", width, heads, dim_head, use_bias=qkv_bias,
                                               dtype=dtype, generator=generator))
        self.to_out = DenseGeneral("out", None, heads, dim_head, out_features or q_features,
                                   dtype=dtype, generator=generator)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        q = self.to_q(q_in).transpose(1, 2)  # (B, h, M, d)
        k = self.to_k(kv_in).permute(0, 2, 3, 1)  # (B, h, d, N)
        v = self.to_v(kv_in).transpose(1, 2)  # (B, h, N, d)
        logits = torch.matmul(q * self.dim_head ** -0.5, k)
        weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        return self.to_out(torch.matmul(weights, v).transpose(1, 2))  # (B, M, h, d) in


class FeedForward(DtypedModule):
    """Dense ``in_`` (x ``mult``), tanh gelu, Dense ``out``."""

    def __init__(self, features: int, mult: int = 2, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_ = Dense(features, features * mult, dtype=dtype, generator=generator)
        self.out = Dense(features * mult, features, dtype=dtype, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(F.gelu(self.in_(x), approximate="tanh"))


class CrossAttentionBlock(DtypedModule):
    """Pre-LN cross-attention of ``latents`` over ``context``, its residual
    (unless ``query_residual`` is False: HF's flow decoder), then an optional
    pre-LN feed-forward with its residual."""

    def __init__(self, q_features: int, kv_features: int, heads: int = 1, dim_head: int = 64,
                 ff: bool = True, ff_mult: int = 2, qkv_bias: bool = False,
                 query_residual: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.query_residual = query_residual
        self.ln_q = LayerNorm(q_features, dtype=dtype)
        self.ln_kv = LayerNorm(kv_features, dtype=dtype)
        self.attn = MHAttention(q_features, kv_features, heads, dim_head, qkv_bias=qkv_bias,
                                dtype=dtype, generator=generator)
        if ff:
            self.ln_ff = LayerNorm(q_features, dtype=dtype)
            self.ff = FeedForward(q_features, ff_mult, dtype=dtype, generator=generator)
        else:
            self.ln_ff = self.ff = None
        self.dtype = dtype

    def forward(self, latents: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.ln_q(latents), self.ln_kv(context))
        latents = latents + h if self.query_residual else h
        if self.ff is not None:
            latents = latents + self.ff(self.ln_ff(latents))
        return latents


class SelfAttentionBlock(DtypedModule):
    """Pre-LN self-attention and feed-forward, each with its residual."""

    def __init__(self, features: int, heads: int = 8, dim_head: int = 64, ff_mult: int = 2,
                 qkv_bias: bool = False, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln = LayerNorm(features, dtype=dtype)
        self.attn = MHAttention(features, features, heads, dim_head, qkv_bias=qkv_bias,
                                dtype=dtype, generator=generator)
        self.ln_ff = LayerNorm(features, dtype=dtype)
        self.ff = FeedForward(features, ff_mult, dtype=dtype, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln(x)
        x = x + self.attn(h, h)
        return x + self.ff(self.ln_ff(x))


# ---------------------------------------------------------------------------
# MultiPerceiverIO
# ---------------------------------------------------------------------------


class MultiPerceiverIO(DtypedModule):
    """Multimodal Perceiver IO.

    Inputs: dict name -> tensor (B, *index_dims, channels) per its
    :class:`InputModality` (a 1-D series may omit the channel axis). Each
    modality present is flattened to tokens, its Fourier features (in its
    dtype) appended, projected to ``dim`` (``proj_<name>``, whose input width
    comes from the data) and tagged with its row of ``modality_emb``, indexed
    by the modality's place in the full list; all tokens form one context.
    ``latents`` cross-attend it once (``encode``), run ``depth``
    self-attention blocks (``latent`` once if ``weight_tie_layers``, else
    ``latent{i}``), and the queries, projected to ``queries_dim``
    (``query_proj``), cross-attend the latents (``decode``) -> (B, M,
    logits_dim) through ``to_logits``.
    """

    def __init__(self, modalities: Sequence[InputModality], dim: int = 32,
                 queries_dim: int = 32, logits_dim: int = 100, depth: int = 6,
                 num_latents: int = 256, latent_dim: int = 512, cross_heads: int = 1,
                 latent_heads: int = 8, cross_dim_head: int = 8, latent_dim_head: int = 64,
                 weight_tie_layers: bool = False, decoder_ff: bool = True,
                 qkv_bias: bool = False, cross_ff_mult: int = 2, latent_ff_mult: int = 2,
                 decoder_query_residual: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.modalities = tuple(modalities)
        self.depth = depth
        self.cross_heads = cross_heads
        self.latent_heads = latent_heads
        self.weight_tie_layers = weight_tie_layers
        self.decoder_ff = decoder_ff
        self.modality_emb = _normal((len(self.modalities), dim), generator)
        for mod in self.modalities:
            self.add_module(f"proj_{mod.name}", Dense(None, dim, dtype=dtype, generator=generator))
        self.latents = _normal((num_latents, latent_dim), generator)
        self.encode = CrossAttentionBlock(latent_dim, dim, cross_heads, cross_dim_head,
                                          ff_mult=cross_ff_mult, qkv_bias=qkv_bias, dtype=dtype,
                                          generator=generator)
        for i in range(1 if weight_tie_layers else depth):
            self.add_module("latent" if weight_tie_layers else f"latent{i}", SelfAttentionBlock(
                latent_dim, latent_heads, latent_dim_head, ff_mult=latent_ff_mult,
                qkv_bias=qkv_bias, dtype=dtype, generator=generator))
        self.query_proj = Dense(None, queries_dim, dtype=dtype, generator=generator)
        self.decode = CrossAttentionBlock(queries_dim, latent_dim, cross_heads, cross_dim_head,
                                          ff=decoder_ff, ff_mult=cross_ff_mult,
                                          qkv_bias=qkv_bias,
                                          query_residual=decoder_query_residual, dtype=dtype,
                                          generator=generator)
        self.to_logits = Dense(queries_dim, logits_dim, dtype=dtype, generator=generator)
        self.dtype = dtype

    def forward(self, inputs: Dict[str, torch.Tensor], queries: torch.Tensor) -> torch.Tensor:
        tokens = []
        b = next(iter(inputs.values())).shape[0]
        for mi, mod in enumerate(self.modalities):
            if mod.name not in inputs:
                continue
            x = inputs[mod.name]
            if x.dim() == mod.input_axis + 1:  # a series without its channel axis
                x = x[..., None]
            index_dims = tuple(x.shape[1:1 + mod.input_axis])
            flat = x.reshape(b, math.prod(index_dims), x.shape[-1])
            if mod.fourier_encode:
                ff = fourier_features(index_dims, mod.num_freq_bands, mod.max_freq,
                                      mod.sin_only, dtype=flat.dtype, device=flat.device)
                flat = torch.cat([flat, ff[None].expand(b, *ff.shape)], dim=-1)
            proj = getattr(self, f"proj_{mod.name}")(flat)
            tokens.append(proj + self.modality_emb[mi])
        context = torch.cat(tokens, dim=1)

        z = self.latents[None].expand(b, *self.latents.shape).to(context.dtype)
        z = self.encode(z, context)
        for i in range(self.depth):
            z = getattr(self, "latent" if self.weight_tie_layers else f"latent{i}")(z)
        out = self.decode(self.query_proj(queries), z)
        return self.to_logits(out)


class LearnableQuery(DtypedModule):
    """Learned decoder query grid ``query`` (*query_shape, channel_dim),
    with Fourier features appended (given, for temporal consistency, or
    generated over the grid), mixed by a 3x3 (3x3x3 for (T, H, W) queries)
    ``SAME`` conv ``mix`` -> (B, prod(query_shape), channel_dim)."""

    def __init__(self, channel_dim: int = 32, query_shape: Sequence[int] = (32, 32),
                 max_frequency: float = 4.0, num_frequency_bands: int = 32,
                 sine_only: bool = False, generate_fourier_features: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channel_dim = channel_dim
        self.query_shape = tuple(query_shape)
        self.max_frequency = max_frequency
        self.num_frequency_bands = num_frequency_bands
        self.sine_only = sine_only
        self.generate_fourier_features = generate_fourier_features
        self.query = _normal((*self.query_shape, channel_dim), generator)
        self.mix = Conv(None, channel_dim, (3,) * len(self.query_shape), dtype=dtype,
                        generator=generator)
        self.dtype = dtype

    def forward(self, batch: int, fourier: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self.query[None].expand(batch, *self.query.shape)
        if fourier is not None:
            q = torch.cat([q, fourier.reshape(batch, *self.query_shape, -1)], dim=-1)
        elif self.generate_fourier_features:
            ff = fourier_features(self.query_shape, self.num_frequency_bands, self.max_frequency,
                                  self.sine_only, dtype=q.dtype, device=q.device)
            ff = ff.reshape(*self.query_shape, -1)
            q = torch.cat([q, ff[None].expand(batch, *ff.shape)], dim=-1)
        q = self.mix(q)
        return q.reshape(batch, math.prod(self.query_shape), self.channel_dim)


# ---------------------------------------------------------------------------
# Image pre- and post-processors
# ---------------------------------------------------------------------------


class ImageEncoder(DtypedModule):
    """Video / image preprocessor over (B, T, H, W, C) or (B, H, W, C):
    ``"conv"`` a strided conv (downsample x ``spatial_downsample``),
    ``"patches"`` space-to-depth, ``"pixels"`` a strided subsample,
    ``"conv1x1"`` a strided 1x1 conv, ``"metnet"`` a centre crop x1/2, then
    space-to-depth x2, then, for video of even length, consecutive frames
    paired along the channels (T -> T/2). The conv's input width comes from
    the first input: a module shared by inputs of other widths raises, as
    flax does."""

    PREP_TYPES = ("conv", "patches", "pixels", "conv1x1", "metnet")

    def __init__(self, prep_type: str = "patches", output_channels: int = 64,
                 spatial_downsample: int = 4, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if prep_type not in self.PREP_TYPES:
            raise ValueError(f"Invalid prep_type {prep_type!r}")
        self.prep_type = prep_type
        self.spatial_downsample = spatial_downsample
        s = spatial_downsample
        if prep_type == "conv":
            self.conv = Conv(None, output_channels, (s, s), strides=s, dtype=dtype,
                             generator=generator)
        elif prep_type == "conv1x1":
            self.conv = Conv(None, output_channels, (1, 1), strides=s, dtype=dtype,
                             generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        video = x.dim() == 5
        if self.prep_type == "metnet":
            h = x.shape[-3]
            x = space_to_depth(crop_center(x, h // 2, h // 2), 2)
            if video and x.shape[1] % 2 == 0:
                b, t = x.shape[:2]
                x = x.reshape(b, t // 2, 2, *x.shape[2:])
                x = torch.cat([x[:, :, 0], x[:, :, 1]], dim=-1)
            return x
        if video:
            b, t = x.shape[:2]
            x = x.reshape(b * t, *x.shape[2:])
        s = self.spatial_downsample
        if self.prep_type in ("conv", "conv1x1"):
            x = self.conv(x)
        elif self.prep_type == "patches":
            x = space_to_depth(x, s)
        else:  # pixels
            x = x[:, ::s, ::s]
        return x.reshape(b, t, *x.shape[1:]) if video else x


class ImageDecoder(DtypedModule):
    """Inverse postprocessor over (B, T, H, W, C) or (B, H, W, C): ``"conv"``
    a stride ``spatial_upsample`` transposed conv (from ``output_channels``
    channels, the core's logits), ``"patches"`` depth-to-space, ``"pixels"``
    a nearest upsample (``jax.image.resize``'s, an integer factor: each
    pixel repeated), ``"conv1x1"`` a 1x1 conv."""

    POSTPROCESS_TYPES = ("conv", "patches", "pixels", "conv1x1")

    def __init__(self, postprocess_type: str = "patches", output_channels: int = 12,
                 spatial_upsample: int = 4, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if postprocess_type not in self.POSTPROCESS_TYPES:
            raise ValueError(f"Invalid postprocess_type {postprocess_type!r}")
        self.postprocess_type = postprocess_type
        self.spatial_upsample = spatial_upsample
        s = spatial_upsample
        if postprocess_type == "conv":
            self.conv = ConvTranspose(output_channels, output_channels, (s, s), (s, s),
                                      dtype=dtype, generator=generator)
        elif postprocess_type == "conv1x1":
            self.conv = Conv(None, output_channels, (1, 1), dtype=dtype, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        video = x.dim() == 5
        if video:
            b, t = x.shape[:2]
            x = x.reshape(b * t, *x.shape[2:])
        s = self.spatial_upsample
        if self.postprocess_type in ("conv", "conv1x1"):
            x = self.conv(x)
        elif self.postprocess_type == "patches":
            x = reverse_space_to_depth(x, s)
        else:  # pixels
            x = x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
        return x.reshape(b, t, *x.shape[1:]) if video else x
