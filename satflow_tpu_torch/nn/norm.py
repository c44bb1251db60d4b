"""Normalization layers, counterpart of ``satflow_tpu/nn/norm.py``: spectral
norm by power iteration (:class:`SpectralNorm`, and the layers it wraps,
:class:`SNConv`, :class:`SNDense`, :class:`SNEmbed`) and the conditional
batch norm :class:`ConditionalNorm`.

The power iteration runs on the matrix flax runs it on: the kernel viewed as
``(-1, O)``. A port weight laid out as torch lays it out (a conv's (O, I,
*k), a dense's (O, I)) is viewed back in flax's order first
(:func:`flax_matrix`), so that the stored vector ``u`` (O,) means the same
thing on both sides and converts as it is.

The JAX layers keep ``u`` in the ``"spectral"`` collection and write it back
only where that collection is mutable. Here ``u`` is a buffer (``sn.u``,
flax's ``spectral/.../sn/u``) that a forward writes back in training mode
(the GAN steps apply a network with ``train=True`` exactly where they make
its collections mutable) unless :func:`frozen_state` holds it, as it holds
the BatchNorm statistics: the GAN generator step scores its fakes with the
discriminator in training mode and throws that state away. The stateless
variant (the DGMR sampler's) starts from ``ones(O) / sqrt(O)`` every call
and keeps nothing. No kernel: the power iteration is two matrix-vector
products per step, and the layers' convs and matmuls are library calls, as
the JAX layers leave them to XLA.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from satflow_tpu_torch.nn.conv import Conv, lecun_normal_
from satflow_tpu_torch.nn.misc import BatchNorm, DtypedModule, compute_dtype


@contextlib.contextmanager
def frozen_state(module: nn.Module) -> Iterator[None]:
    """Inside, no BatchNorm statistic and no spectral-norm ``u`` under
    ``module`` moves, in training mode too: the network is applied with its
    state collections immutable, as flax applies it without ``mutable=``."""
    mods = [m for m in module.modules() if hasattr(m, "state_frozen")]
    before = [m.state_frozen for m in mods]
    for m in mods:
        m.state_frozen = True
    try:
        yield
    finally:
        for m, was in zip(mods, before):
            m.state_frozen = was


def flax_matrix(weight: torch.Tensor) -> torch.Tensor:
    """A torch-layout weight as the ``(-1, O)`` matrix of its flax kernel:
    (O, I, *k) -> (*k, I, O) flattened, (O, I) -> (I, O)."""
    perm = (*range(2, weight.dim()), 1, 0)
    return weight.permute(perm).reshape(-1, weight.shape[0])


def _l2_normalize(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v) + eps)


class SpectralNorm(nn.Module):
    """Divides a kernel by its top singular value, found by power iteration
    on its ``(-1, O)`` matrix ``w``: ``v = normalize(w u)``, ``u =
    normalize(wᵀ v)`` ``n_steps`` times (at least once), ``σ = vᵀ w u``,
    ``u`` and ``v`` carrying no gradient.

    Stateful: ``u`` is a buffer of shape (O,), drawn N(0, 1) from
    ``generator``, written back in training mode unless frozen. Stateless:
    ``u`` starts from ``ones(O) / sqrt(O)`` and runs ``max(n_steps, 3)``
    iterations."""

    state_frozen = False

    def __init__(self, out_features: int, n_steps: int = 1, eps: float = 1e-12,
                 stateless: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_steps = n_steps
        self.eps = eps
        self.stateless = stateless
        if not stateless:
            self.register_buffer("u", torch.randn(out_features, generator=generator))

    def sigma(self, w: torch.Tensor) -> torch.Tensor:
        """σ of the (-1, O) matrix ``w`` (the stored ``u`` moves as the class
        says)."""
        out_features = w.shape[-1]
        with torch.no_grad():
            if self.stateless:
                u = torch.ones(out_features, dtype=w.dtype, device=w.device) / (
                    out_features ** 0.5)
                steps = max(self.n_steps, 3)
            else:
                u = self.u.to(w.dtype)
                steps = self.n_steps
            wd = w.detach()
            for _ in range(max(steps, 1)):
                v = _l2_normalize(wd @ u, self.eps)
                u = _l2_normalize(wd.t() @ v, self.eps)
            if not self.stateless and self.training and not self.state_frozen:
                self.u.copy_(u)
        return v @ w @ u

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        """``weight`` (torch layout) divided by ``σ + eps`` of its flax matrix."""
        return weight / (self.sigma(flax_matrix(weight)) + self.eps)


class SNConv(Conv):
    """flax ``SNConv``: a 2-D or 3-D :class:`Conv` (by the length of
    ``kernel_size``; an int means 2-D) whose weight is divided by its
    spectral norm (``sn``) on every call. ``in_features=None`` takes the
    width from the first input."""

    def __init__(self, in_features: Optional[int], features: int,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 strides: Union[int, Sequence[int]] = 1, padding: Union[str, int] = "SAME",
                 use_bias: bool = True, n_steps: int = 1, stateless: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, kernel_size, strides, padding, use_bias,
                         dtype, generator)
        self.sn = SpectralNorm(features, n_steps, stateless=stateless, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.sn(self.weight_for(x)))


class SNDense(DtypedModule):
    """flax ``SNDense``: ``x @ Wᵀ + b`` with ``weight`` (O, I) (flax's (I,
    O) ``kernel`` transposed) divided by its spectral norm."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 n_steps: int = 1, stateless: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        lecun_normal_(self.weight, in_features, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.sn = SpectralNorm(features, n_steps, stateless=stateless, generator=generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype(self.dtype, x)
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.sn(self.weight).to(cd), bias)


class SNEmbed(nn.Module):
    """flax ``SNEmbed``: rows of the spectrally normalised ``embedding``
    table (num_embeddings, features), drawn N(0, 0.02²) as flax draws it."""

    def __init__(self, num_embeddings: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn(num_embeddings, features, generator=generator) * 0.02)
        self.sn = SpectralNorm(features, generator=generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        table = self.embedding / (self.sn.sigma(self.embedding) + self.sn.eps)
        return table[idx]


class ConditionalNorm(DtypedModule):
    """Conditional batch norm: a BatchNorm without scale and bias (``bn``),
    then ``gamma * h + beta`` with (gamma, beta) from the Dense ``embed``
    of the condition (zero weight, bias ones then zeros, so it starts as
    the identity affine), broadcast over the spatial axes. Training mode
    normalises with the batch statistics and moves them (flax's
    ``use_running_average=False``)."""

    def __init__(self, features: int, cond_features: int, momentum: float = 0.99,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn = BatchNorm(features, momentum, eps, use_scale=False, use_bias=False)
        self.embed = nn.Linear(cond_features, 2 * features)
        with torch.no_grad():
            self.embed.weight.zero_()
            self.embed.bias.copy_(torch.cat([torch.ones(features), torch.zeros(features)]))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype(self.dtype, x)
        h = self.bn(x, cd)
        ccd = compute_dtype(self.dtype, condition)
        gamma, beta = F.linear(condition.to(ccd), self.embed.weight.to(ccd),
                               self.embed.bias.to(ccd)).chunk(2, dim=-1)
        shape: Tuple[int, ...] = (gamma.shape[0],) + (1,) * (h.dim() - 2) + (gamma.shape[-1],)
        return gamma.reshape(shape) * h + beta.reshape(shape)
