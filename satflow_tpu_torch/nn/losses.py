"""Loss registry, counterpart of ``satflow_tpu/nn/losses.py``.

``get_loss(name, **kwargs)`` builds a ``fn(pred, target) -> scalar`` with the
factory registered under ``name``, which takes the keywords it knows and
ignores the rest (MetNet passes ``channel=``), as the JAX factories do:
``mse`` (alias ``l2``; both sides upcast to f32 before the mean), ``l1``
(alias ``mae``), ``huber``, ``bce``, ``focal``, ``ssim``, ``ms_ssim`` (alias
``msssim``) and ``nll``, in :data:`LOSSES`, a
:class:`~satflow_tpu_torch.core.registry.Registry` as in the JAX package; an
unknown name is a ``KeyError`` (the registry holds no GAN objective, as the
JAX one does not).

The GAN objectives are :class:`GANLoss` (vanilla BCE-with-logits, lsgan MSE,
wgangp mean score) and :func:`gradient_penalty` (WGAN-GP: the critic's
input gradient by a double backward, ``torch.autograd.grad(...,
create_graph=True)``, so that the penalty trains the critic).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from satflow_tpu_torch.core.registry import Registry
from satflow_tpu_torch.ops.ssim import convert_range, ms_ssim, ms_ssim_frames, ssim, ssim_frames

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

LOSSES = Registry("loss")


def _register(*names: str):
    """Register a factory under each of ``names`` (a name and its aliases)."""
    def _add(factory):
        for name in names:
            LOSSES.register(name)(factory)
        return factory

    return _add


@_register("mse", "l2")
def make_mse(**_) -> LossFn:
    def mse(pred, target):
        return torch.mean(torch.square(pred.float() - target.float()))

    return mse


@_register("l1", "mae")
def make_l1(**_) -> LossFn:
    def l1(pred, target):
        return torch.mean(torch.abs(pred - target))

    return l1


@_register("huber")
def make_huber(delta: float = 1.0, **_) -> LossFn:
    """optax's ``huber_loss``: ``0.5 x²`` for ``|x| <= delta``, else
    ``delta (|x| - delta / 2)``, in its quadratic + linear form."""

    def huber(pred, target):
        abs_err = torch.abs(pred - target)
        quadratic = torch.clamp(abs_err, max=delta)
        linear = abs_err - quadratic
        return torch.mean(0.5 * quadratic**2 + delta * linear)

    return huber


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


@_register("bce")
def make_bce(with_logits: bool = True, **_) -> LossFn:
    def bce(pred, target):
        if with_logits:
            return torch.mean(_sigmoid_bce(pred, target))
        eps = 1e-7
        p = torch.clamp(pred, eps, 1.0 - eps)
        return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))

    return bce


@_register("focal")
def make_focal(alpha: float = 0.25, gamma: float = 2.0, with_logits: bool = True,
               **_) -> LossFn:
    """Binary focal loss."""

    def focal(pred, target):
        logits = pred if with_logits else torch.log(
            torch.clamp(pred, 1e-7, 1.0 - 1e-7) / torch.clamp(1.0 - pred, 1e-7, 1.0))
        p = torch.sigmoid(logits)
        ce = _sigmoid_bce(logits, target)
        p_t = p * target + (1.0 - p) * (1.0 - target)
        alpha_t = alpha * target + (1.0 - alpha) * (1.0 - target)
        return torch.mean(alpha_t * (1.0 - p_t) ** gamma * ce)

    return focal


@_register("ssim")
def make_ssim(convert_range_flag: bool = False, nonnegative: bool = True,
              data_range: float = 1.0, **_) -> LossFn:
    """``1 - SSIM``; with ``convert_range_flag`` both sides go from [-1, 1]
    to [0, 1] first, in their own dtype (SSIM upcasts after). The loss's
    ``per_frame`` gives the loss of each frame of (B, T, ...) inputs (T,) in
    one pass."""

    def convert(p, t):
        return (convert_range(p), convert_range(t)) if convert_range_flag else (p, t)

    def loss(pred, target):
        return 1.0 - ssim(*convert(pred, target), data_range=data_range, nonnegative=nonnegative)

    loss.per_frame = lambda pred, target: 1.0 - ssim_frames(
        *convert(pred, target), data_range=data_range, nonnegative=nonnegative)
    return loss


@_register("ms_ssim", "msssim")
def make_ms_ssim(convert_range_flag: bool = False, data_range: float = 1.0, **_) -> LossFn:
    """``1 - MS-SSIM``, with the range conversion and ``per_frame`` of
    :func:`make_ssim`."""

    def convert(p, t):
        return (convert_range(p), convert_range(t)) if convert_range_flag else (p, t)

    def loss(pred, target):
        return 1.0 - ms_ssim(*convert(pred, target), data_range=data_range)

    loss.per_frame = lambda pred, target: 1.0 - ms_ssim_frames(
        *convert(pred, target), data_range=data_range)
    return loss


@_register("nll")
def make_nll(**_) -> LossFn:
    """Mean negative log-likelihood of integer class targets under
    log-probabilities over the last axis."""

    def nll(pred_log_probs, target_idx):
        picked = torch.gather(pred_log_probs, -1, target_idx[..., None].long())
        return -torch.mean(picked)

    return nll


def get_loss(loss="mse", **kwargs) -> LossFn:
    """Loss by name, built with ``kwargs``; a callable passes straight through."""
    if callable(loss):
        return loss
    return LOSSES.create(loss, **kwargs)


class GANLoss:
    """Adversarial objective over discriminator outputs. ``gan_mode``:
    ``"vanilla"`` (mean BCE-with-logits against the real / fake label),
    ``"lsgan"`` (mean squared error to the label) or ``"wgangp"`` (the mean
    score, negated for real). Computed in f32 at least."""

    def __init__(self, gan_mode: str = "vanilla", target_real_label: float = 1.0,
                 target_fake_label: float = 0.0):
        if gan_mode not in ("vanilla", "lsgan", "wgangp"):
            raise ValueError(f"gan mode {gan_mode!r} not implemented")
        self.gan_mode = gan_mode
        self.real_label = target_real_label
        self.fake_label = target_fake_label

    def __call__(self, prediction: torch.Tensor, target_is_real: bool) -> torch.Tensor:
        prediction = prediction.to(torch.promote_types(prediction.dtype, torch.float32))
        if self.gan_mode == "wgangp":
            return -prediction.mean() if target_is_real else prediction.mean()
        target = torch.full_like(prediction,
                                 self.real_label if target_is_real else self.fake_label)
        if self.gan_mode == "lsgan":
            return torch.mean(torch.square(prediction - target))
        return F.binary_cross_entropy_with_logits(prediction, target)


def gradient_penalty(
    disc_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    mode: str = "mixed",
    constant: float = 1.0,
    lambda_gp: float = 10.0,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """WGAN-GP: ``lambda_gp · mean((‖∇ₓ Σ disc_fn(x)‖ - constant)²)`` per
    sample, at x = ``real``, ``fake`` or (``"mixed"``) ``alpha·real + (1 -
    alpha)·fake`` with ``alpha`` (B, 1, ..., 1) uniform on [0, 1) from
    ``generator``, or given. The input gradient keeps its graph, so the
    penalty's own gradient reaches the critic's parameters."""
    if lambda_gp <= 0:
        return torch.zeros((), device=real.device)
    if mode == "real":
        x = real
    elif mode == "fake":
        x = fake
    else:
        if alpha is None:
            alpha = torch.rand((real.shape[0],) + (1,) * (real.dim() - 1),
                               generator=generator, device=real.device, dtype=real.dtype)
        x = alpha * real + (1.0 - alpha) * fake
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    grads = grads.reshape(grads.shape[0], -1)
    grad_norm = torch.sqrt(torch.sum(grads * grads, dim=1) + 1e-16)
    return lambda_gp * torch.mean((grad_norm - constant) ** 2)
