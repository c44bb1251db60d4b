"""Loss registry, counterpart of ``satflow_tpu/nn/losses.py``.

``get_loss(name, **kwargs)`` builds a ``fn(pred, target) -> scalar`` with the
factory registered under ``name``, which takes the keywords it knows and
ignores the rest (MetNet passes ``channel=``), as the JAX factories do:
``mse`` (alias ``l2``; both sides upcast to f32 before the mean), ``l1``
(alias ``mae``), ``huber``, ``bce``, ``focal``, ``ssim``, ``ms_ssim`` (alias
``msssim``) and ``nll``. The GAN objectives (``GANLoss``,
``gradient_penalty``) are not ported yet: their names raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from satflow_tpu_torch.ops.ssim import convert_range, ms_ssim, ms_ssim_frames, ssim, ssim_frames

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

LOSSES: Dict[str, Callable[..., LossFn]] = {}


def _register(*names: str):
    def _add(factory):
        for name in names:
            LOSSES[name] = factory
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


# the JAX package's GAN objectives, by the ROADMAP item that ports them
_UNPORTED = dict.fromkeys(("gan", "ganloss", "vanilla", "lsgan", "wgangp",
                           "gradient_penalty"), "ROADMAP queue 1 item 11 (GAN losses)")


def get_loss(loss="mse", **kwargs) -> LossFn:
    """Loss by name, built with ``kwargs``; a callable passes straight through."""
    if callable(loss):
        return loss
    key = loss.lower()
    if key in LOSSES:
        return LOSSES[key](**kwargs)
    if key in _UNPORTED:
        raise NotImplementedError(f"loss {loss!r} is not ported yet: {_UNPORTED[key]}")
    raise KeyError(f"Unknown loss {loss!r}. Registered: {sorted(LOSSES)}")
