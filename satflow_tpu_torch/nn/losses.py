"""Loss registry, counterpart of ``satflow_tpu/nn/losses.py``.

``get_loss(name)`` returns a ``fn(pred, target) -> scalar``. Ported: ``mse``
(alias ``l2``), which upcasts both sides to f32 before the mean as the JAX
loss does, and ``l1`` (alias ``mae``). The JAX registry's other losses raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Callable

import torch

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


_LOSSES = {"mse": mse, "l2": mse, "l1": l1, "mae": l1}
# the JAX registry's other names, by the ROADMAP item that ports them
_UNPORTED = {
    **dict.fromkeys(("ssim", "ms_ssim", "msssim", "huber", "bce", "focal", "nll"),
                    "ROADMAP queue 1 item 7 (eval and SSIM/MS-SSIM)"),
    **dict.fromkeys(("vanilla", "lsgan", "wgangp"),
                    "ROADMAP queue 1 item 11 (GAN losses)"),
}


def get_loss(loss="mse", **_) -> LossFn:
    """Loss by name; a callable passes straight through."""
    if callable(loss):
        return loss
    if loss in _LOSSES:
        return _LOSSES[loss]
    if loss in _UNPORTED:
        raise NotImplementedError(f"loss {loss!r} is not ported yet: {_UNPORTED[loss]}")
    raise KeyError(f"Unknown loss {loss!r}. Ported: {sorted(_LOSSES)}")
