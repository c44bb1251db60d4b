"""Fair-CRPS fine-tuning of a sampling generator, counterpart of
``satflow_tpu/train/probabilistic.py``.

The adversarial objective with the grid-cell regularizer on the sample mean
lets a small or synthetic run collapse its Monte-Carlo draws onto the
conditional mean. A short generator-only fine-tune on the fair ensemble CRPS
(:func:`~satflow_tpu_torch.eval.probabilistic.crps_ensemble` with
``fair=True``), a strictly proper score for iid draws, rewards accuracy and
calibrated spread in one differentiable scalar. The gradient flows
pathwise through the generator's latent draws; plain Adam on the generator's
parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Tuple

import torch

from satflow_tpu_torch.data.datamodule import to_device
from satflow_tpu_torch.eval.probabilistic import crps_ensemble
from satflow_tpu_torch.train.schedules import scheduled, warmup_cosine


def fair_crps_loss(samples: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The fine-tune's loss: the mean fair CRPS of ``samples`` (B, M, T,
    ...) against ``y`` (B, T, ...)."""
    return torch.mean(crps_ensemble(samples, y, fair=True))


class _History(list):
    """Recorded losses, with ``frontier``: [(step, eval_fn result), ...]."""

    frontier: List[Tuple[int, Any]]


def crps_finetune(
    model,
    batches: Iterable,
    *,
    steps: int = 300,
    num_samples: int = 6,
    lr: float = 5e-5,
    lr_schedule: str = "constant",
    seed: int = 0,
    log_every: int = 50,
    eval_every: Optional[int] = None,
    eval_fn: Optional[Callable[[Any], Any]] = None,
) -> Tuple[Any, _History]:
    """Fine-tune a sampling model's generator (``model.module``) in place on
    the fair ensemble CRPS.

    ``model`` has ``prepare_batch`` and ``_sample(x, generator, train, n) ->
    ((B, n, T, ...) samples, state)`` (``NowcastingGAN``). The samples are
    drawn in eval mode, so the non-parameter state (spectral-norm vectors,
    batch statistics) stays frozen: a short distribution correction, not
    more adversarial training. ``batches`` are moved to the model's device
    once and cycled for ``steps`` updates of Adam (optax's defaults) at
    ``lr``, constant or (``"cosine"``) from lr/10 up to lr over a 5 %
    warmup and down to lr/100. The latent noise comes from a
    ``torch.Generator`` on the model's device seeded ``seed``. ``num_samples``
    must be at least 2 (the fair estimator).

    Returns ``(model, history)``: the fair CRPS every ``log_every`` steps
    and at the end, and, with ``eval_fn`` and ``eval_every``,
    ``history.frontier``, ``eval_fn(model)`` every ``eval_every`` steps and
    at the end.
    """
    if num_samples < 2:
        raise ValueError(f"fair CRPS needs num_samples >= 2 (got {num_samples})")
    device = next(model.parameters()).device
    params = [p for p in model.module.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if lr_schedule == "cosine":
        opt = scheduled(opt, warmup_cosine(lr, warmup_steps=max(1, steps // 20),
                                           total_steps=steps, warmup_start_lr=lr / 10,
                                           eta_min=lr / 100))
    cache = [model.prepare_batch(to_device(b, device)) for b in batches]
    if not cache:
        raise ValueError("crps_finetune needs at least one batch")
    noise = torch.Generator(device=device).manual_seed(seed)

    history = _History()
    history.frontier = []
    loss = None
    for i in range(steps):
        x, y = cache[i % len(cache)]
        samples, _ = model._sample(x, noise, False, num_samples)
        loss = fair_crps_loss(samples, y)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        if i % log_every == 0:
            history.append(loss.item())
        if eval_fn is not None and eval_every and (i + 1) % eval_every == 0:
            history.frontier.append((i + 1, eval_fn(model)))
    if loss is not None:
        history.append(loss.item())
    if eval_fn is not None and (not history.frontier or history.frontier[-1][0] != steps):
        history.frontier.append((steps, eval_fn(model)))
    return model, history
