"""Probabilistic forecast metrics: ensemble CRPS and spread, counterpart of
``satflow_tpu/eval/probabilistic.py``.

For an M-member ensemble x_1..x_M and observation y (per scalar):

    CRPS = (1/M) * sum_i |x_i - y|  -  coef * sum_{i,j} |x_i - x_j|

with ``coef = 1/(2 M^2)`` (the classic estimator, exact when the members
are the atoms of the forecast distribution) or ``1/(2 M (M-1))`` when
``fair=True`` (unbiased for iid draws from the forecast distribution). A
deterministic forecast is the M=1 ensemble, for which CRPS reduces to MAE,
so deterministic baselines (persistence, optical flow) score on the same
scale.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from satflow_tpu_torch.data.datamodule import to_device


def crps_ensemble(samples: torch.Tensor, y: torch.Tensor, fair: bool = False) -> torch.Tensor:
    """Per-lead-time CRPS curve.

    Args:
      samples: ``(B, M, T, ...)`` ensemble forecasts (M members).
      y: ``(B, T, ...)`` observations.
      fair: the unbiased ``1/(2 M (M-1))`` spread coefficient (M >= 2);
        default the classic ``1/(2 M^2)``.

    Returns:
      ``(T,)`` CRPS averaged over batch, space and channels per lead time.
    """
    m = samples.shape[1]
    term1 = torch.mean(torch.abs(samples - y[:, None]), dim=1)  # (B, T, ...)
    if m == 1:
        crps = term1  # MAE: no spread term for a deterministic forecast
    else:
        diffs = torch.abs(samples[:, :, None] - samples[:, None, :])
        denom = 2 * m * (m - 1) if fair else 2 * m * m
        crps = term1 - torch.sum(diffs, dim=(1, 2)) / denom  # (B, T, ...)
    reduce_dims = tuple(i for i in range(crps.dim()) if i != 1)
    return torch.mean(crps, dim=reduce_dims)


def crps_deterministic(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-lead-time CRPS of a deterministic ``(B, T, ...)`` forecast (= MAE),
    the M=1 case of :func:`crps_ensemble`."""
    return crps_ensemble(y_hat[:, None], y)


@torch.no_grad()
def evaluate_ensemble(
    model,
    dataset: Iterable,
    num_samples: Optional[int] = None,
    max_batches: Optional[int] = None,
    rng_seed: int = 42,
    fair: bool = False,
) -> Dict[str, np.ndarray]:
    """CRPS / ensemble-mean-MSE / spread curves for a sampling model.

    Works with any model that has ``prepare_batch`` and ``_sample(x,
    generator, train, n)`` returning ``((B, n, T, H, W, C) samples, state)``
    (the DGMR family). Batch ``bi`` draws from a ``torch.Generator`` on the
    model's device seeded ``rng_seed + bi``. Runs on the model's device.

    Returns dict with ``crps`` (T,), ``mse`` (T,) of the ensemble mean,
    ``sample_std`` (the mean spread), and scalar means.
    """
    n = num_samples or getattr(model, "num_samples", 3)
    device = next(model.parameters()).device
    sums: Dict[str, np.ndarray] = {}
    count = 0
    for bi, batch in enumerate(dataset):
        if max_batches is not None and bi >= max_batches:
            break
        x, y = model.prepare_batch(to_device(batch, device))
        generator = torch.Generator(device=device).manual_seed(rng_seed + bi)
        samples, _ = model._sample(x, generator, False, n)
        mean_pred = torch.mean(samples, dim=1)
        se = torch.square(mean_pred - y)
        metrics = {
            "crps": crps_ensemble(samples, y, fair=fair),
            "mse": torch.mean(se, dim=tuple(i for i in range(se.dim()) if i != 1)),
            "sample_std": torch.mean(torch.std(samples, dim=1, correction=0)),
        }
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.double().cpu().numpy()
        count += 1

    if not count:
        raise ValueError("evaluate_ensemble got an empty dataset (or "
                         "max_batches=0) — nothing to score")
    results = {k: v / count for k, v in sums.items()}
    results["crps_mean"] = float(np.mean(results["crps"]))
    results["mse_mean"] = float(np.mean(results["mse"]))
    results["sample_std"] = float(results["sample_std"])
    return results
