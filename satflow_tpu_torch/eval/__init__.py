"""Evaluation harness: per-lead-time metric curves and ensemble CRPS."""

from satflow_tpu_torch.eval.evaluate import evaluate_model  # noqa: F401
from satflow_tpu_torch.eval.probabilistic import (  # noqa: F401
    crps_deterministic,
    crps_ensemble,
    evaluate_ensemble,
)
