"""Optical-flow and persistence baselines."""

from satflow_tpu_torch.baseline.optical_flow import run_baseline  # noqa: F401
