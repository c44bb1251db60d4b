"""Experiments: config -> datamodule + model + trainer -> fit/test."""

from satflow_tpu_torch.experiments.train import train  # noqa: F401
