"""Data: the JAX package's framework-free datasets behind a torch device put."""

from satflow_tpu_torch.data.datamodule import SatFlowDataModule  # noqa: F401
