"""Core of the PyTorch port: the model registry, config composition and
logging utilities."""

from satflow_tpu_torch.core.registry import (  # noqa: F401
    create_model,
    get_model,
    list_models,
    register_model,
)
