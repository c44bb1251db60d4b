"""SatFlowDataModule for the port: an adapter, not a port.

``satflow_tpu.data`` needs no framework: its datasets (fake, npz/sfb stores,
the native C++ loader) yield numpy, and its ``Prefetcher`` overlaps reading
with compute through a ``device_put`` hook. The JAX datamodule fills that
hook with a sharded ``jax.device_put``; this subclass fills it with a torch
put instead and never reaches ``satflow_tpu.parallel``: numpy leaves go to
``self.device`` from pinned host memory with ``non_blocking=True`` (on a
CUDA device), one batch ahead of the consumer.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from satflow_tpu.data.datamodule import SatFlowDataModule as _JaxDataModule


def to_device(tree: Any, device: torch.device) -> Any:
    """Every numpy array or tensor of a (nested dict/tuple/list) batch on
    ``device``; CUDA copies start from pinned memory and do not block."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        if device.type == "cuda" and tree.device.type == "cpu":
            return tree.pin_memory().to(device, non_blocking=True)
        return tree.to(device)
    return tree


class SatFlowDataModule(_JaxDataModule):
    """The JAX datamodule's loaders, with batches put on ``device`` as tensors.

    ``device`` is where the trainer runs (the :class:`~satflow_tpu_torch.train.Trainer`
    sets it at ``fit``); None leaves batches as numpy. ``shard`` is accepted
    for config parity and has no effect (one device).
    """

    def __init__(self, *args, device: Optional[Any] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = None if device is None else torch.device(device)

    def _device_put(self):
        if self.device is None:
            return None
        device = self.device
        return lambda item: to_device(item, device)
