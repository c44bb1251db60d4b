"""satflow_tpu_torch — the PyTorch and CUDA port of satflow_tpu, for NVIDIA Hopper.

The JAX package ``satflow_tpu`` is the reference; this package mirrors its
layout and names, imports ``torch`` and never ``jax``, and replaces each
Pallas kernel on a ported path with a hand-written CUDA kernel
(``csrc/``, built with ``nvcc`` at first use).

Subpackages
-----------
- ``core``:        the model registry, config surgery and logging utilities,
                   and the loader of the JAX package's framework-free modules.
- ``ops``:         CUDA kernels, their nvcc build and their plain PyTorch
                   versions; the fused step's autograd Function.
- ``nn``:          layers (the fused ConvLSTM cell) and losses.
- ``models``:      the model zoo (``EncoderDecoderConvLSTM``).
- ``interop``:     the flax -> PyTorch weight bridge.
- ``data``:        a torch adapter over the JAX package's datasets and loaders.
- ``train``:       train state, train/eval steps and the ``Trainer``.
- ``experiments``: the experiment entry point behind ``python -m satflow_tpu_torch.run``.
- ``serve``:       inference sessions, micro-batching and the HTTP server.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a CUDA card that
    this process cannot reach."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but torch.cuda.is_available() is False"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    return dev
