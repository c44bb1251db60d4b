"""satflow_tpu_torch — the PyTorch and CUDA port of satflow_tpu, for NVIDIA Hopper.

The JAX package ``satflow_tpu`` is the reference; this package mirrors its
layout and names, imports ``torch`` and never ``jax``, and replaces each
Pallas kernel on a ported path with a hand-written CUDA kernel
(``csrc/``, built with ``nvcc`` at first use).

Subpackages
-----------
- ``core``:        the model registry, config composition and surgery, and
                   logging utilities (the port's own copies of the JAX
                   package's framework-free modules).
- ``ops``:         CUDA kernels' wrappers, their nvcc build and their plain
                   PyTorch versions; the autograd Functions that join them;
                   SSIM / MS-SSIM and the optical-flow ops.
- ``nn``:          layers (the five ConvLSTM cell formulations, the conv
                   types, axial attention, MetNet's blocks) and the loss
                   registry (mse, l1, huber, bce, focal, ssim, ms_ssim, nll).
- ``models``:      the model zoo: ``EncoderDecoderConvLSTM`` and ``LitMetNet``.
- ``interop``:     the flax -> PyTorch weight bridge and the ``.npz`` format;
                   reference-format torch state dicts and Lightning ``.ckpt``
                   files (the ``torch:`` model source).
- ``data``:        the datasets, the fake data and the data module, the
                   port's own (numpy and torch loaders; nothing of JAX).
- ``train``:       train state, schedules, train/eval steps, callbacks,
                   loggers, checkpoints (``local:`` directories, resume),
                   profiling, image grids and the ``Trainer`` (with its
                   batch-size and LR probes).
- ``experiments``: the experiment entry point behind ``python -m satflow_tpu_torch.run``
                   and the TPE hyperparameter sweep behind ``--multirun``.
- ``parallel``:    process-group start-up (torchrun or the ``JAX_*`` triplet),
                   the device mesh and batch placement, ZeRO / FSDP sharding
                   and the H-sharded ConvLSTM rollout, on ``torch.distributed``.
- ``serve``:       inference sessions, micro-batching and the HTTP server.
- ``eval``:        per-lead-time MSE / SSIM / MS-SSIM curves and ensemble CRPS.
- ``baseline``:    the optical-flow and persistence baselines.
- ``tools``:       the two kernel-study entry points (``exp_tap9``, ``exp_cmajor``),
                   the kernels' timing scripts and the accuracy gate.
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
