"""Checkpoints: save and restore a train state with the model's configuration.

Counterpart of ``satflow_tpu/train/checkpoint.py``. A checkpoint is a
directory holding

- ``hparams.json``: ``{"hparams": model.hparams(), "metrics": {...}}``, the
  file the JAX package writes, key for key, so that
  ``create_model("local:<dir>")`` can rebuild the model;
- ``state.pt``: :meth:`TrainState.state_dict <satflow_tpu_torch.train.state.TrainState.state_dict>`
  through ``torch.save``: the model's ``state_dict`` (BatchNorm buffers
  included), the optimizer's (Adam's moments, the schedule's count), ``step``
  and the gradient accumulation's ``mini_step`` and running mean; for a GAN
  (:class:`~satflow_tpu_torch.train.state.GANTrainState`) both networks (the
  spectral vectors too), both optimizers and the noise generator's state. It is read
  back with ``torch.load(weights_only=True)``: tensors and plain containers,
  nothing else is unpickled.

The JAX package writes its state as an Orbax directory (``state/``). The
port does not read those: Orbax imports jax, which the port never does. JAX
weights enter the port through the flat ``.npz`` of
:mod:`satflow_tpu_torch.interop.jax_weights`.

The JAX package adapts weights saved under another head layout
(``head_in_scan``) on load. The port needs no adapter: its ConvLSTM's
parameter names do not depend on ``head_in_scan`` or ``remat_chunk``, so a
checkpoint of either layout loads into the other as it is.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
from typing import Any, Dict, Optional

import torch

HPARAMS_FILE = "hparams.json"
STATE_FILE = "state.pt"

log = logging.getLogger(__name__)


def save_checkpoint(path: str, state, model, metrics: Optional[Dict[str, float]] = None) -> None:
    """Save a train state and the model's hyperparameters under ``path``.

    The state file is written beside its final name and renamed over it, so
    that a run stopped mid-save (a second SIGTERM) leaves the previous
    checkpoint whole.
    """
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    torch.save(state.state_dict(), target + ".tmp")
    os.replace(target + ".tmp", target)
    meta = {"hparams": model.hparams(), "metrics": metrics or {}}
    with open(os.path.join(path, HPARAMS_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=float)


def restore_checkpoint(path: str, map_location: Any = "cpu") -> Dict[str, Any]:
    """The saved state (:meth:`TrainState.state_dict`'s dict), its tensors on
    ``map_location``."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=map_location, weights_only=True)


def resume_state(state, path: str):
    """Load a checkpoint into an already-built train state (the engine's
    ``resume_from_checkpoint``): weights, buffers, optimizer state,
    accumulation and step (a GAN's: both networks and optimizers, and the
noise generator). Returns ``(state, global step)``.

    Where the optimizer's structure differs from the saved one, only the
    weights, buffers and step are restored, with a warning, as the JAX
    package does when its structured restore fails: other parameter groups,
    or accumulation switched on or off (``accumulate_grad_batches`` 1 on
    one side only; JAX wraps its optimizer in ``MultiSteps`` for k > 1
    only). Another k > 1 keeps everything, the accumulation's ``mini_step``
    and running mean included, as ``MultiSteps``' state does in JAX.
    """
    device = state.params()[0].device
    payload = restore_checkpoint(path, map_location=device)
    weights_only = (payload["accumulate_grad_batches"] > 1) != (state.accumulate_grad_batches > 1)
    reason = "accumulate_grad_batches switched between 1 and k > 1"
    if not weights_only:
        try:
            state.load_state_dict(payload)
        except (ValueError, KeyError) as e:  # the optimizer's param groups differ
            weights_only, reason = True, f"{type(e).__name__}: {e}"
    if weights_only:
        log.warning("resume: the optimizer state does not fit (%s); restoring the weights "
                    "and step only: optimizer moments and schedule position will RESET", reason)
        state.load_state_dict(payload, weights_only=True)
    # a GAN's global step is its rounds (the JAX engine takes its `step`, the
    # discriminator updates, and so resumes a disc_steps=2 run too far on)
    return state, getattr(state, "rounds", state.step)


def load_model_from_checkpoint(path: str, map_location: Any = "cpu"):
    """Rebuild a model from a checkpoint directory and load its weights.

    Parameters whose shapes come from the data (MetNet's lazy first conv)
    take their shapes from the saved tensors. The model comes back on
    ``map_location`` with ``model.restored_from`` set to ``path``, which
    :class:`~satflow_tpu_torch.serve.session.InferenceSession` reads as
    "serve the weights this model holds".
    """
    from satflow_tpu_torch.core.registry import create_model
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    path = os.path.abspath(path)
    with open(os.path.join(path, HPARAMS_FILE)) as f:
        meta = json.load(f)
    hparams = dict(meta["hparams"])
    cls_name = hparams.pop("class")
    model = create_model(cls_name.lower(), **_ctor_kwargs(cls_name, hparams))
    return restore_params_into(model, path, map_location)


def restore_params_into(model, path: str, map_location: Any = "cpu"):
    """Load a checkpoint's weights and buffers into ``model`` (built by the
    caller); sets ``model.restored_from``. Returns the model."""
    model.load_state_dict(restore_checkpoint(path, map_location)["model"])
    model.restored_from = os.path.abspath(path)
    return model


def _ctor_kwargs(cls_name: str, hparams: Dict[str, Any]) -> Dict[str, Any]:
    """The saved hparams that the class's constructor takes (``output_channels``
    renamed to ``out_channels`` where the constructor says so)."""
    from satflow_tpu_torch.core.registry import get_model

    sig = inspect.signature(get_model(cls_name.lower()).__init__)
    names = set(sig.parameters)
    mapped = dict(hparams)
    if "output_channels" in mapped and "out_channels" in names:
        mapped["out_channels"] = mapped.pop("output_channels")
    if any(p.kind is p.VAR_KEYWORD for p in sig.parameters.values()):
        return mapped
    return {k: v for k, v in mapped.items() if k in names}
