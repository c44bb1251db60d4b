"""Load reference-format Lightning ``.ckpt`` files into the port's models.

Counterpart of ``satflow_tpu/interop/lightning.py``. The reference's
checkpoints are pytorch-lightning files holding ``state_dict`` and
``hyper_parameters`` (written by ``save_hyperparameters()``, e.g. reference
satflow/models/conv_lstm.py:33). ``create_model("torch:<path.ckpt>")``
rebuilds the model from those hyperparameters and converts the weights
through the model's registered converter
(:mod:`satflow_tpu_torch.interop.torch_weights`).

The file is read with ``torch.load(weights_only=True)``: tensors and plain
containers only. A file that pickles other objects (a Lightning
``AttributeDict`` of hyperparameters, say) raises where the JAX loader
would unpickle it.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Callable, Dict

import torch

# registry name -> converter(model, state_dict), which loads the weights into
# the model
_CONVERTERS: Dict[str, Callable] = {}


def register_converter(name: str):
    """Decorator registering a state_dict converter for a registry name."""

    def _register(fn):
        _CONVERTERS[name.lower()] = fn
        return fn

    return _register


def _default_converters():
    # setdefault: a converter the user registered for another name stays
    from satflow_tpu_torch.interop.torch_weights import load_torch_convlstm

    _CONVERTERS.setdefault("encoderdecoderconvlstm", load_torch_convlstm)


def load_lightning_checkpoint(
    path: str,
    model_name: str = "encoderdecoderconvlstm",
    **overrides: Any,
):
    """Build a model from a Lightning ``.ckpt`` (weights and
    ``hyper_parameters``).

    The checkpoint's hyperparameters seed the constructor (``overrides``
    win); the state_dict goes through the model's registered converter.
    Returns the model, on the CPU, with ``model.restored_from`` set.
    """
    from satflow_tpu_torch.core.registry import get_model
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    _default_converters()
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("state_dict", ckpt)
    hparams = dict(ckpt.get("hyper_parameters", {}) or {})
    hparams.update(overrides)

    name = str(hparams.pop("model_name", model_name)).lower()
    if name not in _CONVERTERS:
        raise NotImplementedError(
            f"No torch-weight converter registered for {name!r}; available: "
            f"{sorted(_CONVERTERS)}"
        )
    cls = get_model(name)
    sig = inspect.signature(cls.__init__)
    model = cls(**{k: v for k, v in hparams.items() if k in sig.parameters})
    _CONVERTERS[name](model, state_dict)
    model.restored_from = os.path.abspath(path)
    return model
