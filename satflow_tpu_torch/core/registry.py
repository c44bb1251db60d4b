"""Model registry: ``register_model`` / ``create_model`` / ``get_model`` / ``list_models``.

Same API as ``satflow_tpu/core/registry.py``, with a registry dict of its own:
the JAX registry is process-wide and keyed by lowercase class name, so a
PyTorch ``EncoderDecoderConvLSTM`` registered there would clash with the JAX
one as soon as both packages are imported.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Optional, Type

_MODEL_REGISTRY: Dict[str, Type] = {}

# checkpoint sources of the JAX registry that the port does not load yet
_CHECKPOINT_SOURCES = ("local", "torch", "hf_hub")


def _model_entrypoint(name: str) -> Type:
    if name not in _MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {name!r}. Registered models: {sorted(_MODEL_REGISTRY)}"
        )
    return _MODEL_REGISTRY[name]


def register_model(cls: Optional[Type] = None, *, name: Optional[str] = None):
    """Class decorator adding a model class to the port's registry, keyed by
    its lowercase class name unless ``name=`` is given."""

    def _register(cls: Type) -> Type:
        key = name or cls.__name__.lower()
        if key in _MODEL_REGISTRY and _MODEL_REGISTRY[key] is not cls:
            raise ValueError(f"Model name {key!r} already registered")
        _MODEL_REGISTRY[key] = cls
        return cls

    if cls is None:
        return _register
    return _register(cls)


def list_models(filter: str = "") -> List[str]:
    """Sorted registered model names, optionally fnmatch-filtered."""
    names = sorted(_MODEL_REGISTRY)
    if filter:
        names = [n for n in names if fnmatch.fnmatch(n, filter)]
    return names


def get_model(name: str) -> Type:
    """Return the model *class* for a registry name."""
    return _model_entrypoint(name.lower())


def split_model_name(name: str):
    """Split ``source:name`` prefixes (e.g. ``local:/path/to/ckpt``)."""
    if ":" in name:
        source, rest = name.split(":", 1)
        return source, rest
    return "", name


def create_model(name: str, pretrained: bool = False, checkpoint_path: str = "", **kwargs):
    """Instantiate a model by registry name.

    Checkpoint sources (``local:``, ``torch:``, ``hf_hub:``, ``pretrained``)
    are not ported yet; load weights with
    :func:`satflow_tpu_torch.interop.jax_weights.load_npz` instead.
    """
    source, base = split_model_name(name)
    if source in _CHECKPOINT_SOURCES or pretrained or checkpoint_path:
        raise NotImplementedError(
            f"loading {name!r} from a checkpoint is not ported yet "
            "(ROADMAP queue 1 item 6); use interop.jax_weights.load_npz"
        )
    if source:
        raise ValueError(f"unknown model source {source!r} in {name!r}")
    return _model_entrypoint(base.lower())(**kwargs)
