"""Model registry: ``register_model`` / ``create_model`` / ``get_model`` / ``list_models``.

Same API as ``satflow_tpu/core/registry.py``, with a registry dict of its own:
the JAX registry is process-wide and keyed by lowercase class name, so a
PyTorch ``EncoderDecoderConvLSTM`` registered there would clash with the JAX
one as soon as both packages are imported.

``create_model`` takes the JAX registry's sources: ``local:<dir>`` (a
checkpoint directory of :mod:`satflow_tpu_torch.train.checkpoint`),
``torch:<file.ckpt>`` (a reference-format Lightning checkpoint,
:mod:`satflow_tpu_torch.interop.lightning`) and ``hf_hub:<repo>`` (either of
the two, downloaded first).
"""

from __future__ import annotations

import fnmatch
import glob
import os
from typing import Dict, List, Optional, Type

_MODEL_REGISTRY: Dict[str, Type] = {}


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
    """Instantiate a model by registry name, or load one from a source.

    ``local:<dir>`` rebuilds the model from a checkpoint directory and loads
    its weights; ``torch:<file.ckpt>`` builds it from a Lightning file's
    ``hyper_parameters`` (``kwargs`` override them) and converts its
    ``state_dict``; ``hf_hub:<repo>`` downloads the repository with
    ``huggingface_hub.snapshot_download`` (network needed) and loads it as
    ``local:`` when it holds ``hparams.json``, else its first ``.ckpt`` or
    ``.pt`` as ``torch:``. A registry name with ``pretrained=True`` and
    ``checkpoint_path`` loads that checkpoint's weights into the new model.
    A model loaded from a source comes back on the CPU.
    """
    source, base = split_model_name(name)
    if source == "hf_hub":
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise ImportError("hf_hub: model names need the huggingface_hub package") from e
        base = snapshot_download(repo_id=base)
        source = "local"
        if not os.path.exists(os.path.join(base, "hparams.json")):
            # not a checkpoint directory of this package: the reference's hub
            # checkpoints are Lightning files
            ckpts = glob.glob(os.path.join(base, "*.ckpt")) + glob.glob(os.path.join(base, "*.pt"))
            if ckpts:
                base, source = ckpts[0], "torch"
    if source == "local":
        from satflow_tpu_torch.train.checkpoint import load_model_from_checkpoint

        return load_model_from_checkpoint(base)
    if source == "torch":
        from satflow_tpu_torch.interop.lightning import load_lightning_checkpoint

        return load_lightning_checkpoint(base, **kwargs)
    if source:
        raise ValueError(f"unknown model source {source!r} in {name!r}")
    model = _model_entrypoint(base.lower())(**kwargs)
    if pretrained and checkpoint_path:
        from satflow_tpu_torch.train.checkpoint import restore_params_into

        restore_params_into(model, checkpoint_path)
    return model
