"""BaseModel: the task wrapper every model of the port derives from.

Counterpart of ``satflow_tpu/models/base.py``. The JAX wrapper owns a pure
flax module and takes its variables as an argument; here the wrapper is an
``nn.Module`` that owns its core as the child ``module`` and holds the
weights itself. Forward only for now: ``loss`` and ``make_optimizer`` come
with the training port (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Dict, Tuple

import torch
from torch import nn


class BaseModel(nn.Module):
    """Task wrapper: core module + hyperparameters + batch preparation."""

    #: set True in GAN subclasses (none are ported yet)
    is_gan: bool = False

    def __init__(
        self,
        forecast_steps: int = 48,
        lr: float = 1e-3,
        loss: str = "mse",
        visualize: bool = False,
        input_channels: int = 12,
        output_channels: int = 12,
        pretrained: bool = False,
    ):
        super().__init__()
        self.forecast_steps = forecast_steps
        self.lr = lr
        self.visualize = visualize
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.pretrained = pretrained
        self.loss_name = loss if isinstance(loss, str) else getattr(loss, "__name__", "custom")
        self.module = self.build_module()

    def build_module(self) -> nn.Module:
        raise NotImplementedError

    def prepare_batch(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Map the datamodule's (x_dict, y_dict) to model (x, y) tensors."""
        x, y = batch
        if isinstance(x, dict):
            x = x["sat_data"]
        if isinstance(y, dict):
            y = y["sat_data"]
        return x, y

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """Inference forward through the core; ``kwargs`` go to the core."""
        return self.module(x, **kwargs)

    def hparams(self) -> Dict[str, Any]:
        """Serializable hyperparameters, read back from the subclass
        ``__init__`` signatures (the same keys as the JAX ``hparams``)."""
        attr_aliases = {"out_channels": "output_channels", "loss": "loss_name"}
        hp: Dict[str, Any] = {"class": type(self).__name__}
        seen = set()
        for klass in type(self).__mro__:
            if klass is BaseModel:
                break
            if "__init__" not in vars(klass):
                continue
            for name, p in inspect.signature(klass.__init__).parameters.items():
                if name in seen or p.kind in (p.VAR_KEYWORD, p.VAR_POSITIONAL):
                    continue
                seen.add(name)
                if name in ("self", "dtype"):
                    continue
                attr = attr_aliases.get(name, name)
                if hasattr(self, attr):
                    value = getattr(self, attr)
                    if not callable(value) and _jsonable(value):
                        hp[name] = value
        return hp


def _jsonable(value) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
