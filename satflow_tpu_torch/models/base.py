"""BaseModel: the task wrapper every model of the port derives from.

Counterpart of ``satflow_tpu/models/base.py``. The JAX wrapper owns a pure
flax module and takes its variables as an argument; here the wrapper is an
``nn.Module`` that owns its core as the child ``module`` and holds the
weights itself. It gives the engine what the JAX one does: the batch
preparation, ``loss`` (the criterion plus the per-lead-time ``frame_loss``
metric), ``make_optimizer`` (Adam) and the metric-key convention
(:func:`expand_frame_metrics`).
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn.parameter import is_lazy

from satflow_tpu_torch.nn.losses import get_loss


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
        self.criterion = get_loss(loss)
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

    def eval_batch(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, y) for metric evaluation: y must be time-major (B, T, H, W, C).
        Defaults to :meth:`prepare_batch`; a model whose training target is
        laid out otherwise overrides it."""
        return self.prepare_batch(batch)

    @classmethod
    def from_config(cls, config: Dict[str, Any]):
        return cls(**config)

    def state_dict_from_flax(self, variables) -> Dict[str, torch.Tensor]:
        """The core's state_dict from the JAX model's flax variables (numpy
        leaves); each model names its converter in
        :mod:`satflow_tpu_torch.interop.jax_weights`."""
        raise NotImplementedError(f"{type(self).__name__} has no flax weight converter")

    def materialize(self, batch) -> None:
        """Create the parameters whose shapes come from the data (lazy
        modules) from one sample of ``batch``: one forward in eval mode
        without grad, so that nothing is recorded and no running statistic
        moves. A no-op when every parameter exists."""
        if not any(is_lazy(p) for p in self.parameters()):
            return
        x, _ = self.prepare_batch(batch)
        training = self.training
        self.eval()
        with torch.no_grad():
            # one sample: of the tensor, or of each modality of a dict input
            self({k: v[:1] for k, v in x.items()} if isinstance(x, dict) else x[:1])
        self.train(training)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """Forward through the core; ``kwargs`` go to the core."""
        return self.module(x, **kwargs)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in ``dtype`` (bf16 for ``precision="bf16"``) with the f32
        weights kept as they are: nothing is re-initialised."""
        self.dtype = dtype
        self.module.set_compute_dtype(dtype)

    def loss(self, batch, **kwargs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one batch, ``kwargs`` to the core: the JAX
        ``loss``, with the weights held by the module."""
        x, y = self.prepare_batch(batch)
        y_hat = self(x, **kwargs)
        loss = self.criterion(y_hat, y)
        return loss, {"loss": loss, **self.frame_metrics(y_hat, y)}

    @torch.no_grad()
    def frame_metrics(self, y_hat: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-lead-time loss vector ``frame_loss`` (T,): the configured
        criterion on each frame (the JAX vmap over the lead-time axis), in
        one pass where the criterion has a ``per_frame`` form (SSIM's)."""
        if y_hat.dim() >= 5 and y_hat.shape[1] == y.shape[1]:
            per_frame = getattr(self.criterion, "per_frame", None)
            if per_frame is not None:
                return {"frame_loss": per_frame(y_hat, y)}
            frames = [self.criterion(y_hat[:, f], y[:, f]) for f in range(y.shape[1])]
            return {"frame_loss": torch.stack(frames)}
        return {}

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adam at ``self.lr`` with optax's ``adam`` defaults (b1 0.9, b2
        0.999, eps 1e-8 outside the square root, no eps_root, the same bias
        correction)."""
        return torch.optim.Adam(self.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

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


def expand_frame_metrics(metrics: Dict[str, Any], split: str) -> Dict[str, float]:
    """Flatten metrics into the logging keys of the JAX package: scalars
    become ``{split}/{name}``, a ``frame_loss`` vector
    ``{split}/frame_{f}_loss``. Reads the values to the host."""
    out: Dict[str, float] = {}
    for k, v in metrics.items():
        v = torch.as_tensor(v).detach().float().cpu()
        if k.endswith("frame_loss") and v.dim() == 1:
            prefix = k[: -len("frame_loss")]
            for f, val in enumerate(v.tolist()):
                out[f"{split}/{prefix}frame_{f}_loss"] = float(val)
        elif v.dim() == 0:
            out[f"{split}/{k}"] = float(v)
    return out


def _jsonable(value) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
