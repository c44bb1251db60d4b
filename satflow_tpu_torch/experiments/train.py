"""Experiment entry point of the port, counterpart of ``satflow_tpu/experiments/train.py``.

Takes the config composed from the JAX package's own ``configs/`` tree,
whose ``_target_`` paths name ``satflow_tpu`` classes, and builds each
node's port counterpart (:func:`instantiate`): models from the port's
registry, the datamodule, loggers and callbacks from the port's modules of
the same names. A target without a counterpart raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

import torch

from satflow_tpu_torch.core import config as config_lib
from satflow_tpu_torch.core.utils import get_logger, log_hyperparameters, seed_everything

log = get_logger(__name__)

def _counterpart(target: str):
    """The port's class for a ``_target_`` path of the JAX config tree."""
    if not target.startswith("satflow_tpu."):
        return config_lib._locate(target)
    *module, name = target.split(".")
    module = ".".join(module)
    if module.startswith("satflow_tpu.models."):
        from satflow_tpu_torch.core.registry import get_model
        import satflow_tpu_torch.models  # noqa: F401 - populate the registry

        return get_model(name)
    if target == "satflow_tpu.data.datamodule.SatFlowDataModule":
        from satflow_tpu_torch.data.datamodule import SatFlowDataModule

        return SatFlowDataModule
    if module in ("satflow_tpu.train.loggers", "satflow_tpu.train.callbacks",
                  "satflow_tpu.train.visualize"):
        ported = module.replace("satflow_tpu", "satflow_tpu_torch", 1)
        return getattr(importlib.import_module(ported), name)
    raise NotImplementedError(f"{target!r} has no counterpart in the port yet (see ROADMAP.md)")


# The keys that the default model config (model/convlstm.yaml) leaves in the
# model node of an experiment that picks another model in its own defaults
# list, which the config tree merges over the default one:
# experiment=unet_simple keeps the ConvLSTM's out_channels and hidden_dim,
# experiment=perceiver_simple those and conv_type, and
# experiment=nowcasting_gan_simple those and lr and loss. The JAX package
# raises a TypeError on those that the model does not take; here they are
# dropped from its node, by its family (the first listed class of its MRO),
# and any other key that a model does not take raises.
_DROPPED_DEFAULT_KEYS = {
    "StackedImageModel": ("out_channels", "hidden_dim"),  # keeps conv_type
    "Perceiver": ("out_channels", "hidden_dim", "conv_type"),
    "NowcastingGAN": ("out_channels", "hidden_dim", "lr", "loss"),  # keeps conv_type
}


def _model_node(node: Dict[str, Any]) -> Dict[str, Any]:
    """The composed model node without the default model's keys that its
    family does not take (:data:`_DROPPED_DEFAULT_KEYS`)."""
    cls = _counterpart(node["_target_"])
    families = [k.__name__ for k in getattr(cls, "__mro__", ())]
    keys = next((_DROPPED_DEFAULT_KEYS[f] for f in families if f in _DROPPED_DEFAULT_KEYS), ())
    dropped = [k for k in keys if k in node]
    if not dropped:
        return node
    log.warning("%s takes no %s (the default model config's): dropped", cls.__name__,
                ", ".join(dropped))
    return {k: v for k, v in node.items() if k not in dropped}


def instantiate(cfg: Any, **kwargs) -> Any:
    """:func:`satflow_tpu_torch.core.config.instantiate` with each target
    mapped to its port counterpart."""
    return config_lib.instantiate(cfg, _counterpart, **kwargs)


def train(config: Dict[str, Any]) -> Optional[float]:
    """Seed, instantiate, fit, test (unless ``fast_dev_run``); returns the
    ``optimized_metric`` for sweeps. Trains on the card unless
    ``trainer.device`` names another device."""
    from satflow_tpu_torch.parallel.distributed import is_rank_zero, maybe_initialize_distributed
    from satflow_tpu_torch.train.engine import Trainer

    trainer_conf = dict(config.get("trainer") or {})
    trainer_conf.pop("_target_", None)
    # the card unless the config asks for another device (trainer.device=cpu);
    # without a card the Trainer raises
    trainer_conf.setdefault("device", "cuda")
    # first, as in JAX: under torchrun or the JAX_* triplet, the process group
    # (NCCL for the card, gloo for trainer.device=cpu)
    maybe_initialize_distributed(backend=trainer_conf["device"])
    if config.get("debug") or trainer_conf.get("detect_anomaly"):
        torch.autograd.set_detect_anomaly(True)

    seed_everything(config.get("seed"))

    log.info("Instantiating datamodule <%s>", config["datamodule"].get("_target_"))
    datamodule = instantiate(config["datamodule"])
    log.info("Instantiating model <%s>", config["model"].get("_target_"))
    model = instantiate(_model_node(config["model"]))

    callbacks: List[Any] = []
    for cb_conf in (config.get("callbacks") or {}).values():
        if isinstance(cb_conf, dict) and "_target_" in cb_conf:
            log.info("Instantiating callback <%s>", cb_conf["_target_"])
            callbacks.append(instantiate(cb_conf))
    loggers: List[Any] = []  # rank 0 writes the logs
    for lg_conf in (config.get("logger") or {}).values() if is_rank_zero() else ():
        if isinstance(lg_conf, dict) and "_target_" in lg_conf:
            log.info("Instantiating logger <%s>", lg_conf["_target_"])
            loggers.append(instantiate(lg_conf))

    trainer = Trainer(**trainer_conf, callbacks=callbacks, logger=loggers,
                      seed=config.get("seed", 0))
    if trainer_conf.get("auto_lr_find") or trainer_conf.get("auto_scale_batch_size"):
        log.info("Running trainer.tune (reference train.py:81-83)")
        trainer.tune(model, datamodule,
                     auto_lr_find=bool(trainer_conf.get("auto_lr_find")),
                     auto_scale_batch_size=bool(trainer_conf.get("auto_scale_batch_size")))
    log.info("Starting training")
    trainer.fit(model, datamodule)
    log_hyperparameters(config, model, loggers)
    if not trainer_conf.get("fast_dev_run"):
        log.info("Starting testing")
        trainer.test(model, datamodule)
        for lg in loggers:  # the engine finalizes at the end of fit only
            lg.finalize()
    for cb in callbacks:
        best = getattr(cb, "best_model_path", None)
        if best:
            log.info("Best checkpoint: %s", best)

    metric = config.get("optimized_metric")
    if metric and metric in trainer.callback_metrics:
        return float(trainer.callback_metrics[metric])
    return None
