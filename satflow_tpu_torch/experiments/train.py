"""Experiment entry point of the port, counterpart of ``satflow_tpu/experiments/train.py``.

Takes the config composed from the JAX package's own ``configs/`` tree,
whose ``_target_`` paths name ``satflow_tpu`` classes, and builds each
node's port counterpart (:func:`instantiate`): models from the port's
registry, the datamodule as the torch adapter, loggers and the
framework-free callbacks as they are. A target without a counterpart
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch

from satflow_tpu_torch.core.utils import get_logger, log_hyperparameters, seed_everything

log = get_logger(__name__)

_PORTED_CALLBACKS = ("EarlyStopping", "LearningRateMonitor")
_UNPORTED_CALLBACKS = {
    "ModelCheckpoint": "ROADMAP queue 1 item 6 (checkpoints)",
    "ModelArtifactLogger": "ROADMAP queue 1 item 6 (checkpoints)",
}
# JAX model modules without a port yet, by the ROADMAP item that ports them
_UNPORTED_MODELS = {
    "perceiver": 10, "hf_perceiver": 10, "dgmr": 11, "cloudgan": 11,
    "pix2pix": 11, "gan_base": 11,
}


def _counterpart(target: str):
    """The port's class for a ``_target_`` path of the JAX config tree."""
    if not target.startswith("satflow_tpu."):
        from satflow_tpu.core.config import _locate

        return _locate(target)
    *module, name = target.split(".")
    module = ".".join(module)
    if module.startswith("satflow_tpu.models."):
        from satflow_tpu_torch.core.registry import get_model
        import satflow_tpu_torch.models  # noqa: F401 - populate the registry

        try:
            return get_model(name)
        except KeyError:
            item = _UNPORTED_MODELS.get(module.rsplit(".", 1)[-1], 12)
            raise NotImplementedError(
                f"model {target!r} is not ported yet (ROADMAP queue 1 item {item})"
            ) from None
    if target == "satflow_tpu.data.datamodule.SatFlowDataModule":
        from satflow_tpu_torch.data.datamodule import SatFlowDataModule

        return SatFlowDataModule
    if module == "satflow_tpu.train.loggers" or (
        module == "satflow_tpu.train.callbacks" and name in _PORTED_CALLBACKS
    ):
        from satflow_tpu_torch.core.adapters import framework_free

        return getattr(framework_free(module), name)
    if module == "satflow_tpu.train.callbacks" and name in _UNPORTED_CALLBACKS:
        raise NotImplementedError(
            f"callback {name} is not ported yet ({_UNPORTED_CALLBACKS[name]})"
        )
    raise NotImplementedError(f"{target!r} has no counterpart in the port yet (see ROADMAP.md)")


def instantiate(cfg: Any, **kwargs) -> Any:
    """``satflow_tpu.core.config.instantiate`` with each target mapped to
    its port counterpart."""
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}
    cfg = dict(cfg)
    cls = _counterpart(cfg.pop("_target_"))
    partial = cfg.pop("_partial_", False)
    cfg.pop("_convert_", None)
    built = {k: instantiate(v) for k, v in cfg.items()}
    built.update(kwargs)
    return functools.partial(cls, **built) if partial else cls(**built)


def train(config: Dict[str, Any]) -> Optional[float]:
    """Seed, instantiate, fit, test (unless ``fast_dev_run``); returns the
    ``optimized_metric`` for sweeps."""
    from satflow_tpu_torch.train.engine import Trainer

    trainer_conf = dict(config.get("trainer") or {})
    trainer_conf.pop("_target_", None)
    if trainer_conf.pop("auto_lr_find", False) or trainer_conf.pop("auto_scale_batch_size", False):
        raise NotImplementedError(
            "trainer.tune (auto_lr_find, auto_scale_batch_size) is not ported yet "
            "(ROADMAP queue 1 item 6)"
        )
    if config.get("debug") or trainer_conf.get("detect_anomaly"):
        torch.autograd.set_detect_anomaly(True)

    seed_everything(config.get("seed"))

    log.info("Instantiating datamodule <%s>", config["datamodule"].get("_target_"))
    datamodule = instantiate(config["datamodule"])
    log.info("Instantiating model <%s>", config["model"].get("_target_"))
    model = instantiate(config["model"])

    callbacks: List[Any] = []
    for cb_conf in (config.get("callbacks") or {}).values():
        if isinstance(cb_conf, dict) and "_target_" in cb_conf:
            log.info("Instantiating callback <%s>", cb_conf["_target_"])
            callbacks.append(instantiate(cb_conf))
    loggers: List[Any] = []
    for lg_conf in (config.get("logger") or {}).values():
        if isinstance(lg_conf, dict) and "_target_" in lg_conf:
            log.info("Instantiating logger <%s>", lg_conf["_target_"])
            loggers.append(instantiate(lg_conf))

    trainer = Trainer(**trainer_conf, callbacks=callbacks, logger=loggers,
                      seed=config.get("seed", 0))
    log.info("Starting training")
    trainer.fit(model, datamodule)
    log_hyperparameters(config, model, loggers)
    if not trainer_conf.get("fast_dev_run"):
        log.info("Starting testing")
        trainer.test(model, datamodule)
        for lg in loggers:  # the engine finalizes at the end of fit only
            lg.finalize()

    metric = config.get("optimized_metric")
    if metric and metric in trainer.callback_metrics:
        return float(trainer.callback_metrics[metric])
    return None
