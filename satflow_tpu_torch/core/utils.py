"""Core utilities of the port: config surgery, printing, logging, seeding.

Counterpart of ``satflow_tpu/core/utils.py``, whose module imports jax; the
pure-python parts are ported here and the batch-schema constants come from
this package's ``data/consts.py``.
"""

from __future__ import annotations

import logging
import random
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from satflow_tpu_torch.data.consts import DATETIME_FEATURE_NAMES, MINUTES_PER_STEP


def get_logger(name: str = __name__, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    return logger


log = get_logger(__name__)


def derived_input_channels(dataset_cfg: Dict[str, Any]) -> int:
    """Channel count the model sees after the datamodule stacks all sources:
    sat + NWP channels + topography + coordinates + datetime features."""
    inp = dataset_cfg.get("input_data", dataset_cfg)
    channels = 0
    sat = inp.get("sat_channels") or inp.get("satellite", {}).get("sat_channels")
    if sat:
        channels += len(sat) if isinstance(sat, (list, tuple)) else int(sat)
    nwp = inp.get("nwp_channels") or inp.get("nwp", {}).get("nwp_channels")
    if nwp:
        channels += len(nwp) if isinstance(nwp, (list, tuple)) else int(nwp)
    if inp.get("add_topographic_data", inp.get("topographic", False)):
        channels += 1
    if inp.get("add_coordinates", False):
        channels += 2
    if inp.get("add_datetime_features", False):
        channels += len(DATETIME_FEATURE_NAMES)
    return channels


def extras(config: Dict[str, Any]) -> Dict[str, Any]:
    """Cross-config consistency surgery, as the JAX ``extras``, with one
    difference:

    - ``model.forecast_steps`` / ``model.history_steps`` set
      ``datamodule.forecast_minutes`` / ``history_minutes`` (5-min cadence).
      The JAX ``extras`` only fills them where the datamodule has none, so a
      ``model.forecast_steps`` override against a datamodule config that
      names its minutes (``datamodule=fake``: 120) trains 2 predicted frames
      against 24 target frames and fails in the loss. Here the model's step
      counts win, with a warning when they replace a configured value.
    - ``model.input_channels`` is derived from the dataset configuration
      when present and not set.
    - ``debug: true`` forces ``fast_dev_run`` and a single-threaded loader.
    """
    config = dict(config)
    model = config.get("model", {})
    dm = dict(config.get("datamodule", {}))
    for steps_key, minutes_key in (("forecast_steps", "forecast_minutes"),
                                   ("history_steps", "history_minutes")):
        if steps_key in model:
            minutes = int(model[steps_key]) * MINUTES_PER_STEP
            if dm.get(minutes_key) not in (None, minutes):
                log.warning("datamodule.%s: %s -> %d, from model.%s=%s", minutes_key,
                            dm[minutes_key], minutes, steps_key, model[steps_key])
            dm[minutes_key] = minutes
    config["datamodule"] = dm

    dataset_cfg = config.get("configuration") or dm.get("configuration")
    if dataset_cfg and isinstance(model, dict) and "input_channels" not in model:
        try:
            model = dict(model)
            model["input_channels"] = derived_input_channels(dataset_cfg)
            config["model"] = model
        except (AttributeError, KeyError, TypeError, ValueError):
            log.warning("Could not derive model.input_channels from dataset config")

    if config.get("debug"):
        config["trainer"] = {**config.get("trainer", {}), "fast_dev_run": True}
        config["datamodule"] = {**config["datamodule"], "num_workers": 0}
    return config


def print_config(
    config: Dict[str, Any],
    fields: Sequence[str] = ("trainer", "model", "datamodule", "callbacks", "logger", "seed"),
) -> None:
    """Rich-tree config printout (plain pprint without ``rich``)."""
    try:
        import rich.syntax
        import rich.tree
        import yaml
    except ImportError:
        import pprint

        pprint.pprint({k: config.get(k) for k in fields if k in config})
        return
    tree = rich.tree.Tree(":gear: CONFIG")
    for field in fields:
        if field in config:
            tree.add(field).add(rich.syntax.Syntax(
                yaml.dump(config[field], default_flow_style=False), "yaml"))
    rich.print(tree)


def seed_everything(seed: Optional[int]) -> torch.Generator:
    """Seed python, numpy and torch; returns a torch generator of the seed."""
    seed = 0 if seed is None else int(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def log_hyperparameters(config: Dict[str, Any], model: torch.nn.Module, loggers) -> None:
    """Send the chosen hparams and parameter counts to every logger."""
    hparams: Dict[str, Any] = {k: config[k] for k in ("trainer", "model", "datamodule", "seed")
                               if k in config}
    hparams["params/total"] = sum(p.numel() for p in model.parameters())
    hparams["params/trainable"] = sum(p.numel() for p in model.parameters() if p.requires_grad)
    for lg in loggers or []:
        if hasattr(lg, "log_hyperparams"):
            lg.log_hyperparams(hparams)
