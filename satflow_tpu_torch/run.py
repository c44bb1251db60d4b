"""CLI entry of the port: ``python -m satflow_tpu_torch.run [overrides...]``.

Composes the JAX package's config tree (``satflow_tpu/configs``) with the
same Hydra-style overrides as ``python -m satflow_tpu.run``, applies
``extras``, enters the per-run directory and trains through the port; with
``--multirun`` (or ``-m``) and an ``hparams_search`` group it runs the sweep
(:mod:`satflow_tpu_torch.experiments.sweep`) instead. The default config's
callbacks write ``checkpoints/best``, ``checkpoints/last`` and
``artifacts/final`` in the run directory.

It trains on the card unless ``trainer.device=cpu`` asks for the CPU.

Examples:
    python -m satflow_tpu_torch.run
    python -m satflow_tpu_torch.run model=convlstm datamodule=fake trainer=minimal \\
        model.hidden_dim=8 model.forecast_steps=2 trainer.max_steps=2 trainer.device=cpu
    python -m satflow_tpu_torch.run --multirun hparams_search=convlstm_optuna
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import List, Optional

from satflow_tpu_torch.core.config import compose, default_config_dir
from satflow_tpu_torch.core.utils import extras, get_logger, print_config

log = get_logger(__name__)


def main(argv: Optional[List[str]] = None) -> Optional[float]:
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = "--multirun" in argv or "-m" in argv
    argv = [a for a in argv if a not in ("--multirun", "-m")]
    config = extras(compose(default_config_dir(), "config.yaml", argv))
    _enter_run_dir(config)
    if config.get("print_config", True):
        print_config(config)

    if multirun and config.get("hparams_search"):
        from satflow_tpu_torch.experiments.sweep import sweep

        return sweep(config)

    from satflow_tpu_torch.experiments.train import train

    return train(config)


def _enter_run_dir(config) -> None:
    """Chdir into ``<work_dir>/<date>/<time>``; ``work_dir=null`` stays put."""
    work_dir = config.get("work_dir")
    if not work_dir:
        return
    now = datetime.datetime.now()
    run_dir = os.path.join(work_dir, now.strftime("%Y-%m-%d"), now.strftime("%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    log.info("Run dir: %s", os.path.abspath(run_dir))
    os.chdir(run_dir)


if __name__ == "__main__":
    main()
