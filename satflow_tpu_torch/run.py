"""CLI entry of the port: ``python -m satflow_tpu_torch.run [overrides...]``.

Composes the JAX package's config tree (``satflow_tpu/configs``) with the
same Hydra-style overrides as ``python -m satflow_tpu.run``, applies
``extras``, enters the per-run directory and trains through the port.

Examples (``trainer.device=cuda`` trains on the card):
    python -m satflow_tpu_torch.run model=convlstm datamodule=fake trainer=minimal \\
        callbacks=none model.hidden_dim=8 model.forecast_steps=2 trainer.max_steps=2
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import List, Optional

from satflow_tpu.core.config import compose, default_config_dir
from satflow_tpu_torch.core.utils import extras, get_logger, print_config

log = get_logger(__name__)


def main(argv: Optional[List[str]] = None) -> Optional[float]:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--multirun" in argv or "-m" in argv:
        raise NotImplementedError("--multirun sweeps are not ported yet (ROADMAP queue 1 item 6)")
    config = extras(compose(default_config_dir(), "config.yaml", argv))
    _enter_run_dir(config)
    if config.get("print_config", True):
        print_config(config)

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
