"""Callbacks: early stopping and the LR monitor; the checkpoint callbacks raise.

Counterpart of ``satflow_tpu/train/callbacks.py`` (the reference's callback
group, reference satflow/configs/callbacks/default.yaml): EarlyStopping
patience 10 and LearningRateMonitor are carried over as they are.
ModelCheckpoint and ModelArtifactLogger keep their names, so that the config
tree's ``_target_`` strings resolve, and raise ``NotImplementedError`` until
checkpoints are ported.
"""

from __future__ import annotations

import math
from typing import Dict


class Callback:
    def on_train_start(self, engine) -> None: ...

    def on_train_batch_end(self, engine, metrics: Dict[str, float], step: int) -> None: ...

    def on_validation_end(self, engine, metrics: Dict[str, float], epoch: int) -> None: ...

    def on_preemption(self, engine) -> None:
        """Fired once when fit stops due to SIGTERM (engine.handle_preemption)."""

    def on_train_end(self, engine) -> None: ...


_CHECKPOINTS = "checkpoints are not ported yet (ROADMAP queue 1 item 6)"


class ModelCheckpoint(Callback):
    """Best/last checkpoints by a monitored metric; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"callback ModelCheckpoint is not ported yet: {_CHECKPOINTS}")


class EarlyStopping(Callback):
    """Stop fit when the monitored metric stops improving (patience epochs)."""

    def __init__(
        self,
        monitor: str = "val/loss",
        patience: int = 10,
        mode: str = "min",
        min_delta: float = 0.0,
    ):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def on_validation_end(self, engine, metrics: Dict[str, float], epoch: int) -> None:
        value = metrics.get(self.monitor)
        if value is None:
            return
        improved = (
            value < self.best - self.min_delta
            if self.mode == "min"
            else value > self.best + self.min_delta
        )
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                engine.should_stop = True


class LearningRateMonitor(Callback):
    """Log the current LR each step (reference train.py:48)."""

    def __init__(self, logging_interval: str = "step"):
        self.logging_interval = logging_interval

    def on_train_batch_end(self, engine, metrics: Dict[str, float], step: int) -> None:
        lr = engine.current_lr()
        if lr is not None:
            engine.log_metrics({"lr": lr}, step)


class ModelArtifactLogger(Callback):
    """Copy the final checkpoint somewhere (NeptuneModelLogger stand-in); not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"callback ModelArtifactLogger is not ported yet: {_CHECKPOINTS}")
