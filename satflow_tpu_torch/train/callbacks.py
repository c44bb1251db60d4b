"""Callbacks: checkpoint best/last, early stopping, LR monitor, model artifacts.

Counterpart of ``satflow_tpu/train/callbacks.py`` (the reference's callback
group, reference satflow/configs/callbacks/default.yaml): ModelCheckpoint
monitoring ``val/loss`` with save_top_k=1 and save_last, EarlyStopping
patience 10, LearningRateMonitor, and ModelArtifactLogger, which writes the
final checkpoint (the stand-in for the external NeptuneModelLogger).
Checkpoints are :mod:`satflow_tpu_torch.train.checkpoint` directories.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional


class Callback:
    def on_train_start(self, engine) -> None: ...

    def on_train_batch_end(self, engine, metrics: Dict[str, float], step: int) -> None: ...

    def on_validation_end(self, engine, metrics: Dict[str, float], epoch: int) -> None: ...

    def on_preemption(self, engine) -> None:
        """Fired once when fit stops due to SIGTERM (engine.handle_preemption)."""

    def on_train_end(self, engine) -> None: ...


class ModelCheckpoint(Callback):
    """Save the best (by the monitored metric) and the last checkpoint."""

    def __init__(
        self,
        monitor: str = "val/loss",
        dirpath: str = "checkpoints/",
        save_top_k: int = 1,
        save_last: bool = True,
        mode: str = "min",
        verbose: bool = False,
        filename: str = "best",
    ):
        self.monitor = monitor
        self.dirpath = dirpath
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.mode = mode
        self.verbose = verbose
        self.filename = filename
        self.best_score = math.inf if mode == "min" else -math.inf
        self.best_model_path: Optional[str] = None

    def _improved(self, value: float) -> bool:
        return value < self.best_score if self.mode == "min" else value > self.best_score

    def on_validation_end(self, engine, metrics: Dict[str, float], epoch: int) -> None:
        from satflow_tpu_torch.train.checkpoint import save_checkpoint

        value = metrics.get(self.monitor)
        if value is not None and self.save_top_k > 0 and self._improved(value):
            self.best_score = value
            path = os.path.join(self.dirpath, self.filename)
            save_checkpoint(path, engine.state, engine.model, metrics=metrics)
            self.best_model_path = path
        if self.save_last:
            save_checkpoint(os.path.join(self.dirpath, "last"), engine.state, engine.model,
                            metrics=metrics)

    def on_preemption(self, engine) -> None:
        """Emergency ``last`` checkpoint, so that a preempted run resumes with
        its optimizer state and step counters (``resume_from_checkpoint``)."""
        from satflow_tpu_torch.train.checkpoint import save_checkpoint

        save_checkpoint(os.path.join(self.dirpath, "last"), engine.state, engine.model,
                        metrics=dict(engine.callback_metrics))


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
    """Write the final checkpoint to ``<dirpath>/final`` at the end of fit
    (the NeptuneModelLogger stand-in)."""

    def __init__(self, dirpath: str = "artifacts/"):
        self.dirpath = dirpath

    def on_train_end(self, engine) -> None:
        from satflow_tpu_torch.train.checkpoint import save_checkpoint

        save_checkpoint(os.path.join(self.dirpath, "final"), engine.state, engine.model)
