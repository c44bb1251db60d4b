"""Metric loggers: CSV, TensorBoard, and an in-memory history.

Parity with the reference's logger group (reference satflow/configs/logger/):
csv.yaml → CSVLogger, tensorboard.yaml → TensorBoardLogger (via tensorboardX),
neptune.yaml → NeptuneLogger (import-gated stub; Neptune isn't installable here).
Loggers are combinable like the reference's many_loggers.yaml.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, List, Optional


class BaseLogger:
    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def log_hyperparams(self, hparams: Dict[str, Any]) -> None:
        pass

    def log_image(self, tag: str, image, step: int) -> None:
        pass

    def finalize(self) -> None:
        pass


class HistoryLogger(BaseLogger):
    """Keeps every logged dict in memory; the engine's source for callback_metrics."""

    def __init__(self):
        self.history: List[Dict[str, float]] = []
        self.latest: Dict[str, float] = {}

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        entry = {"step": step, **metrics}
        self.history.append(entry)
        self.latest.update(metrics)


class CSVLogger(BaseLogger):
    """Append metrics rows to ``<save_dir>/metrics.csv`` (logger/csv.yaml)."""

    def __init__(self, save_dir: str = "logs/csv", name: str = "default"):
        self.dir = os.path.join(save_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        self._fieldnames: List[str] = ["step", "time"]
        # Bounded buffer, appended incrementally: long runs must not hold
        # every row in memory nor rewrite the whole file per flush (O(n^2)
        # I/O over a 100k-step run). The file is rewritten ONLY when a new
        # metric key appears (schema change — rare: typically once when the
        # first val epoch adds val/ columns).
        self._pending: List[Dict[str, float]] = []
        self._written = 0

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        new_keys = [k for k in row if k not in self._fieldnames]
        if new_keys and self._written:
            self._rewrite_with(new_keys)
        else:
            self._fieldnames.extend(new_keys)
        self._pending.append(row)
        if len(self._pending) >= 50:
            self._flush()

    def log_hyperparams(self, hparams: Dict[str, Any]) -> None:
        with open(os.path.join(self.dir, "hparams.json"), "w") as f:
            json.dump(_jsonable(hparams), f, indent=2, default=str)

    def _rewrite_with(self, new_keys: List[str]) -> None:
        """Widen the on-disk schema: re-emit existing rows with new columns."""
        self._flush()
        with open(self.path, newline="") as f:
            rows = list(csv.DictReader(f))
        self._fieldnames.extend(new_keys)
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            writer.writerows(rows)

    def _flush(self) -> None:
        if not self._pending and self._written:
            return
        mode = "a" if self._written else "w"
        with open(self.path, mode, newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            if not self._written:
                writer.writeheader()
            writer.writerows(self._pending)
        self._written += len(self._pending)
        self._pending = []

    def finalize(self) -> None:
        self._flush()


class TensorBoardLogger(BaseLogger):
    """TensorBoard events via tensorboardX (logger/tensorboard.yaml)."""

    def __init__(self, save_dir: str = "logs/tb", name: str = "default"):
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(os.path.join(save_dir, name))

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self.writer.add_scalar(k, v, step)

    def log_hyperparams(self, hparams: Dict[str, Any]) -> None:
        self.writer.add_text("hparams", json.dumps(_jsonable(hparams), default=str))

    def log_image(self, tag: str, image, step: int) -> None:
        # image: (H, W, C) float array in [0, 1]
        self.writer.add_image(tag, image, step, dataformats="HWC")

    def finalize(self) -> None:
        self.writer.close()


class NeptuneLogger(BaseLogger):
    """Gated Neptune logger (logger/neptune.yaml); no-ops without the client."""

    def __init__(self, project: str = "", experiment_name: str = "", **kwargs):
        try:
            import neptune  # noqa: F401

            self._run = neptune.init_run(project=project, name=experiment_name)
        except Exception:  # noqa: BLE001 - offline / not installed
            self._run = None

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self._run is None:
            return
        for k, v in metrics.items():
            self._run[k].append(v, step=step)

    def finalize(self) -> None:
        if self._run is not None:
            self._run.stop()


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        return str(obj)
