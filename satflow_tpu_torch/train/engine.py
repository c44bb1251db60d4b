"""Trainer: the fit/validate/test engine, counterpart of ``satflow_tpu/train/engine.py``.

The same knobs and loop as the JAX Trainer, on one device:

- ``precision: 16 | "bf16"``       -> bf16 compute with f32 parameters, set on
  the model without re-initialising weights it already holds.
- ``accumulate_grad_batches`` k    -> gradients averaged over k mini-steps and
  applied once (``optax.MultiSteps``).
- ``gradient_clip_val``            -> clip by global norm, as optax does.
- ``terminate_on_nan``             -> the step's ``finite`` flag, read one step
  late so that the check does not wait for the device.
- ``fast_dev_run`` / ``limit_*_batches`` / ``overfit_batches`` / ``max_steps``
  -> loop limits.

Metrics are logged under the JAX keys (``train/loss``,
``train/frame_{f}_loss``, ``train/grad_norm``, ``train/steps_per_sec``,
``val/...``). Knobs whose work is not ported raise ``NotImplementedError``
naming their ROADMAP item; the knobs the JAX Trainer accepts as no-ops stay
no-ops.
"""

from __future__ import annotations

import logging
import math
import signal
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.nn.parameter import is_lazy

from satflow_tpu_torch import resolve_device
from satflow_tpu_torch.data.datamodule import to_device
from satflow_tpu_torch.models.base import expand_frame_metrics
from satflow_tpu_torch.train.loggers import HistoryLogger
from satflow_tpu_torch.train.state import TrainState
from satflow_tpu_torch.train.steps import make_eval_step, make_train_step

log = logging.getLogger(__name__)


class Trainer:
    def __init__(
        self,
        max_epochs: int = 1,
        max_steps: Optional[int] = None,
        limit_train_batches: Optional[float] = None,
        limit_val_batches: Optional[float] = None,
        overfit_batches: int = 0,
        fast_dev_run: bool = False,
        accumulate_grad_batches: int = 1,
        gradient_clip_val: float = 0.0,
        precision: str | int = 32,
        check_val_every_n_epoch: int = 1,
        log_every_n_steps: int = 10,
        terminate_on_nan: bool = False,
        profiler: Optional[str] = None,
        profile_dir: str = "logs/profile",  # read with profiler, which raises
        zero_sharding: bool = False,
        spatial: Optional[str] = None,
        gan_step_mode: str = "fused",  # read by GAN training, which raises
        handle_preemption: bool = True,
        callbacks: Optional[List] = None,
        logger: Optional[List] = None,
        seed: int = 0,  # the JAX init/step key; the ported models draw none
        resume_from_checkpoint: Optional[str] = None,
        device: Any = None,
        # accepted-for-parity knobs (no-ops here, as in the JAX Trainer):
        gpus: Any = None,
        tpu_cores: Any = None,
        num_nodes: int = 1,
        accelerator: Optional[str] = None,
        sync_batchnorm: bool = False,
        **_: Any,
    ):
        unported = {
            "profiler": (profiler, "ROADMAP queue 1 item 6 (torch.profiler)"),
            "resume_from_checkpoint": (resume_from_checkpoint,
                                       "ROADMAP queue 1 item 6 (checkpoints)"),
            "zero_sharding": (zero_sharding, "ROADMAP queue 1 item 13 (FSDP)"),
            "spatial": (spatial, "ROADMAP queue 1 item 13 (spatial sharding)"),
        }
        for knob, (value, item) in unported.items():
            if value:
                raise NotImplementedError(f"trainer {knob}={value!r} is not ported yet: {item}")
        if str(precision) not in ("32", "16", "bf16", "bfloat16"):
            raise ValueError(f"precision must be 32, 16 or 'bf16', got {precision!r}")
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.overfit_batches = overfit_batches
        self.fast_dev_run = fast_dev_run
        self.accumulate_grad_batches = accumulate_grad_batches
        self.gradient_clip_val = gradient_clip_val
        self.precision = precision
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.log_every_n_steps = log_every_n_steps
        self.terminate_on_nan = terminate_on_nan
        self.handle_preemption = handle_preemption
        self.callbacks = list(callbacks or [])
        self.history = HistoryLogger()
        self.loggers: List = [self.history] + list(logger or [])
        self.seed = seed
        self.device = None if device is None else resolve_device(device)

        self.state: Optional[TrainState] = None
        self.model = None
        self.should_stop = False
        self.preempted = False
        self.global_step = 0
        self.last_batch = None

    # -- public API ----------------------------------------------------------

    @property
    def callback_metrics(self) -> Dict[str, float]:
        return self.history.latest

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def current_lr(self) -> Optional[float]:
        """The model's learning-rate schedule (``lr_schedule``, which its
        optimizer follows) at this step; None for a model without one (the
        ConvLSTM trains at a constant rate)."""
        schedule = getattr(self.model, "lr_schedule", None)
        return None if schedule is None else float(schedule(self.global_step))

    def fit(self, model, datamodule) -> Dict[str, float]:
        if getattr(model, "is_gan", False):
            raise NotImplementedError("GAN training is not ported yet (ROADMAP queue 1 item 11)")
        self.should_stop = False
        self.preempted = False
        self.model = model
        self._build_state(model, datamodule)
        train_loader = datamodule.train_dataloader()
        if self.overfit_batches:
            # debug harness: reuse the same first-N batches for train AND val
            cached = []
            for i, b in enumerate(train_loader):
                cached.append(b)
                if i + 1 >= self.overfit_batches:
                    break
            train_loader = cached
            datamodule = _OverfitDataModule(cached)
        train_step = make_train_step(model)
        eval_step = make_eval_step(model)

        for cb in self.callbacks:
            cb.on_train_start(self)

        n_train = self._limit(len(train_loader), self.limit_train_batches)
        if self.fast_dev_run:
            n_train = 1
        epochs = 1 if self.fast_dev_run else self.max_epochs

        # SIGTERM: finish the in-flight step, fire the callbacks'
        # on_preemption hooks, and stop cleanly
        prev_handler = None
        if self.handle_preemption and threading.current_thread() is threading.main_thread():
            def _on_sigterm(signum, frame):  # noqa: ARG001
                log.warning("SIGTERM: stopping after the current step")
                self.preempted = True
                self.should_stop = True

            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)

        try:
            for epoch in range(epochs):
                if self.should_stop:
                    break
                t_epoch = time.time()
                t_last = t_epoch
                steps_since_log = 0
                pending_finite = None  # (global_step, on-device flag)
                for i, batch in enumerate(train_loader):
                    if i >= n_train or self.should_stop:
                        break
                    batch = to_device(batch, self.device)
                    self.last_batch = batch
                    metrics = train_step(self.state, batch)
                    self.global_step += 1
                    steps_since_log += 1
                    if self.terminate_on_nan:
                        # the PREVIOUS step's flag: by now its kernels have
                        # usually finished, so the read does not stall
                        if pending_finite is not None and not bool(pending_finite[1]):
                            log.error("non-finite loss/grads at step %d; terminating fit",
                                      pending_finite[0])
                            self.should_stop = True
                        pending_finite = (self.global_step, metrics["finite"])
                    if self.global_step % self.log_every_n_steps == 0 or i == n_train - 1:
                        flat = expand_frame_metrics(metrics, "train")
                        now = time.time()
                        flat["train/steps_per_sec"] = steps_since_log / max(now - t_last, 1e-9)
                        t_last = now
                        steps_since_log = 0
                        flat.update(_device_memory_metrics(self.device))
                        self.log_metrics(flat, self.global_step)
                        if self.terminate_on_nan and any(
                            isinstance(v, float) and math.isnan(v) for v in flat.values()
                        ):
                            log.error("NaN loss detected; terminating fit")
                            self.should_stop = True
                    for cb in self.callbacks:
                        cb.on_train_batch_end(self, metrics, self.global_step)
                    if self.max_steps and self.global_step >= self.max_steps:
                        self.should_stop = True
                if (self.terminate_on_nan and pending_finite is not None
                        and not bool(pending_finite[1])):
                    log.error("non-finite loss/grads at step %d; terminating fit",
                              pending_finite[0])
                    self.should_stop = True
                log.info("epoch %d done in %.1fs (%d steps)", epoch,
                         time.time() - t_epoch, self.global_step)
                if (epoch + 1) % self.check_val_every_n_epoch == 0 and not self.preempted:
                    val_metrics = self._run_eval(eval_step, datamodule.val_dataloader(), "val")
                    self.log_metrics(val_metrics, self.global_step)
                    for cb in self.callbacks:
                        cb.on_validation_end(self, val_metrics, epoch)
        finally:
            try:
                if self.preempted:
                    for cb in self.callbacks:
                        cb.on_preemption(self)
            finally:
                if prev_handler is not None:
                    signal.signal(signal.SIGTERM, prev_handler)

        for cb in self.callbacks:
            cb.on_train_end(self)
        for lg in self.loggers:
            lg.finalize()
        return self.callback_metrics

    def validate(self, model=None, datamodule=None) -> Dict[str, float]:
        return self._evaluate(model, datamodule, "val")

    def test(self, model=None, datamodule=None) -> Dict[str, float]:
        return self._evaluate(model, datamodule, "test")

    # -- internals -----------------------------------------------------------

    def _evaluate(self, model, datamodule, split: str) -> Dict[str, float]:
        model = model or self.model
        self._build_state(model, datamodule)
        self.model = model
        loader = datamodule.val_dataloader() if split == "val" else datamodule.test_dataloader()
        metrics = self._run_eval(make_eval_step(model), loader, split)
        self.log_metrics(metrics, self.global_step)
        return metrics

    def _build_state(self, model, datamodule) -> None:
        if self.state is not None:
            return
        if self.device is None:
            self.device = next(model.parameters()).device
        model.to(self.device)
        # precision 16/"bf16": bf16 compute, the f32 parameters stay as they
        # are (the JAX Trainer rebuilds its module before initialising; here
        # the weights may have been loaded already)
        if str(self.precision) in ("16", "bf16", "bfloat16") and getattr(model, "dtype", None) is None:
            model.set_compute_dtype(torch.bfloat16)
        if hasattr(datamodule, "device"):
            datamodule.device = self.device
        # parameters whose shapes come from the data are created from the
        # first batch, as the JAX Trainer initialises from it
        if any(is_lazy(p) for p in model.parameters()):
            model.materialize(to_device(next(iter(datamodule.train_dataloader())), self.device))
        self.state = TrainState(
            model=model,
            optimizer=model.make_optimizer(),
            gradient_clip_val=self.gradient_clip_val,
            accumulate_grad_batches=self.accumulate_grad_batches,
        )

    def _run_eval(self, eval_step, loader, split: str) -> Dict[str, float]:
        n = self._limit(len(loader), self.limit_val_batches)
        if self.fast_dev_run:
            n = 1
        sums: Dict[str, float] = {}
        count = 0
        for i, batch in enumerate(loader):
            if i >= n:
                break
            metrics = eval_step(self.state, to_device(batch, self.device))
            for k, v in expand_frame_metrics(metrics, split).items():
                sums[k] = sums.get(k, 0.0) + v
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}

    @staticmethod
    def _limit(n: int, limit: Optional[float]) -> int:
        if limit is None:
            return n
        if isinstance(limit, float) and limit <= 1.0:
            return max(1, int(n * limit))
        return min(n, int(limit))


def _device_memory_metrics(device: Optional[torch.device]) -> Dict[str, float]:
    """Device memory in use and its peak, on a CUDA device; the JAX engine's
    ``mem/*`` keys (a CPU device reports none, as the JAX CPU backend)."""
    if device is None or device.type != "cuda":
        return {}
    return {
        "mem/bytes_in_use_gb": torch.cuda.memory_allocated(device) / 1e9,
        "mem/peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
    }


class _OverfitDataModule:
    def __init__(self, batches):
        self._batches = list(batches)

    def train_dataloader(self):
        return self._batches

    def val_dataloader(self):
        return self._batches

    def test_dataloader(self):
        return self._batches
