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
- ``resume_from_checkpoint``       -> weights, buffers, optimizer state,
  accumulation and step restored after the state is built
  (train/checkpoint.py).
- ``profiler`` (any value)         -> one ``torch.profiler`` trace of the
  fit, ``<profile_dir>/trace.json`` (train/profiling.py), its path on
  ``Trainer.profile_path``.
- SIGTERM (``handle_preemption``)  -> finish the step in flight, fire the
  callbacks' ``on_preemption`` (``ModelCheckpoint`` writes ``last``), stop.
- a GAN model (``is_gan``)         -> the two-optimizer round
  (train/steps.py ``make_gan_train_step``, ``gan_step_mode`` "fused" or
  "split") on a :class:`GANTrainState`, its evaluation
  (``make_gan_eval_step``) logged as ``val/d_*`` and ``val/g_*``, and a
  model with ``scheduler="plateau"`` its rates scaled by a
  :class:`PlateauScheduler` on ``val/g_loss``, each optimizer from its own
  base rate.
- a process group (``parallel.distributed.maybe_initialize_distributed``:
  torchrun, or the ``JAX_*`` triplet) -> data parallelism over its ranks:
  parameters and buffers broadcast from rank 0 when the state is built,
  each rank's block of the batch (``parallel.mesh.shard_batch``, which the
  data module applies, else the Trainer), gradients averaged over the ranks
  before the clip and the accumulation, BatchNorm statistics and every
  step's metrics global; checkpoints and loggers written by rank 0. The
  device is this rank's card (``cuda:{LOCAL_RANK}``).
- ``zero_sharding``                -> ``parallel.zero.apply_zero_sharding``
  (``ZeroRedundancyOptimizer``) when the group has more than one rank; with
  one the state stays as it is, as in JAX.
- ``spatial: "DxM"``               -> a D x M mesh over the world, bound for the
  duration of ``fit`` / ``validate`` / ``test`` only, and the model's
  rollout H-sharded over ``model`` (``enable_spatial``, the fused ConvLSTM).
- :meth:`Trainer.scale_batch_size` and :meth:`Trainer.tune` -> the
  power-of-two batch probe and the LR range test. Unlike the JAX probe,
  which backs off on any exception, the batch probe backs off on
  ``torch.OutOfMemoryError`` only: a kernel that fails to build or launch
  raises.

Metrics are logged under the JAX keys (``train/loss``,
``train/frame_{f}_loss``, ``train/grad_norm``, ``train/steps_per_sec``,
``val/...``). The knobs the JAX Trainer accepts as no-ops stay no-ops.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import math
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from satflow_tpu_torch.data.datamodule import to_device
from satflow_tpu_torch.models.base import expand_frame_metrics
from satflow_tpu_torch.parallel.distributed import (
    is_distributed,
    is_rank_zero,
    local_device,
    world_size,
)
from satflow_tpu_torch.train.loggers import HistoryLogger
from satflow_tpu_torch.train.profiling import make_profiler, write_trace
from satflow_tpu_torch.train.schedules import (
    PlateauScheduler,
    rewrite_learning_rate,
    scheduled,
)
from satflow_tpu_torch.train.state import GANTrainState, TrainState
from satflow_tpu_torch.train.steps import (
    make_eval_step,
    make_gan_eval_step,
    make_gan_train_step,
    make_train_step,
)

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
        profile_dir: str = "logs/profile",
        zero_sharding: bool = False,
        spatial: Optional[str] = None,
        gan_step_mode: str = "fused",
        handle_preemption: bool = True,
        callbacks: Optional[List] = None,
        logger: Optional[List] = None,
        seed: int = 0,  # seeds the GAN steps' noise generator
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
        self.profiler = profiler
        self.profile_dir = profile_dir
        self.profile_path: Optional[str] = None
        self.handle_preemption = handle_preemption
        self.callbacks = list(callbacks or [])
        self.history = HistoryLogger()
        self.loggers: List = [self.history] + list(logger or [])
        self.seed = seed
        self.resume_from_checkpoint = resume_from_checkpoint
        self.gan_step_mode = gan_step_mode
        self.zero_sharding = zero_sharding
        self.spatial = spatial
        self.device = None if device is None else local_device(device)
        self._plateau = None
        self._spatial_mesh = None

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
        """To the in-memory history on every rank, to the other loggers on
        rank 0 only."""
        for lg in self.writers():
            lg.log_metrics(metrics, step)

    def writers(self) -> List:
        """The loggers this process writes to: every one on rank 0 (or
        without a process group), the in-memory history on the others."""
        return self.loggers if is_rank_zero() else [self.history]

    def current_lr(self) -> Optional[float]:
        """The model's learning-rate schedule (``lr_schedule``, which its
        optimizer follows) at this step; None for a model without one (the
        ConvLSTM trains at a constant rate)."""
        schedule = getattr(self.model, "lr_schedule", None)
        return None if schedule is None else float(schedule(self.global_step))

    def _parse_spatial(self) -> Tuple[int, int]:
        try:
            d_size, m_size = (int(p) for p in str(self.spatial).lower().split("x"))
        except ValueError as e:
            raise ValueError(
                f"trainer.spatial={self.spatial!r}: expected 'DxM' "
                "(data x model axis sizes, e.g. '2x4')"
            ) from e
        return d_size, m_size

    def _bind_spatial_mesh(self):
        """Context binding this trainer's DxM mesh as the global mesh, for
        one entry point only, so that later non-spatial work in the process
        keeps every rank on ``data`` (see ``parallel.mesh.mesh_scope``);
        inside it, loaders cut H over ``model``."""
        if not self.spatial:
            return contextlib.nullcontext()
        from satflow_tpu_torch.parallel.mesh import make_mesh, mesh_scope

        if self._spatial_mesh is None:
            self._spatial_mesh = make_mesh(list(self._parse_spatial()))
        return mesh_scope(self._spatial_mesh, spatial_axis="model")

    def _batch_put(self, datamodule) -> Callable:
        """What each batch of ``datamodule``'s loaders goes through: to the
        device, and under a process group this rank's block of it
        (``shard_batch``), unless the data module cuts it itself (one with a
        ``device``, which ``_build_state`` set to the mesh)."""
        if is_distributed() and not hasattr(datamodule, "device"):
            from satflow_tpu_torch.parallel.mesh import shard_batch

            return shard_batch
        return lambda batch: to_device(batch, self.device)

    def fit(self, model, datamodule) -> Dict[str, float]:
        with self._bind_spatial_mesh():
            return self._fit(model, datamodule)

    def _fit(self, model, datamodule) -> Dict[str, float]:
        self.should_stop = False
        self.preempted = False
        self.model = model
        self._build_state(model, datamodule)
        put = self._batch_put(datamodule)
        train_loader = datamodule.train_dataloader()
        if self.overfit_batches:
            # debug harness: reuse the same first-N batches for train AND val
            cached = []
            for i, b in enumerate(train_loader):
                cached.append(b)
                if i + 1 >= self.overfit_batches:
                    break
            datamodule = _OverfitDataModule([put(b) for b in cached])
            train_loader = datamodule.train_dataloader()
            put = _as_is
        gan = getattr(model, "is_gan", False)
        train_step = (make_gan_train_step(model, mode=self.gan_step_mode) if gan
                      else make_train_step(model))

        for cb in self.callbacks:
            cb.on_train_start(self)

        n_train = self._limit(len(train_loader), self.limit_train_batches)
        if self.fast_dev_run:
            n_train = 1
        epochs = 1 if self.fast_dev_run else self.max_epochs

        profile = make_profiler(self.device) if self.profiler else None
        if profile is not None:
            profile.__enter__()

        # SIGTERM: finish the in-flight step, fire the callbacks'
        # on_preemption hooks (ModelCheckpoint writes `last`), and stop
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
                    batch = put(batch)
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
                    val_metrics = self._run_eval(self._eval_step(model),
                                                 datamodule.val_dataloader(), "val", put)
                    self.log_metrics(val_metrics, self.global_step)
                    self._plateau_step(val_metrics)
                    for cb in self.callbacks:
                        cb.on_validation_end(self, val_metrics, epoch)
        finally:
            if profile is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                profile.__exit__(None, None, None)
                if is_rank_zero():
                    self.profile_path = write_trace(profile, self.profile_dir)
                    log.info("profile: %s", self.profile_path)
            # our handler stays installed through the emergency checkpoint: a
            # repeated SIGTERM must not kill the process mid-save
            try:
                if self.preempted:
                    for cb in self.callbacks:
                        cb.on_preemption(self)
            finally:
                if prev_handler is not None:
                    signal.signal(signal.SIGTERM, prev_handler)

        for cb in self.callbacks:
            cb.on_train_end(self)
        for lg in self.writers():
            lg.finalize()
        return self.callback_metrics

    def validate(self, model=None, datamodule=None) -> Dict[str, float]:
        with self._bind_spatial_mesh():
            return self._evaluate(model, datamodule, "val")

    def test(self, model=None, datamodule=None) -> Dict[str, float]:
        with self._bind_spatial_mesh():
            return self._evaluate(model, datamodule, "test")

    # -- internals -----------------------------------------------------------

    def _evaluate(self, model, datamodule, split: str) -> Dict[str, float]:
        model = model or self.model
        self._build_state(model, datamodule)
        self.model = model
        loader = datamodule.val_dataloader() if split == "val" else datamodule.test_dataloader()
        metrics = self._run_eval(self._eval_step(model), loader, split,
                                 self._batch_put(datamodule))
        self.log_metrics(metrics, self.global_step)
        return metrics

    def _eval_step(self, model):
        """A fresh eval step: a GAN's draws the same noise in every
        evaluation run (seeded by ``seed``)."""
        if getattr(model, "is_gan", False):
            return make_gan_eval_step(model, self.seed)
        return make_eval_step(model)

    def _plateau_step(self, val_metrics: Dict[str, float]) -> None:
        """ReduceLROnPlateau of a GAN: scale both optimizers' rates, each from
        its own base rate, when ``val/g_loss`` stalls."""
        if self._plateau is None or self.state is None or "val/g_loss" not in val_metrics:
            return
        old_scale = self._plateau.scale
        scale = self._plateau.update(float(val_metrics["val/g_loss"]))
        if scale == old_scale:
            return
        g_lr, d_lr = self.model.gen_lr * scale, self.model.disc_lr * scale
        log.info("plateau: reducing lrs to g=%.3e d=%.3e", g_lr, d_lr)
        rewrite_learning_rate(self.state.g.optimizer, g_lr)
        rewrite_learning_rate(self.state.d.optimizer, d_lr)

    def _make_state(self, model, device: torch.device):
        """The train state of ``model`` (built, on ``device``) with this
        trainer's clipping and accumulation: two optimizers and the noise
        generator (seeded ``seed + 1``) for a GAN."""
        kw = dict(gradient_clip_val=self.gradient_clip_val,
                  accumulate_grad_batches=self.accumulate_grad_batches)
        if getattr(model, "is_gan", False):
            noise = torch.Generator(device=device).manual_seed(self.seed + 1)
            return GANTrainState.create(model, *model.make_optimizers(), noise, **kw)
        return TrainState(model=model, optimizer=model.make_optimizer(), **kw)

    def _build_state(self, model, datamodule) -> None:
        if self.state is not None:
            return
        if self.spatial:
            # "DxM": D-way data parallelism x M-way H-sharding of the rollout;
            # the mesh is bound as the global one around each entry point only
            if not hasattr(model, "enable_spatial"):
                raise ValueError(f"{type(model).__name__} does not support spatial "
                                 "parallelism (no enable_spatial)")
            from satflow_tpu_torch.parallel.mesh import get_mesh

            model.enable_spatial(get_mesh(), axis="model")
        if self.device is None:
            self.device = next(model.parameters()).device
        model.to(self.device)
        # precision 16/"bf16": bf16 compute, the f32 parameters stay as they
        # are (the JAX Trainer rebuilds its module, a GAN's two, before
        # initialising; here the weights may have been loaded already)
        if self._bf16 and getattr(model, "dtype", None) is None:
            model.set_compute_dtype(torch.bfloat16)
        if hasattr(datamodule, "device"):
            if is_distributed():
                from satflow_tpu_torch.parallel.mesh import get_mesh

                datamodule.device = get_mesh()  # the loaders cut this rank's block
            else:
                datamodule.device = self.device
        # parameters whose shapes come from the data are created from the
        # first batch, as the JAX Trainer initialises from it
        if any(is_lazy(p) for p in model.parameters()):
            model.materialize(self._batch_put(datamodule)(
                next(iter(datamodule.train_dataloader()))))
        if is_distributed():
            from satflow_tpu_torch.parallel.mesh import put_replicated

            put_replicated(model)  # every rank starts from rank 0's weights
        self.state = self._make_state(model, self.device)
        if self.zero_sharding and world_size() > 1:
            from satflow_tpu_torch.parallel.zero import apply_zero_sharding

            apply_zero_sharding(self.state)
        if getattr(model, "is_gan", False) and getattr(model, "scheduler", None) == "plateau":
            self._plateau = PlateauScheduler(base_lr=model.gen_lr,
                                             patience=model.lr_epochs // 2)
        if self.resume_from_checkpoint:
            from satflow_tpu_torch.train.checkpoint import resume_state

            # after the materialize and the optimizer, which the saved state fills
            self.state, self.global_step = resume_state(self.state, self.resume_from_checkpoint)

    @property
    def _bf16(self) -> bool:
        return str(self.precision) in ("16", "bf16", "bfloat16")

    def _run_eval(self, eval_step, loader, split: str, put: Callable) -> Dict[str, float]:
        n = self._limit(len(loader), self.limit_val_batches)
        if self.fast_dev_run:
            n = 1
        sums: Dict[str, float] = {}
        count = 0
        for i, batch in enumerate(loader):
            if i >= n:
                break
            metrics = eval_step(self.state, put(batch))
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

    def _probe_model(self, model, batch):
        """A copy of ``model`` on this trainer's device, at its precision and
        materialized from ``batch``, for the probes of :meth:`scale_batch_size`
        and :meth:`tune`: the model's own weights do not move. Returns
        ``(copy, batch on the device)``."""
        device = self.device or next(model.parameters()).device
        probe = copy.deepcopy(model).to(device)
        if self._bf16 and getattr(probe, "dtype", None) is None:
            probe.set_compute_dtype(torch.bfloat16)
        batch = to_device(batch, device)
        probe.materialize(batch)
        return probe, batch

    def scale_batch_size(
        self,
        model,
        datamodule,
        init_val: int = 2,
        max_trials: int = 6,
        max_batch_size: Optional[int] = None,
    ) -> int:
        """Power-scaling batch-size finder (the reference's
        ``trainer.tune(auto_scale_batch_size="power")``, train.py:81-83):
        double the batch until the train step runs out of device memory, and
        keep the last size that ran. Each probe is the real train step with
        the model's optimizer (Adam; a GAN's round with both) on a copy of
        the model, so that its moments count. Only ``torch.OutOfMemoryError`` backs off; any other
        error raises. Sets ``datamodule.batch_size`` where the attribute exists."""
        first = next(iter(datamodule.train_dataloader()))

        def probe(size: int) -> None:
            probe_model, batch = self._probe_model(model, _tile_batch(first, size))
            state = self._make_state(probe_model, next(probe_model.parameters()).device)
            if getattr(probe_model, "is_gan", False):  # a round: both optimizers count
                metrics = make_gan_train_step(probe_model, self.gan_step_mode)(state, batch)
                float(metrics["g_loss"])  # waits for the device
            else:
                metrics = make_train_step(probe_model)(state, batch)
                float(metrics["loss"])

        good = 0
        size = max(1, init_val)
        for _ in range(max_trials):
            if max_batch_size and size > max_batch_size:
                break
            try:
                probe(size)
            except torch.OutOfMemoryError as e:
                log.info("scale_batch_size: %d ran out of memory (%s); keeping %d",
                         size, str(e).splitlines()[0], good)
                break
            finally:
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
            good = size
            size *= 2
        if good == 0:
            raise RuntimeError(
                f"scale_batch_size: even batch {init_val} ran out of memory; "
                f"not overriding the configured batch size"
            )
        if hasattr(datamodule, "batch_size"):
            datamodule.batch_size = good
        log.info("scale_batch_size: selected %d", good)
        return good

    def tune(self, model, datamodule, num_steps: int = 30,
             min_lr: float = 1e-6, max_lr: float = 1.0,
             auto_lr_find: bool = True,
             auto_scale_batch_size: bool = False) -> float:
        """LR range test and optional batch-size scaling (the reference's
        trainer.tune, train.py:81-83): SGD on a copy of the model with the LR
        growing as ``min_lr * (max_lr / min_lr) ** (i / num_steps)`` (optax's
        ``exponential_decay``) until the loss is not finite; the suggestion is
        one decade below the LR of the steepest descent, set as
        ``model.lr``. With ``auto_scale_batch_size``, first runs
        :meth:`scale_batch_size`."""
        if auto_scale_batch_size:
            self.scale_batch_size(model, datamodule)
        if not auto_lr_find:
            return model.lr
        loader = datamodule.train_dataloader()
        probe_model, _ = self._probe_model(model, next(iter(loader)))
        device = next(probe_model.parameters()).device

        def schedule(i: int) -> float:
            return min_lr * (max_lr / min_lr) ** (i / num_steps)

        state = TrainState(probe_model, scheduled(
            torch.optim.SGD(probe_model.parameters(), lr=min_lr), schedule))
        step = make_train_step(probe_model)
        losses, lrs = [], []
        it = iter(loader)
        for i in range(num_steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                batch = next(it)
            loss = float(step(state, to_device(batch, device))["loss"])
            if not math.isfinite(loss):
                break
            losses.append(loss)
            lrs.append(schedule(i))
        if len(losses) < 3:
            return model.lr
        # steepest descent point, one decade of headroom
        best = int(np.argmin(np.gradient(np.asarray(losses))))
        suggestion = max(lrs[best] / 10.0, min_lr)
        log.info("tune: suggested lr %.2e", suggestion)
        model.lr = suggestion
        return suggestion


def _as_is(batch: Any) -> Any:
    return batch


def _tile_batch(batch: Any, n: int) -> Any:
    """Every array or tensor of a nested batch repeated along its first axis
    to ``n`` rows."""
    if isinstance(batch, dict):
        return {k: _tile_batch(v, n) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tile_batch(v, n) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        reps = (n + batch.shape[0] - 1) // batch.shape[0]
        tiled = (np.tile(batch, (reps,) + (1,) * (batch.ndim - 1)) if isinstance(batch, np.ndarray)
                 else batch.repeat(reps, *(1,) * (batch.dim() - 1)))
        return tiled[:n]
    return batch


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
