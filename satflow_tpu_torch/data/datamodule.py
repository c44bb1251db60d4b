"""SatFlowDataModule: loaders with background prefetch feeding device tensors.

Counterpart of ``satflow_tpu/data/datamodule.py`` (reference
satflow/data/datamodules.py:29-154): a thread-pool prefetcher overlaps
batch-file reads/decodes with device compute, and each batch is put on the
trainer's device one batch ahead of the consumer: numpy leaves go to
``device`` as tensors, from pinned host memory with ``non_blocking=True`` on
a CUDA device. Given a ``DeviceMesh`` as its device (the Trainer's under a
process group), the loaders yield this rank's block of each batch
(``parallel.mesh.shard_batch``).
"""

from __future__ import annotations

import inspect
import logging
import os
import queue
import threading
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from satflow_tpu_torch.data import consts
from satflow_tpu_torch.data.datasets import SatFlowDataset
from satflow_tpu_torch.data.fake import FakeDataset

log = logging.getLogger(__name__)


def to_device(tree: Any, device: torch.device) -> Any:
    """Every numpy array or tensor of a (nested dict/tuple/list) batch on
    ``device``; CUDA copies start from pinned memory and do not block."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        if device.type == "cuda" and tree.device.type == "cpu":
            return tree.pin_memory().to(device, non_blocking=True)
        return tree.to(device)
    return tree


class _WorkerError:
    """Exception captured in a reader thread, re-raised at the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class Prefetcher:
    """Iterate a dataset with ``num_workers`` reader threads and bounded readahead.

    At most ``max(prefetch, num_workers)`` batches are outstanding (claimed by a
    worker or decoded-and-waiting) at any moment — ``prefetch_factor`` is a real
    backpressure bound, like the reference DataLoader's
    (reference datamodules.py:87-96 ``prefetch_factor=8``), so host memory stays
    bounded on production-sized stores (n_train_data=24900).

    Datasets without ``__getitem__`` (e.g. :class:`NativeStreamingDataset`, whose
    C++ loader owns its own reader pool) are drained by a single pump thread into
    the same bounded window.
    """

    def __init__(self, dataset, num_workers: int = 2, prefetch: int = 4, device_put=None):
        self.dataset = dataset
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self.device_put = device_put

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator:
        indexable = hasattr(self.dataset, "__getitem__")
        if self.num_workers == 0:
            if indexable:
                for i in range(len(self.dataset)):
                    yield self._convert(self.dataset[i])
            else:
                for item in self.dataset:
                    yield self._convert(item)
            return
        if indexable:
            yield from self._pipelined(self._iter_indexed())
        else:
            yield from self._pipelined(self._iter_streaming())

    def _iter_indexed(self) -> Iterator:
        # yields RAW (host) items; __iter__ wraps this in _pipelined
        n = len(self.dataset)
        window = max(self.prefetch, self.num_workers)
        cv = threading.Condition()
        state = {"next": 0, "consumed": 0, "stop": False}
        results = {}

        def worker():
            while True:
                with cv:
                    while True:
                        if state["stop"]:
                            return
                        i = state["next"]
                        if i >= n:
                            return
                        if i - state["consumed"] < window:
                            state["next"] = i + 1
                            break
                        cv.wait()
                try:
                    item = self.dataset[i]
                except BaseException as e:  # noqa: BLE001 - delivered to consumer
                    item = _WorkerError(e)
                with cv:
                    results[i] = item
                    cv.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with cv:
                    while i not in results:
                        cv.wait()
                    item = results.pop(i)
                    state["consumed"] = i + 1
                    cv.notify_all()
                if isinstance(item, _WorkerError):
                    raise item.error
                yield item
        finally:
            with cv:
                state["stop"] = True
                cv.notify_all()

    def _pipelined(self, raw):
        """Convert ONE batch ahead of the consumer.

        The device put's host-side staging copy overlaps the in-flight train
        step while device residency stays at <= 2 batches — converting in the
        reader threads instead would make the whole readahead window
        (max(prefetch, num_workers) batches) resident in device memory.

        A failure while pulling ahead is DEFERRED until the already-converted
        batch has been delivered (readers' errors must not swallow the good
        batch before them)."""
        prev = None
        err = None
        it = iter(raw)
        while True:
            try:
                item = next(it)
            except StopIteration:
                break
            except BaseException as e:  # noqa: BLE001 - re-raised after drain
                err = e
                break
            cur = self._convert(item)
            if prev is not None:
                yield prev
            prev = cur
        if prev is not None:
            yield prev
        if err is not None:
            raise err

    def _iter_streaming(self) -> Iterator:
        """Single pump thread draining an iterable dataset into a bounded queue.

        Yields RAW (host) items; ``__iter__`` wraps this in ``_pipelined`` so
        the device put happens on the consumer side one batch ahead — the queue
        stays host-side and device residency is bounded at <= 2 batches no
        matter the queue depth (converting in the pump would let
        queue + pump-in-hand + consumer batches all be device-resident).

        The pump checks a stop event between bounded put attempts, so a
        consumer that stops early (fast_dev_run, limit_train_batches) releases
        the thread and the native loader's ring buffer instead of leaking
        them blocked on a full queue.
        """
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def pump():
            try:
                for item in self.dataset:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - delivered to consumer
                put(_WorkerError(e))
                return
            put(_END)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _WorkerError):
                    raise item.error
                yield item
        finally:
            stop.set()

    def _convert(self, item):
        if self.device_put is not None:
            return self.device_put(item)
        return item


class SatFlowDataModule:
    """Train/val/test loader factory (reference datamodules.py:29-154 surface).

    ``device`` is where the trainer runs (the :class:`~satflow_tpu_torch.train.Trainer`
    sets it at ``fit``); None leaves batches as numpy. Under a process group
    the Trainer sets the mesh instead, and with ``shard`` (the default, as in
    JAX) each rank's loaders yield its block of every batch.
    """

    def __init__(
        self,
        temp_path: str = ".",
        data_path: str = "",
        n_train_data: int = 24900,
        n_val_data: int = 1000,
        cloud: str = "local",
        num_workers: int = 2,
        prefetch_factor: int = 4,
        pin_memory: bool = True,  # accepted for config parity; CUDA puts always pin
        configuration_filename: str = "",
        fake_data: bool = False,
        fake_kwargs: Optional[dict] = None,
        required_keys: Sequence[str] = consts.DEFAULT_REQUIRED_KEYS,
        history_minutes: Optional[int] = None,
        forecast_minutes: Optional[int] = None,
        shard: bool = True,
        cache_size: int = 16,
        use_native: bool = True,
        device: Optional[Any] = None,
    ):
        self.temp_path = temp_path
        self.data_path = data_path
        self.n_train_data = n_train_data
        self.n_val_data = n_val_data
        self.cloud = cloud
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.fake_data = fake_data
        self.fake_kwargs = fake_kwargs or {}
        self.required_keys = list(required_keys)
        self.history_minutes = history_minutes
        self.forecast_minutes = forecast_minutes
        self.shard = shard
        self.cache_size = cache_size
        self.use_native = use_native
        self.device = device
        self.configuration = self._load_configuration(configuration_filename)

    @staticmethod
    def _load_configuration(filename: str) -> dict:
        if not filename:
            return {}
        if not os.path.exists(filename):
            # Configs reference "satflow_tpu/configs/..." paths relative to the
            # repo root; resolve against the installed package when the CLI has
            # chdir'd into a run dir (run.py run-dir behavior).
            pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
            candidate = os.path.join(pkg_root, filename)
            if not os.path.exists(candidate):
                # A typo'd configuration path must not silently fall back to
                # default history/forecast minutes — that changes the
                # past/future split under the user with no error.
                raise FileNotFoundError(
                    f"configuration_filename {filename!r} not found (also "
                    f"tried {candidate!r})"
                )
            filename = candidate
        import yaml

        with open(filename) as f:
            return yaml.safe_load(f) or {}

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    @device.setter
    def device(self, device: Optional[Any]) -> None:
        """A device, or a ``DeviceMesh`` (the Trainer's under a process
        group): the loaders then yield this rank's block of each batch
        (``parallel.mesh.shard_batch``, with ``shard``) on its device."""
        from torch.distributed.device_mesh import DeviceMesh

        self._mesh = None
        if isinstance(device, DeviceMesh):
            from satflow_tpu_torch.parallel.mesh import mesh_device

            self._mesh, device = device, mesh_device(device)
        elif isinstance(device, (list, tuple)):
            raise TypeError("a data module shards its batches over a DeviceMesh "
                            "(parallel.mesh.make_mesh), not a sequence of devices")
        self._device = None if device is None else torch.device(device)

    @property
    def batch_size(self) -> Optional[int]:
        """The fake data's batch, which the loaders read and
        :meth:`Trainer.scale_batch_size <satflow_tpu_torch.train.Trainer.scale_batch_size>`
        sets; None for data read from files, whose batch the files fix."""
        if not self.fake_data:
            return None
        return int(self.fake_kwargs.get(
            "batch_size", inspect.signature(FakeDataset).parameters["batch_size"].default))

    @batch_size.setter
    def batch_size(self, size: int) -> None:
        if not self.fake_data:
            log.warning("batch_size=%d not applied: the batch of data read from files is "
                        "fixed by the files", size)
            return
        self.fake_kwargs = {**self.fake_kwargs, "batch_size": int(size)}

    def _device_put(self):
        if self.device is None:
            return None
        if self._mesh is not None and self.shard:
            from satflow_tpu_torch.parallel.mesh import shard_batch

            mesh = self._mesh
            return lambda item: tuple(shard_batch(part, mesh) for part in item)
        device = self.device
        return lambda item: to_device(item, device)

    def _join(self, base: str, split: str) -> str:
        from satflow_tpu_torch.data.remote import is_remote

        if is_remote(base) or "://" in base:
            return base.rstrip("/") + "/" + split
        return os.path.join(base, split)

    def _dataset(self, split: str, n: int):
        if self.fake_data:
            return FakeDataset(
                history_minutes=self.history_minutes,
                forecast_minutes=self.forecast_minutes,
                length=min(n, 10),
                **self.fake_kwargs,
            )
        src = self._join(self.data_path, split)
        if self.use_native and self._native_sfb_dir(src):
            from satflow_tpu_torch.data.datasets import NativeStreamingDataset
            from satflow_tpu_torch.data.remote import split_url

            _, src = split_url(src)  # strip an explicit file:// prefix

            from satflow_tpu_torch.data.datasets import config_minutes

            hist = self.history_minutes if self.history_minutes is not None else (
                config_minutes(self.configuration, "history_minutes", 30)
            )
            fut = self.forecast_minutes if self.forecast_minutes is not None else (
                config_minutes(self.configuration, "forecast_minutes", 60)
            )
            return NativeStreamingDataset(
                src,
                history_minutes=hist,
                forecast_minutes=fut,
                required_keys=self.required_keys,
                num_threads=max(1, self.num_workers),
                capacity=self.prefetch_factor,
            )
        return SatFlowDataset(
            n,
            src,
            os.path.join(self.temp_path, split),
            configuration=self.configuration,
            cloud=self.cloud,
            required_keys=self.required_keys,
            history_minutes=self.history_minutes,
            forecast_minutes=self.forecast_minutes,
            cache_size=self.cache_size,
        )

    @staticmethod
    def _native_sfb_dir(src: str) -> bool:
        """True when ``src`` is a local dir of .sfb files and the C++ loader builds."""
        from satflow_tpu_torch.data.remote import is_remote, split_url

        if is_remote(src):
            return False
        _, path = split_url(src)
        try:
            has_sfb = any(f.endswith(".sfb") for f in os.listdir(path))
        except OSError:
            return False
        if not has_sfb:
            return False
        from satflow_tpu_torch.data.native_ingest import native_available

        return native_available(auto_build=True)

    def train_dataloader(self) -> Prefetcher:
        return Prefetcher(
            self._dataset("train", self.n_train_data),
            num_workers=self.num_workers,
            prefetch=self.prefetch_factor,
            device_put=self._device_put(),
        )

    def val_dataloader(self) -> Prefetcher:
        return Prefetcher(
            self._dataset("validation", self.n_val_data),
            num_workers=self.num_workers,
            prefetch=self.prefetch_factor,
            device_put=self._device_put(),
        )

    def test_dataloader(self) -> Prefetcher:
        return Prefetcher(
            self._dataset("test", self.n_val_data),
            num_workers=self.num_workers,
            prefetch=self.prefetch_factor,
            device_put=self._device_put(),
        )
