"""Batch-file dataset: pre-batched sample files split into past (x) / future (y).

The reference wraps an external ``NetCDFDataset`` that fetches pre-batched NetCDF
files (``batch_{i}.nc``) from GCS/AWS/local to a tmp dir and splits each batch at
``current_timestep_index = history_minutes//5 + 1`` into past inputs and future
targets (reference satflow/data/datasets.py:19-106). This module reimplements that
protocol with a pluggable batch store:

- ``SfbBatchStore`` — ``batch_{i}.sfb`` files decoded by the native C++ ingest
  library (native/ingest.cc): multithreaded, GIL-free reads (the production
  fast path; see also ``NativeStreamingDataset``).
- ``NpzBatchStore`` — ``batch_{i}.npz`` files of named numpy arrays.
- ``NetCDFBatchStore`` — reads ``batch_{i}.nc`` when xarray/netCDF4 are installed
  (import-gated, for parity with reference data dumps).

The past/future split semantics match reference datasets.py:70-106, including the
topographic channel-dim expand (:104).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from satflow_tpu_torch.data import consts


def batch_file_regex(pattern: str) -> "re.Pattern[str]":
    """The filename rule for one batch file: ``pattern`` with ``{idx}`` as
    an integer. Shared with RemoteBatchStore so every store counts its
    readable range the same way."""
    return re.compile(
        "^" + re.escape(pattern).replace(re.escape("{idx}"), r"\d+") + "$"
    )


def _count_batch_files(path: str, pattern: str) -> int:
    """Count only files matching the store's pattern: stray siblings
    (stats.npz, norm files) must not inflate the readable range —
    ``read(len-1)`` would hit a missing batch file mid-epoch."""
    rx = batch_file_regex(pattern)
    return sum(1 for f in os.listdir(path) if rx.match(f))


class NpzBatchStore:
    """Directory of ``batch_{i}.npz`` files holding one pre-batched sample dict each."""

    pattern = "batch_{idx}.npz"

    def __init__(self, path: str):
        self.path = path

    def __len__(self) -> int:
        return _count_batch_files(self.path, self.pattern)

    def read(self, idx: int) -> Dict[str, np.ndarray]:
        fname = os.path.join(self.path, self.pattern.format(idx=idx))
        with np.load(fname) as data:
            return {k: data[k] for k in data.files}

    def write(self, idx: int, batch: Dict[str, np.ndarray]) -> None:
        os.makedirs(self.path, exist_ok=True)
        np.savez_compressed(
            os.path.join(self.path, self.pattern.format(idx=idx)), **batch
        )


class NetCDFBatchStore:
    """Reads/writes the reference's ``batch_{i}.nc`` dumps without xarray.

    The reference's wire format (reference satflow/data/datasets.py:4-16,
    nowcasting_dataset's ``batch_to_dataset().to_netcdf()``) is NetCDF —
    either NetCDF4 (an HDF5 container, decoded here via h5py) or classic
    NetCDF3 (decoded/written via scipy.io.netcdf_file). The format is sniffed
    from the file magic (``\\x89HDF`` vs ``CDF\\x01``/``CDF\\x02``), and
    dimension-coordinate variables are dropped so only data variables reach
    the training batch (xarray ``ds.data_vars`` semantics)."""

    pattern = "batch_{idx}.nc"

    def __init__(self, path: str):
        self.path = path

    def __len__(self) -> int:
        return _count_batch_files(self.path, self.pattern)

    def read(self, idx: int) -> Dict[str, np.ndarray]:
        fname = os.path.join(self.path, self.pattern.format(idx=idx))
        with open(fname, "rb") as f:
            magic = f.read(4)
        if magic.startswith(b"\x89HDF"):
            return self._read_hdf5(fname)
        if magic.startswith(b"CDF"):
            return self._read_netcdf3(fname)
        raise ValueError(f"{fname}: not a NetCDF file (magic {magic!r})")

    @staticmethod
    def _read_hdf5(fname: str) -> Dict[str, np.ndarray]:
        import h5py

        out: Dict[str, np.ndarray] = {}

        def visit(name, node):
            if not isinstance(node, h5py.Dataset):
                return
            # netCDF4 marks pure dimension coordinates as HDF5 dimension
            # scales (CLASS=DIMENSION_SCALE); batch data variables are plain
            # datasets (with DIMENSION_LIST attrs pointing at the scales)
            if node.attrs.get("CLASS") in (b"DIMENSION_SCALE", "DIMENSION_SCALE"):
                return
            arr = np.asarray(node[()])
            # HDF5 permits explicit big-endian types ('>f4'); JAX only takes
            # native order (same invariant as the NetCDF3 reader below)
            if arr.dtype.byteorder == ">":
                arr = arr.astype(arr.dtype.newbyteorder("="))
            out[name.split("/")[-1]] = arr

        with h5py.File(fname, "r") as f:
            f.visititems(visit)
        return out

    @staticmethod
    def _read_netcdf3(fname: str) -> Dict[str, np.ndarray]:
        from scipy.io import netcdf_file

        def native(arr) -> np.ndarray:
            # NetCDF3 payloads are big-endian; JAX only takes native order
            arr = np.asarray(arr)
            if arr.dtype.byteorder == ">":
                arr = arr.astype(arr.dtype.newbyteorder("="))
            return arr

        with netcdf_file(fname, "r", mmap=False) as ds:
            return {
                k: native(v[:])
                for k, v in ds.variables.items()
                if k not in ds.dimensions  # drop dimension coordinates
            }

    def write(self, idx: int, batch: Dict[str, np.ndarray]) -> None:
        """Write a classic NetCDF3 ``batch_{i}.nc`` (scipy's writable dialect)."""
        from scipy.io import netcdf_file

        os.makedirs(self.path, exist_ok=True)
        fname = os.path.join(self.path, self.pattern.format(idx=idx))
        with netcdf_file(fname, "w") as ds:
            for key, value in batch.items():
                value = np.asarray(value)
                dims = []
                for d, size in enumerate(value.shape):
                    dim = f"{key}_d{d}"
                    ds.createDimension(dim, size)
                    dims.append(dim)
                var = ds.createVariable(key, value.dtype, tuple(dims))
                var[:] = value


class SfbBatchStore:
    """Directory of ``batch_{i}.sfb`` files read through the native ingest
    library (native/ingest.cc) — the C++ fast path of the data pipeline."""

    pattern = "batch_{idx}.sfb"

    def __init__(self, path: str):
        self.path = path

    def __len__(self) -> int:
        return _count_batch_files(self.path, self.pattern)

    def read(self, idx: int) -> Dict[str, np.ndarray]:
        from satflow_tpu_torch.data.native_ingest import NativeSfbLoader, native_available

        fname = os.path.join(self.path, self.pattern.format(idx=idx))
        if native_available(auto_build=True):
            return next(iter(NativeSfbLoader([fname], num_threads=1)))
        raise RuntimeError("native ingest library not built; run `make -C native`")

    def write(self, idx: int, batch: Dict[str, np.ndarray]) -> None:
        from satflow_tpu_torch.data.native_ingest import write_sfb

        os.makedirs(self.path, exist_ok=True)
        write_sfb(os.path.join(self.path, self.pattern.format(idx=idx)), batch)


def open_batch_store(path: str, temp_path: str = ".", cache_size: int = 16):
    """Pick a store implementation by inspecting the path.

    URLs with a remote scheme (``gs://``, ``s3://``, ``memory://``, …) open a
    :class:`~satflow_tpu_torch.data.remote.RemoteBatchStore` that downloads batch
    files into ``temp_path`` with LRU eviction — the reference's cloud->tmp
    fetch (reference satflow/data/datasets.py:4-16, configs/datamodule/
    {aws,gcp}.yaml). Local directories are inspected for the file format.
    """
    from satflow_tpu_torch.data.remote import RemoteBatchStore, is_remote, split_url

    if is_remote(path):
        return RemoteBatchStore(path, cache_dir=temp_path, cache_size=cache_size)
    _, path = split_url(path)  # strip an explicit file:// prefix
    if any(f.endswith(".sfb") for f in os.listdir(path)):
        return SfbBatchStore(path)
    if any(f.endswith(".nc") for f in os.listdir(path)):
        return NetCDFBatchStore(path)
    return NpzBatchStore(path)


def config_minutes(cfg: dict, key: str, default: int) -> int:
    """Read history/forecast minutes from a dataset configuration dict.

    Supports both the flat local schema (``history_minutes: 30``) and the
    reference nowcasting_dataset schema where they live under ``process:``
    (reference configs/configurations/{gcp,aws}.yaml)."""
    if key in cfg:
        return int(cfg[key])
    return int((cfg.get("process") or {}).get(key, default))


def split_past_future(
    batch: Dict[str, np.ndarray],
    split: int,
    required_keys: Sequence[str] = consts.DEFAULT_REQUIRED_KEYS,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Past/future split of a pre-batched sample dict (reference
    datasets.py:70-106 semantics, incl. the topo channel expand at :104)."""
    x: Dict[str, np.ndarray] = {}
    y: Dict[str, np.ndarray] = {}

    sat = batch[consts.SATELLITE_DATA]  # (B, T, W, H, C)
    x[consts.SATELLITE_DATA] = sat[:, :split]
    y[consts.SATELLITE_DATA] = sat[:, split:]

    for key in (consts.SATELLITE_X_COORDS, consts.SATELLITE_Y_COORDS):
        if key in batch and key in required_keys:
            x[key] = batch[key]
    if consts.SATELLITE_DATETIME_INDEX in batch:
        dt = batch[consts.SATELLITE_DATETIME_INDEX]
        x[consts.SATELLITE_DATETIME_INDEX] = dt[:, :split]
        y[consts.SATELLITE_DATETIME_INDEX] = dt[:, split:]

    for name in consts.DATETIME_FEATURE_NAMES:
        if name in batch and name in required_keys:
            x[name] = batch[name][:, :split]

    if consts.NWP_DATA in batch and consts.NWP_DATA in required_keys:
        # NWP layout (B, C, T, H, W): time is axis 2 (datasets.py:95-99).
        x[consts.NWP_DATA] = batch[consts.NWP_DATA][:, :, :split]
    for key in (consts.NWP_X_COORDS, consts.NWP_Y_COORDS):
        if key in batch and key in required_keys:
            x[key] = batch[key]

    if consts.TOPOGRAPHIC_DATA in batch and consts.TOPOGRAPHIC_DATA in required_keys:
        topo = batch[consts.TOPOGRAPHIC_DATA]
        if topo.ndim == 3:  # (B, H, W) → (B, H, W, 1) channel expand (:104)
            topo = topo[..., None]
        x[consts.TOPOGRAPHIC_DATA] = topo
    for key in (consts.TOPOGRAPHIC_X_COORDS, consts.TOPOGRAPHIC_Y_COORDS):
        if key in batch and key in required_keys:
            x[key] = batch[key]

    return x, y


class SatFlowDataset:
    """Past/future-split view over a batch store (reference datasets.py:19-106)."""

    def __init__(
        self,
        n_batches: int,
        src_path: str,
        tmp_path: str = ".",
        configuration: Optional[dict] = None,
        cloud: str = "local",
        required_keys: Sequence[str] = consts.DEFAULT_REQUIRED_KEYS,
        history_minutes: Optional[int] = None,
        forecast_minutes: Optional[int] = None,
        combine_datetime_features: bool = False,
        cache_size: int = 16,
    ):
        self.n_batches = n_batches
        # cloud="local" with a remote src_path still resolves remotely — the
        # scheme on the URL is authoritative, matching how the reference keys
        # off the configured bucket path (datamodules.py:87-96).
        self.store = open_batch_store(src_path, temp_path=tmp_path, cache_size=cache_size)
        self.required_keys = list(required_keys)
        cfg = configuration or {}
        self.history_minutes = (
            history_minutes
            if history_minutes is not None
            else config_minutes(cfg, "history_minutes", 30)
        )
        self.forecast_minutes = (
            forecast_minutes
            if forecast_minutes is not None
            else config_minutes(cfg, "forecast_minutes", 60)
        )
        # Index of the first future frame (reference datasets.py:64-68):
        # history frames [0, hist] inclusive of "now".
        self.current_timestep_index = (
            self.history_minutes // consts.MINUTES_PER_STEP
        ) + 1

    def __len__(self) -> int:
        return self.n_batches

    def per_worker_init(self, worker_id: int) -> None:
        pass

    def __getitem__(self, idx: int) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        batch = self.store.read(idx)
        return split_past_future(batch, self.current_timestep_index, self.required_keys)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class NativeStreamingDataset:
    """Stream a directory of .sfb files through the C++ ingest thread pool.

    Unlike the random-access stores, this keeps the native loader's bounded
    ring alive across batches (readers stay ahead of the consumer) and applies
    the past/future split on each delivered batch — the streaming analog of
    the reference's persistent DataLoader workers (datamodules.py:87-96).
    """

    def __init__(
        self,
        src_path: str,
        history_minutes: int = 30,
        forecast_minutes: int = 60,
        required_keys: Sequence[str] = consts.DEFAULT_REQUIRED_KEYS,
        num_threads: int = 4,
        capacity: int = 8,
    ):
        self.paths = sorted(
            os.path.join(src_path, f)
            for f in os.listdir(src_path)
            if f.endswith(".sfb")
        )
        self.required_keys = list(required_keys)
        self.current_timestep_index = history_minutes // consts.MINUTES_PER_STEP + 1
        self.num_threads = num_threads
        self.capacity = capacity

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self):
        from satflow_tpu_torch.data.native_ingest import NativeSfbLoader

        loader = NativeSfbLoader(self.paths, self.num_threads, self.capacity)
        for batch in loader:
            yield split_past_future(
                batch, self.current_timestep_index, self.required_keys
            )


def write_fake_store(
    path: str,
    n_batches: int = 4,
    batch_size: int = 4,
    size: int = 16,
    seq_length: int = 19,
    sat_channels: int = 12,
    seed: int = 0,
) -> None:
    """Materialize a small npz batch store (for tests and examples)."""
    rng = np.random.default_rng(seed)
    store = NpzBatchStore(path)
    for i in range(n_batches):
        sat = rng.random((batch_size, seq_length, size, size, sat_channels)).astype(
            np.float32
        )
        batch = {
            consts.SATELLITE_DATA: sat,
            consts.SATELLITE_X_COORDS: np.sort(
                rng.standard_normal((batch_size, seq_length)).astype(np.float32), -1
            ),
            consts.SATELLITE_Y_COORDS: np.sort(
                rng.standard_normal((batch_size, seq_length)).astype(np.float32), -1
            ),
            consts.SATELLITE_DATETIME_INDEX: np.sort(
                rng.standard_normal((batch_size, seq_length)).astype(np.float32), -1
            ),
            consts.NWP_DATA: rng.standard_normal(
                (batch_size, 10, seq_length, 2, 2)
            ).astype(np.float32),
            consts.TOPOGRAPHIC_DATA: rng.standard_normal(
                (batch_size, size, size)
            ).astype(np.float32),
        }
        for name in consts.DATETIME_FEATURE_NAMES:
            batch[name] = rng.standard_normal((batch_size, seq_length)).astype(np.float32)
        store.write(i, batch)
