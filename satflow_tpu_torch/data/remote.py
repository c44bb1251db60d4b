"""Remote batch-store fetch: stream pre-batched files from cloud storage.

The reference's data layer (via ``nowcasting_dataset.dataset.datasets.NetCDFDataset``,
imported at reference satflow/data/datasets.py:4-16 and configured by
``configs/datamodule/{aws,gcp}.yaml``) downloads ``batch_{i}.nc`` files from a
GCS/S3 bucket into a local ``temp_path`` cache inside DataLoader workers, then
decodes them locally. This module is the in-process equivalent:

- :class:`RemoteBatchStore` wraps any URL with a ``scheme://`` prefix. ``read(idx)``
  ensures ``batch_{idx}.<ext>`` is present in a local cache directory (downloading
  it if not), decodes it with the matching local store (npz / sfb / NetCDF), and
  evicts least-recently-used cached files beyond ``cache_size`` — so disk usage
  stays bounded no matter how large the remote store (n_train_data=24900 in the
  production configs) is.
- Transfers go through a per-scheme fetcher registry. ``gs://`` and ``file://``
  and ``memory://`` resolve through fsspec when available; ``s3://`` falls back
  to anonymous HTTPS (``https://<bucket>.s3.amazonaws.com/<key>``) when s3fs is
  not installed. Tests register mock fetchers via :func:`register_fetcher`.

Downloads are thread-safe (per-file locks) because the datamodule's Prefetcher
reads with multiple worker threads, matching the reference's per-worker fetch.
"""

from __future__ import annotations

import os
import shutil
import threading
import urllib.request
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

# scheme -> (list_fn, fetch_fn)
#   list_fn(url) -> list of file names (basename only) under the URL "directory"
#   fetch_fn(url, local_path) -> None  (download one file to local_path)
_FETCHERS: Dict[str, Dict[str, Callable]] = {}
_REGISTRY_LOCK = threading.Lock()


def register_fetcher(
    scheme: str,
    fetch: Callable[[str, str], None],
    list_files: Optional[Callable[[str], List[str]]] = None,
) -> None:
    """Register (or override) the transfer functions for a URL scheme.

    Used by tests to mock ``s3://`` / ``gs://`` without network access, and
    available to users for custom object stores.
    """
    with _REGISTRY_LOCK:
        _FETCHERS[scheme] = {"fetch": fetch, "list": list_files}


def unregister_fetcher(scheme: str) -> None:
    with _REGISTRY_LOCK:
        _FETCHERS.pop(scheme, None)


def split_url(url: str):
    """``"gs://bucket/a/b" -> ("gs", "bucket/a/b")``; no scheme -> ("", url)."""
    if "://" in url:
        scheme, rest = url.split("://", 1)
        return scheme, rest
    return "", url


def is_remote(path: str) -> bool:
    scheme, _ = split_url(path)
    return scheme not in ("", "file")


def _fsspec_fs(url: str):
    import fsspec

    scheme, _ = split_url(url)
    return fsspec.filesystem(scheme or "file")


def _fsspec_fetch(url: str, local_path: str) -> None:
    fs = _fsspec_fs(url)
    fs.get_file(url, local_path)


def _fsspec_list(url: str) -> List[str]:
    fs = _fsspec_fs(url)
    return [os.path.basename(p) for p in fs.ls(url, detail=False)]


def _s3_http_url(url: str) -> str:
    _, rest = split_url(url)
    bucket, _, key = rest.partition("/")
    return f"https://{bucket}.s3.amazonaws.com/{key}"


def _s3_http_fetch(url: str, local_path: str) -> None:
    """Anonymous S3 GET over HTTPS (public buckets; no s3fs/boto3 needed)."""
    with urllib.request.urlopen(_s3_http_url(url)) as r, open(local_path, "wb") as f:
        shutil.copyfileobj(r, f)


def _resolve(scheme: str) -> Dict[str, Callable]:
    with _REGISTRY_LOCK:
        if scheme in _FETCHERS:
            return _FETCHERS[scheme]
    try:
        import fsspec  # noqa: F401

        # fsspec raises at filesystem() time for unknown/uninstalled protocols
        # (e.g. s3 without s3fs) — probe it now so we can fall back.
        import fsspec.registry

        fsspec.get_filesystem_class(scheme or "file")
        return {"fetch": _fsspec_fetch, "list": _fsspec_list}
    except (ImportError, ValueError):
        pass
    if scheme == "s3":
        return {"fetch": _s3_http_fetch, "list": None}
    raise ValueError(
        f"No fetcher for scheme {scheme!r}; install fsspec support or "
        f"register one via satflow_tpu_torch.data.remote.register_fetcher"
    )


def _join_url(base: str, name: str) -> str:
    return base.rstrip("/") + "/" + name


class RemoteBatchStore:
    """Batch store over a remote URL with a bounded local download cache.

    Matches the reference's cloud->tmp_path fetch behavior (NetCDFDataset via
    reference satflow/data/datasets.py:4-16, bucket paths in
    configs/datamodule/{aws,gcp}.yaml) while bounding local disk: at most
    ``cache_size`` batch files live in ``cache_dir`` at once (LRU eviction).
    """

    def __init__(
        self,
        url: str,
        cache_dir: str,
        cache_size: int = 16,
        pattern: Optional[str] = None,
    ):
        from satflow_tpu_torch.data import datasets as _ds

        self.url = url.rstrip("/")
        self.cache_dir = cache_dir
        self.cache_size = max(1, int(cache_size))
        scheme, _ = split_url(url)
        self._scheme = scheme
        self._fetcher = _resolve(scheme)
        os.makedirs(cache_dir, exist_ok=True)

        if pattern is None:
            pattern = self._detect_pattern()
        self.pattern = pattern
        ext = pattern.rsplit(".", 1)[-1]
        local_cls = {
            "npz": _ds.NpzBatchStore,
            "sfb": _ds.SfbBatchStore,
            "nc": _ds.NetCDFBatchStore,
        }[ext]
        self._local = local_cls(cache_dir)
        self._local.pattern = pattern

        # LRU bookkeeping: name -> None, most-recently-used last.
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._lock = threading.Lock()
        self._file_locks: Dict[str, threading.Lock] = {}
        self._remote_len: Optional[int] = None

    def _detect_pattern(self) -> str:
        import re

        if self._fetcher.get("list") is None:
            # list-less transports (anonymous-HTTPS s3 fallback): probe-fetch
            # batch_0.<ext> instead of listing the prefix.
            for ext in ("sfb", "npz", "nc"):
                # same .part + os.replace protocol as _ensure_local: a
                # mid-transfer failure must not leave a truncated batch_0
                # in the cache for a later read() to decode
                probe = os.path.join(self.cache_dir, f"batch_0.{ext}")
                tmp = probe + ".part"
                try:
                    self._fetcher["fetch"](
                        _join_url(self.url, f"batch_0.{ext}"), tmp
                    )
                except Exception:  # noqa: BLE001 - missing/denied: next ext
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    continue
                os.replace(tmp, probe)
                return "batch_{idx}." + ext
            raise FileNotFoundError(
                f"could not probe batch_0.(sfb|npz|nc) under {self.url}; the "
                f"{self._scheme!r} transport cannot list — pass pattern="
            )
        from satflow_tpu_torch.data.datasets import batch_file_regex

        names = self.list_remote()
        for ext in ("sfb", "npz", "nc"):
            rx = batch_file_regex("batch_{idx}." + ext)
            n = sum(1 for name in names if rx.match(name))
            if n:
                # count only batch_{i}.<ext>: stray files (stats.npz, ...)
                # must not inflate the readable range
                self._remote_len = n
                return "batch_{idx}." + ext
        raise FileNotFoundError(f"no batch files (*.sfb/*.npz/*.nc) under {self.url}")

    def list_remote(self) -> List[str]:
        lister = self._fetcher.get("list")
        if lister is None:
            raise ValueError(
                f"scheme {self._scheme!r} fetcher cannot list; pass pattern= and "
                f"a dataset length explicitly"
            )
        return lister(self.url)

    def __len__(self) -> int:
        if self._remote_len is None:
            from satflow_tpu_torch.data.datasets import batch_file_regex

            rx = batch_file_regex(self.pattern)
            self._remote_len = sum(
                1 for n in self.list_remote() if rx.match(n)
            )
        return self._remote_len

    def _file_lock(self, name: str) -> threading.Lock:
        with self._lock:
            return self._file_locks.setdefault(name, threading.Lock())

    def _evict_locked(self) -> None:
        attempts = len(self._lru)
        while len(self._lru) > self.cache_size and attempts > 0:
            attempts -= 1
            victim, _ = self._lru.popitem(last=False)
            lock = self._file_locks.get(victim)
            # Skip files another thread is actively (re)downloading/reading;
            # they re-enter the LRU at most-recent position.
            if lock is not None and lock.locked():
                self._lru[victim] = None
                continue
            try:
                os.remove(os.path.join(self.cache_dir, victim))
            except OSError:
                pass

    def cached_files(self) -> List[str]:
        with self._lock:
            return list(self._lru)

    def read(self, idx: int):
        name = self.pattern.format(idx=idx)
        with self._file_lock(name):
            self._ensure_local_unlocked(name)
            batch = self._local.read(idx)
        with self._lock:
            self._lru.pop(name, None)
            self._lru[name] = None
            self._evict_locked()
        return batch

    def _ensure_local_unlocked(self, name: str, retries: int = 3) -> str:
        """Like _ensure_local but assumes the caller holds the file lock.

        Transient transport failures (network flakes, throttling) retry with
        exponential backoff; the last error propagates."""
        import time

        local_path = os.path.join(self.cache_dir, name)
        if not os.path.exists(local_path):
            tmp = local_path + ".part"
            last: Optional[BaseException] = None
            for attempt in range(retries):
                try:
                    self._fetcher["fetch"](_join_url(self.url, name), tmp)
                    last = None
                    break
                except FileNotFoundError:
                    raise  # a missing object will not appear on retry
                except Exception as e:  # noqa: BLE001 - retried, then raised
                    last = e
                    if attempt < retries - 1:  # no pointless final backoff
                        time.sleep(0.1 * (2 ** attempt))
            if last is not None:
                raise last
            os.replace(tmp, local_path)
        return local_path
