"""Convert a batch store to .sfb for the native C++ ingest fast path.

The port's own copy of ``satflow_tpu/data/convert.py``, reading and writing
through the port's ``datasets.open_batch_store`` and ``SfbBatchStore``.

The production data layer reads pre-batched files; the reference ecosystem
dumps ``batch_{i}.nc`` (NetCDF) or this repo's ``batch_{i}.npz``. The native
loader (native/ingest.cc) is ~10× faster per core on ``.sfb`` — this CLI
migrates any readable store (local npz/nc dir, or a remote gs://-style URL
through the bounded-cache RemoteBatchStore) into an .sfb directory once, so
training runs take the fast path.

Usage:
    python -m satflow_tpu_torch.data.convert SRC DST [--limit N] [--start I]
    # SRC: directory or remote URL of batch_{i}.(npz|nc); DST: .sfb dir
"""

from __future__ import annotations

import argparse
import sys


def convert(src: str, dst: str, limit: int | None = None,
            start: int = 0, temp_path: str = ".", verbose: bool = True,
            reindex: bool = False) -> int:
    """Convert ``src`` batches [start, start+limit) into .sfb files in ``dst``.

    By default destination files KEEP their source indices (batch_{start}.sfb
    onward): --start/--limit exist for sharded conversion where several
    invocations fill one dst dir and their union must be contiguous from 0
    (SfbBatchStore counts files, so a partial range with a hole would report
    len=N yet fail read()). Pass ``reindex=True`` to write a standalone
    subset renumbered from batch_0.sfb instead."""
    from satflow_tpu_torch.data.datasets import SfbBatchStore, open_batch_store

    store = open_batch_store(src, temp_path=temp_path)
    out = SfbBatchStore(dst)
    try:
        n = len(store)
    except (ValueError, TypeError):
        # list-less transports (anonymous-HTTPS s3) cannot len(); a bounded
        # conversion doesn't need to
        n = None
    if limit is not None:
        end = start + limit if n is None else min(n, start + limit)
    elif n is None:
        raise ValueError("source cannot be listed; pass --limit")
    else:
        end = n
    if start >= end:
        raise ValueError(f"start={start} is at/past the end ({end})")
    for i in range(start, end):
        j = i - start if reindex else i
        out.write(j, store.read(i))
        if verbose and (i - start) % 50 == 0:
            print(f"[{i + 1}/{end}] batch_{j}.sfb", file=sys.stderr)
    return end - start


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src", help="source store: dir or remote URL of batch files")
    p.add_argument("dst", help="destination directory for batch_{i}.sfb")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--start", type=int, default=0,
                   help="first source index; dst files keep source indices "
                        "(for sharded conversion into one dir) unless --reindex")
    p.add_argument("--reindex", action="store_true",
                   help="renumber the converted subset from batch_0.sfb")
    p.add_argument("--temp-path", default=".",
                   help="download cache for remote sources")
    a = p.parse_args(argv)
    n = convert(a.src, a.dst, a.limit, a.start, a.temp_path, reindex=a.reindex)
    print(f"converted {n} batches -> {a.dst}")


if __name__ == "__main__":
    main()
