"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each source is one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds); :func:`load_all` runs one nvcc per source,
all at once. A library is compiled at first use into
``satflow_tpu_torch/_build/`` (git-ignored), under a name that carries a hash
of the sources and flags, so an edited source is never served from a stale
build. A missing ``nvcc`` or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()  # guards _locks and _loaded
_locks: Dict[str, threading.Lock] = {}  # one per source: builds run in parallel
_loaded: Dict[str, ctypes.CDLL] = {}
#: per source name: the compiler's output (ptxas register and spill report)
#: and the build's wall seconds, for builds made by this process
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and the CUDA "
        "toolkit's default location); the CUDA kernels cannot be built"
    )


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(src: Path, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    build_seconds[src.stem] = time.perf_counter() - t0
    build_logs[src.stem] = proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        with _lock:
            if name in _loaded:
                return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"CUDA source {src} is missing")
        out = _library_path(name)
        if not out.exists():
            _compile(src, out)
        lib = ctypes.CDLL(str(out))
        with _lock:
            _loaded[name] = lib
        return lib


def load_typed(name: str, entries: Iterable[str], argtypes: Sequence) -> ctypes.CDLL:
    """:func:`load`, with each entry point in ``entries`` typed ``argtypes``
    -> int (the CUDA error code of its launch) and the library's
    ``satflow_cuda_error_string`` typed for :func:`raise_on`."""
    lib = load(name)
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.satflow_cuda_error_string.argtypes = [ctypes.c_int]
    lib.satflow_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if an entry point of ``lib`` returned a CUDA error."""
    if err:
        msg = lib.satflow_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def load_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """:func:`load` for several sources at once, their nvcc runs in parallel;
    the first failure raises."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
