"""ctypes bindings for the native SFB ingest library (native/ingest.cc).

The native path replaces Python worker threads for the batch-file hot loop
(the reference's torch DataLoader worker processes, datamodules.py:87-96):
N C++ threads read + parse pre-batched ``.sfb`` files off the GIL, delivering
in-file-order batches through a bounded ring. Falls back transparently — the
datamodule uses the Python Prefetcher when the shared library isn't built.

Build: ``make -C native`` (or ``python -m satflow_tpu_torch.data.native_ingest build``).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

_MAGIC = b"SFBATCH1"
_DTYPE_CODES = {
    np.dtype("float32"): 0,
    np.dtype("float16"): 1,
    np.dtype("int32"): 2,
    np.dtype("uint8"): 3,
    np.dtype("float64"): 4,
    np.dtype("int64"): 5,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsatflow_ingest.so")

_lib: Optional[ctypes.CDLL] = None


def build_native(quiet: bool = True) -> bool:
    """Compile the ingest library in-place; returns success."""
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=quiet,
        )
        return os.path.exists(_LIB_PATH)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def native_available(auto_build: bool = False) -> bool:
    if os.path.exists(_LIB_PATH):
        return True
    if auto_build:
        return build_native()
    return False


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_LIB_PATH)
    lib.sfb_open.restype = ctypes.c_void_p
    lib.sfb_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.sfb_next.restype = ctypes.c_void_p
    lib.sfb_next.argtypes = [ctypes.c_void_p]
    lib.sfb_batch_error.restype = ctypes.c_char_p
    lib.sfb_batch_error.argtypes = [ctypes.c_void_p]
    lib.sfb_batch_index.restype = ctypes.c_int64
    lib.sfb_batch_index.argtypes = [ctypes.c_void_p]
    lib.sfb_entry_count.restype = ctypes.c_int
    lib.sfb_entry_count.argtypes = [ctypes.c_void_p]
    lib.sfb_entry_name.restype = ctypes.c_char_p
    lib.sfb_entry_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sfb_entry_dtype.restype = ctypes.c_int
    lib.sfb_entry_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sfb_entry_ndim.restype = ctypes.c_int
    lib.sfb_entry_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sfb_entry_dims.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.sfb_entry_data.restype = ctypes.c_void_p
    lib.sfb_entry_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.sfb_release.argtypes = [ctypes.c_void_p]
    lib.sfb_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# Writer (Python side; the reader is native)
# ---------------------------------------------------------------------------


def write_sfb(path: str, batch: Dict[str, np.ndarray]) -> None:
    """Serialize a dict of arrays to the SFB v1 format."""
    parts: List[bytes] = [_MAGIC, struct.pack("<I", len(batch))]
    offset = len(_MAGIC) + 4
    for name, arr in batch.items():
        arr = np.ascontiguousarray(arr)
        code = _DTYPE_CODES[arr.dtype]
        nb = name.encode("utf-8")
        header = struct.pack("<H", len(nb)) + nb + struct.pack(
            "<BB", code, arr.ndim
        ) + struct.pack(f"<{arr.ndim}I", *arr.shape) + struct.pack(
            "<Q", arr.nbytes
        )
        parts.append(header)
        offset += len(header)
        pad = (-offset) % 8
        parts.append(b"\x00" * pad)
        offset += pad
        data = arr.tobytes()
        parts.append(data)
        offset += len(data)
    with open(path, "wb") as f:
        f.write(b"".join(parts))


class NativeSfbLoader:
    """Iterate SFB files decoded by the native thread pool, in file order.

    ``zero_copy=True`` yields numpy arrays that VIEW the native ring buffer —
    no per-batch copy. Such arrays are valid only until the next iteration
    step (the previous batch is released when the next is requested), which
    matches the training-loop pattern: put the batch on the device, then ask
    for the next one.
    """

    def __init__(
        self,
        paths: Sequence[str],
        num_threads: int = 4,
        capacity: int = 8,
        zero_copy: bool = False,
    ):
        self.paths = list(paths)
        self.num_threads = num_threads
        self.capacity = capacity
        self.zero_copy = zero_copy

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        lib = _load_lib()
        c_paths = (ctypes.c_char_p * len(self.paths))(
            *[p.encode("utf-8") for p in self.paths]
        )
        loader = lib.sfb_open(c_paths, len(self.paths), self.num_threads, self.capacity)
        pending = None
        try:
            while True:
                batch_ptr = lib.sfb_next(loader)
                if pending is not None:  # release AFTER the consumer moved on
                    lib.sfb_release(pending)
                    pending = None
                if not batch_ptr:
                    return
                err = lib.sfb_batch_error(batch_ptr)
                if err:
                    lib.sfb_release(batch_ptr)
                    raise IOError(
                        f"native ingest error: {err.decode()}"
                    )
                if self.zero_copy:
                    pending = batch_ptr
                    yield self._decode(lib, batch_ptr, copy=False)
                else:
                    try:
                        yield self._decode(lib, batch_ptr, copy=True)
                    finally:
                        lib.sfb_release(batch_ptr)
        finally:
            if pending is not None:
                lib.sfb_release(pending)
            lib.sfb_close(loader)

    @staticmethod
    def _decode(lib, batch_ptr, copy: bool = True) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for i in range(lib.sfb_entry_count(batch_ptr)):
            name = lib.sfb_entry_name(batch_ptr, i).decode()
            dtype = _CODE_DTYPES[lib.sfb_entry_dtype(batch_ptr, i)]
            ndim = lib.sfb_entry_ndim(batch_ptr, i)
            dims = (ctypes.c_uint32 * ndim)()
            lib.sfb_entry_dims(batch_ptr, i, dims)
            nbytes = ctypes.c_uint64()
            ptr = lib.sfb_entry_data(batch_ptr, i, ctypes.byref(nbytes))
            if copy:
                buf = ctypes.string_at(ptr, nbytes.value)
                out[name] = np.frombuffer(buf, dtype=dtype).reshape(tuple(dims))
            else:
                raw = (ctypes.c_uint8 * nbytes.value).from_address(ptr)
                arr = np.frombuffer(raw, dtype=dtype).reshape(tuple(dims))
                arr.flags.writeable = False
                out[name] = arr
        return out


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "build":
        ok = build_native(quiet=False)
        print("built" if ok else "build FAILED")
        sys.exit(0 if ok else 1)
