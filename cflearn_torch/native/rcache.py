"""ctypes bindings of the rcache store (`rcache.cpp`), built at first use.

The library is compiled by the host's C++ compiler into
`cflearn_torch/_build/` (ignored by git), named by a hash of the source, and
loaded with `ctypes`. Where no compiler is found the store is read and
written with numpy: the format is the same (a 24-byte header of three
little-endian u64, magic, count and record size, then the records), so
either path opens a store that the other, or the JAX package, wrote.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "rcache.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_HEADER_BYTES = 24
RC_MAGIC = 0x52434143484531  # "RCACHE1"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"librcache_{digest}.so"


def _compile(path: Path) -> bool:
    """Compile the source to `path` through a per-process temporary file
    and an atomic rename, so that an interrupted or concurrent build never
    leaves a truncated library behind."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        for cc in ("c++", "g++", "clang++"):
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(_SRC), "-lpthread"],
                    check=True, capture_output=True, timeout=120,
                )
            except (FileNotFoundError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
                continue
            os.replace(tmp, path)
            return True
        return False
    finally:
        if tmp.is_file():
            tmp.unlink()


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None without a compiler."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.is_file() and not _compile(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        u8p, i64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
        lib.rc_open.restype, lib.rc_open.argtypes = ctypes.c_void_p, [ctypes.c_char_p]
        lib.rc_close.argtypes = [ctypes.c_void_p]
        lib.rc_num_records.restype, lib.rc_num_records.argtypes = ctypes.c_uint64, [ctypes.c_void_p]
        lib.rc_record_size.restype, lib.rc_record_size.argtypes = ctypes.c_uint64, [ctypes.c_void_p]
        lib.rc_gather.restype = ctypes.c_int
        lib.rc_gather.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64, u8p]
        lib.rc_write.restype = ctypes.c_int
        lib.rc_write.argtypes = [ctypes.c_char_p, u8p, ctypes.c_uint64, ctypes.c_uint64]
        _lib = lib
        return _lib


def has_native() -> bool:
    return load_library() is not None


def write_records(path: str, records: np.ndarray) -> None:
    """Write (N, record_size) uint8 `records` as a store, through the native
    writer where it is built, else with numpy."""
    records = np.ascontiguousarray(records, dtype=np.uint8)
    n, size = records.shape
    lib = load_library()
    if lib is not None:
        if lib.rc_write(str(path).encode(), records.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, size) == 0:
            return
    with open(path, "wb") as f:
        f.write(np.array([RC_MAGIC, n, size], dtype="<u8").tobytes())
        f.write(records.tobytes())


class RecordCache:
    """Random access to a store's records: the native mmap and gather, or a
    numpy memmap where the library is not built."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._lib = load_library()
        self._handle = self._lib.rc_open(self.path.encode()) if self._lib is not None else None
        self._payload: Optional[np.ndarray] = None
        if self._handle:
            self.num_records = int(self._lib.rc_num_records(self._handle))
            self.record_size = int(self._lib.rc_record_size(self._handle))
            return
        header = np.fromfile(self.path, dtype="<u8", count=3)
        if len(header) < 3 or int(header[0]) != RC_MAGIC:
            raise ValueError(f"'{path}' is not an rcache store")
        self.num_records, self.record_size = int(header[1]), int(header[2])
        self._payload = np.memmap(self.path, dtype=np.uint8, mode="r", offset=_HEADER_BYTES,
                                  shape=(self.num_records, self.record_size))

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """(len(indices), record_size) uint8; an index out of range raises
        on either path."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        if len(indices) and (indices.min() < 0 or indices.max() >= self.num_records):
            raise IndexError("rcache gather: index out of range")
        if not self._handle:
            assert self._payload is not None
            return np.asarray(self._payload[indices])
        out = np.empty((len(indices), self.record_size), dtype=np.uint8)
        err = self._lib.rc_gather(self._handle, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                  len(indices), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if err != 0:
            raise IndexError("rc_gather: index out of range")
        return out

    def close(self) -> None:
        if self._handle and self._lib is not None:
            self._lib.rc_close(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001  (interpreter shutdown)
            pass

    def __len__(self) -> int:
        return self.num_records
