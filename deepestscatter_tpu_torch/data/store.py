"""The typed record store: tables of fixed-size records in mmap'd files.

The port of ``deepestscatter_tpu.data.store`` (reference: Dataset.h,
LmdbDataset.py): typed tables named after their record type, integer keys,
atomic ``batch_append``, ``count``-based resume, a guarded ``drop``, and a
Train/Validation/Test triplet of stores.  The engine is this package's own
copy of the C++ store, ``csrc/recordstore.cpp``, compiled by g++ at first
use into ``_build/`` (beside the kernels' builds, named by a digest of the
source and flags) and loaded with ctypes.  The file layout is the JAX
package's, so a store written by either package reads back through the
other.  Batches move as numpy structured arrays of ``records.SCHEMAS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

from .. import cuda_build
from . import records

SOURCE = cuda_build.CSRC / "recordstore.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib = None


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the record store cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return cuda_build.BUILD_DIR / f"librecordstore-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/recordstore.cpp`` unless its library is built; raise
    with the compiler's output if the build fails."""
    path = library_path()
    if path.is_file():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"record store build failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, u64 = ctypes.c_void_p, ctypes.c_uint64
        for name, res, args in (
            ("rs_open", vp, [ctypes.c_char_p, u64]),
            ("rs_count", u64, [vp]),
            ("rs_record_size", u64, [vp]),
            ("rs_write", ctypes.c_int, [vp, u64, vp, u64]),
            ("rs_read", u64, [vp, u64, vp, u64]),
            ("rs_gather", ctypes.c_int, [vp, vp, vp, u64]),
            ("rs_drop", ctypes.c_int, [vp]),
            ("rs_close", None, [vp]),
        ):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


class Table:
    """One typed table backed by a native mmap file."""

    def __init__(self, path: str, dtype: np.dtype):
        self._lib = _load_lib()
        self.dtype = dtype
        self.path = path
        self._handle = self._lib.rs_open(path.encode(), dtype.itemsize)
        if not self._handle:
            raise OSError(f"failed to open record table {path} (schema change?)")

    def count(self) -> int:
        return int(self._lib.rs_count(self._handle))

    def batch_append(self, start_id: int, batch: np.ndarray) -> None:
        """Write ``batch`` at ids [start_id, start_id + len) atomically (the
        reference's one-transaction batchAppend, Dataset.h:203-232)."""
        batch = np.ascontiguousarray(batch, dtype=self.dtype)
        err = self._lib.rs_write(self._handle, start_id,
                                 batch.ctypes.data_as(ctypes.c_void_p), len(batch))
        if err != 0:
            raise OSError(f"rs_write failed: errno {-err}")

    def read(self, start_id: int, n: int) -> np.ndarray:
        """Up to ``n`` records from ``start_id`` (fewer past the count)."""
        out = np.empty(n, self.dtype)
        got = self._lib.rs_read(self._handle, start_id,
                                out.ctypes.data_as(ctypes.c_void_p), n)
        return out[: int(got)]

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Records by id; raises on any id at or past the count."""
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        out = np.empty(len(ids), self.dtype)
        err = self._lib.rs_gather(self._handle, ids.ctypes.data_as(ctypes.c_void_p),
                                  out.ctypes.data_as(ctypes.c_void_p), len(ids))
        if err != 0:
            raise IndexError(f"rs_gather: id out of range (count={self.count()}) in {self.path}")
        return out

    def get_record(self, record_id: int) -> np.void:
        got = self.read(record_id, 1)
        if len(got) == 0:
            raise KeyError(f"record {record_id} not in {self.path}")
        return got[0]

    def drop(self, confirm: str = "") -> None:
        """Drop every record; ``confirm`` must name the table (the
        reference asks for a typed confirmation, Dataset.h:110-142)."""
        name = os.path.splitext(os.path.basename(self.path))[0]
        if confirm != name:
            raise PermissionError(f"refusing to drop {name}: pass confirm='{name}'")
        self._lib.rs_drop(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.rs_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RecordStore:
    """A directory of typed tables, ``<root>/<RecordType>.rec``."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._tables: Dict[str, Table] = {}

    def table(self, name: str) -> Table:
        if name not in self._tables:
            self._tables[name] = Table(os.path.join(self.root, f"{name}.rec"),
                                       records.SCHEMAS[name])
        return self._tables[name]

    def count(self, name: str) -> int:
        return self.table(name).count()

    def close(self) -> None:
        for t in self._tables.values():
            t.close()
        self._tables.clear()


class DatasetTriplet:
    """Train/Validation/Test stores under one root (LmdbDataset.py
    LmdbDatasets, :106-122)."""

    def __init__(self, root: str):
        self.root = root
        self.train = RecordStore(os.path.join(root, "Train"))
        self.validation = RecordStore(os.path.join(root, "Validation"))
        self.test = RecordStore(os.path.join(root, "Test"))

    def all(self) -> Dict[str, RecordStore]:
        return {"train": self.train, "validation": self.validation, "test": self.test}
