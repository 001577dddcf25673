"""ctypes binding of the port's HNSW index (``hnsw.cpp`` beside this file).

Counterpart of :mod:`muygpys_tpu.native.hnsw`: the same C++ source (the
port keeps its own copy) compiled with the same ``g++`` flags, and the same
surface: construction, ``add_items``, ``knn_query`` returning
``(indices int64, squared_l2_distances float32)``.

The library is built on first use into ``build/muygpys_torch/`` beside the
package (git-ignored), never into the package directory.  Its name carries a
digest of the source and the flags, so an edited source is rebuilt; the
build runs under a file lock in the build directory (one process compiles,
the others wait and load its library) and renames a temporary file into
place, so no process ever loads a half-written library.  A failed build
raises with the compiler's output.  The index is host code: it runs on the
CPU whatever device the caller's tensors live on.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "hnsw.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "muygpys_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
             "-pthread")
_BUILD_LOCK = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library is built: the name carries a digest of the source
    and the compiler flags."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libhnsw_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source if its library is not on disk; returns the
    library's path.  Raises ``RuntimeError`` with the compiler's output when
    ``g++`` fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # built by another process while this one waited
            return so
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {SRC.name} (exit {proc.returncode}):\n"
                + proc.stdout + proc.stderr
            )
        os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _BUILD_LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.hnsw_create.restype = ctypes.c_void_p
        lib.hnsw_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64,
        ]
        lib.hnsw_free.restype = None
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        lib.hnsw_add_items.restype = None
        lib.hnsw_add_items.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.hnsw_search.restype = None
        lib.hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.hnsw_size.argtypes = [ctypes.c_void_p]
        lib.hnsw_size.restype = ctypes.c_int
        _lib = lib
    return _lib


class HNSW:
    """Approximate KNN over squared l2, built on the native C++ graph."""

    def __init__(
        self,
        dim: int,
        max_elements: int = 0,
        M: int = 16,
        ef_construction: int = 200,
        random_seed: int = 0,
    ):
        self._lib = _load()
        self.dim = dim
        self._handle = self._lib.hnsw_create(
            dim, max_elements, M, ef_construction, random_seed
        )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.hnsw_free(handle)
            self._handle = None

    def add_items(self, data) -> None:
        data = np.ascontiguousarray(data, dtype=np.float32)
        if data.ndim != 2 or data.shape[1] != self.dim:
            raise ValueError(
                f"expected (n, {self.dim}) data, got {data.shape}"
            )
        self._lib.hnsw_add_items(self._handle, data.shape[0], data)

    def knn_query(
        self, queries, k: int, ef: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(
                f"expected (n, {self.dim}) queries, got {queries.shape}"
            )
        n = queries.shape[0]
        if ef is None:
            ef = max(2 * k, 64)
        idx = np.empty((n, k), dtype=np.int32)
        dist = np.empty((n, k), dtype=np.float32)
        self._lib.hnsw_search(self._handle, n, queries, k, ef, idx, dist)
        return idx.astype(np.int64), dist

    def __len__(self) -> int:
        return self._lib.hnsw_size(self._handle)
