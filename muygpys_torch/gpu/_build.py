"""Build and bind the hand-written CUDA kernels, and count their launches.

Each source ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface under
``build/muygpys_torch/`` beside the package (git-ignored), and loaded with
``ctypes``.  The library name carries a hash of the source and of every
file under ``csrc/`` it includes (``matern_nu.cuh``), so an edited ``.cu``
or header is rebuilt.  No source includes PyTorch's headers: a build takes
seconds, not minutes.

Every C entry point takes device pointers, sizes and the CUDA stream
(``torch.cuda.current_stream().cuda_stream``), launches without
synchronising and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code, so a refused launch (too many threads, too much shared
memory) is never silent.

Nothing here runs at import: the CPU-only test machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "muygpys_torch"
SOURCES = ("fused_predict", "knn", "fused_train", "multiout_solve")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-I", str(CSRC),
)

# launches per kernel, counted by the wrappers where they launch (plain ints;
# ``reset_launches`` zeroes them before a run whose path is to be shown).
# K2 and K5 have two designs each: "<kernel>/<design>" counts the launches of
# one design, "<kernel>" those of both
launches: Dict[str, int] = {
    "fused_predict_coords": 0,
    "fused_predict": 0,
    "knn_candidates": 0,
    "knn_candidates_pruned": 0,
    "fused_train_stats": 0,
    "fused_train_stats/registers": 0,
    "fused_train_stats/shared": 0,
    "multiout_solve": 0,
    "multiout_solve/registers": 0,
    "multiout_solve/shared": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count(*names: str) -> None:
    """Add one launch to each named count: a wrapper calls it where it
    launches its kernel, and nowhere else."""
    for name in names:
        launches[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
        "muygpys_torch are built on first use on a machine with the CUDA "
        "toolkit"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and every file under ``csrc/`` it includes, directly
    or through another such file."""
    files, queue = [], [CSRC / f"{name}.cu"]
    while queue:
        path = queue.pop()
        if path in files or not path.exists():
            continue
        files.append(path)
        queue += [CSRC / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries a
    digest of the source, the headers it includes and the compiler flags
    (not of where the sources lie)."""
    digest = hashlib.sha256()
    for path in sorted(source_files(name)):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS[:-2]).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together.  Returns the seconds each build took
    (0 for a library already on disk); the compiler's register and
    shared-memory report lands beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            seconds[name] = 0.0
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        log = open(so.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
            log, tmp, so, time.perf_counter(),
        )
    for name, (proc, log, tmp, so, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {rc}):\n"
                + so.with_suffix(".log").read_text()
            )
        os.replace(tmp, so)
    return seconds


def function(
    name: str, symbol: str, argtypes, restype=ctypes.c_int
) -> object:
    """The C entry point ``symbol`` of library ``name``, built if needed,
    with ``argtypes`` set and, by default, an ``int`` (cudaError_t)
    result."""
    key = (name, symbol)
    if key not in _fns:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_libs[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[key] = fn
    return _fns[key]


def check(rc: int, name: str, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        err = function(
            name, "muygpys_cuda_error_string", [ctypes.c_int],
            ctypes.c_char_p,
        )
        raise RuntimeError(
            f"{what} launch failed: CUDA error {rc} "
            f"({err(rc).decode(errors='replace')})"
        )


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (``None`` for an absent optional)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
