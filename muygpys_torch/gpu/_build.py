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
memory) is never silent.  The runtime launches, and sets kernel attributes,
on the calling thread's current device, so every wrapper calls its entry
point inside :func:`on_device` of the tensors' device.

A launch recorded during a CUDA graph capture (:func:`recording`, used by
:mod:`muygpys_torch.gpu.graphs`) is counted at each replay of the graph
instead, so :data:`launches` says how often each kernel ran either way.

Nothing here runs at import: the CPU-only test machines have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import contextvars
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
SOURCES = ("fused_predict", "knn", "fused_train", "multiout_solve",
           "matern_nu_coeffs")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-I", str(CSRC),
)
# flags of one source beside NVCC_FLAGS: K4's constructor mirrors its plain
# version's operations one rounding at a time, so nothing may be contracted
# into a fused multiply-add
EXTRA_FLAGS = {"matern_nu_coeffs": ("-fmad=false",)}

# launches per kernel, counted by the wrappers where they launch (plain ints;
# ``reset_launches`` zeroes them before a run whose path is to be shown).
# K1, K1b, K2, K3 and K5 have two designs each: "<kernel>/<design>" counts
# the launches of one design, "<kernel>" those of both (K3:
# "knn_candidates" and "knn_candidates_pruned" count its two variants,
# "knn_candidates/<design>" the designs of both variants)
launches: Dict[str, int] = {
    "fused_predict_coords": 0,
    "fused_predict_coords/registers": 0,
    "fused_predict_coords/shared": 0,
    "fused_predict": 0,
    "fused_predict/registers": 0,
    "fused_predict/shared": 0,
    "knn_candidates": 0,
    "knn_candidates_pruned": 0,
    "knn_candidates/fused": 0,
    "knn_candidates/keys": 0,
    "fused_train_stats": 0,
    "fused_train_stats/registers": 0,
    "fused_train_stats/shared": 0,
    "multiout_solve": 0,
    "multiout_solve/registers": 0,
    "multiout_solve/shared": 0,
    "matern_nu_coeffs": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
# the launches a CUDA graph capture in progress records instead of counting
# (muygpys_torch.gpu.graphs adds them again at every replay)
_recording = contextvars.ContextVar("recording", default=None)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count(*names: str) -> None:
    """Add one launch to each named count: a wrapper calls it where it
    launches its kernel, and nowhere else.  During a capture
    (:func:`recording`) the launch is recorded, not counted: the kernel
    runs, and counts, when the graph is replayed."""
    target = _recording.get()
    if target is None:
        target = launches
    for name in names:
        target[name] = target.get(name, 0) + 1


@contextlib.contextmanager
def recording():
    """Record the launches of a CUDA graph capture: yields the dict of
    counts the capture's launches add to, which :func:`add_launches`
    adds to :data:`launches` at each replay."""
    counts: Dict[str, int] = {}
    token = _recording.set(counts)
    try:
        yield counts
    finally:
        _recording.reset(token)


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches a replayed graph made (recorded at capture)."""
    for name, n in counts.items():
        launches[name] += n


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
    digest.update(" ".join(NVCC_FLAGS[:-2] + EXTRA_FLAGS.get(name, ())).encode())
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
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
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


def on_device(device):
    """Context that makes ``device`` the current CUDA device: a wrapper
    calls its C entry point inside it, so the launch, and any kernel
    attribute the entry point sets, goes to the device whose stream and
    pointers it was given, whichever device the caller had current."""
    import torch

    return torch.cuda.device(device)
