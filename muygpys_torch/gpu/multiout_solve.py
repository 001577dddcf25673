"""K5: fused multi-output (block) posterior solve, CUDA kernel wrapper and
its plain PyTorch version.

Counterpart of :mod:`muygpys_tpu.pallas.multiout_solve`.  The lensing shear
family conditions each query on a flattened observation block of
``m = I * nn`` rows and predicts ``o`` outputs with their full covariance.
The kernel (``csrc/multiout_solve.cu``) eliminates the augmented
``[Kin | Kcross | y]`` of one query with the relative Gill-Murray pivot floor
of :func:`muygpys_torch.ops.lanes_solver.cholesky_bl` and reads off
``mean = zc^T zy`` and ``S = zc^T zc``; ``cov = Kout - S`` is formed here.
It has two hand-written designs, chosen by shape (:func:`multiout_design`):
the matrix in registers for the compiled shear shapes (:data:`REGISTER_SHAPES`),
in shared memory for any other shape that fits.

Two entries share each design, which takes strides: the batch-last
contract of the JAX package (:func:`fused_multiout_solve_bl`) and the
frontend layout the serving path holds (:func:`multiout_serve_cuda`), passed
as it is, without the transpose the batch-last layout would cost.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from muygpys_torch import config
from muygpys_torch.gpu import _build
from muygpys_torch.ops.lanes_solver import multiout_frontend_bl

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

#: shared memory one block can use on an H100 (bytes)
MAX_SHARED_BYTES = 232448
#: the (m, o) the register design is compiled for, by dtype: the shear blocks
#: of 3-in/3-out (m = 90) and 2-in/3-out (m = 60) at nn = 30.  In f64 at
#: m = 60 the shared-memory design was as fast on an H100 (PERF.md,
#: Findings), so only m = 90 is compiled there
REGISTER_SHAPES = {
    torch.float32: ((90, 3), (60, 3)),
    torch.float64: ((90, 3),),
}


def multiout_shared_bytes(m: int, o: int, dtype) -> int:
    """Shared memory of one query's block in the shared-memory design: the
    augmented ``m x (m + o + 1)`` matrix and the ``m`` pivot scales.  The
    launcher's rule: one query per block, and a shape over
    :data:`MAX_SHARED_BYTES` is refused."""
    return dtype.itemsize * (m * (m + o + 1) + m)


@functools.lru_cache(maxsize=None)
def multiout_design(m: int, o: int, dtype) -> str:
    """The K5 design the launcher takes: "registers" for a shape compiled
    in ``dtype`` (:data:`REGISTER_SHAPES`), else "shared" when one query
    fits a block's shared memory; raises ``ValueError`` otherwise."""
    if dtype not in REGISTER_SHAPES:
        raise ValueError(f"fused_multiout_solve takes f32 or f64, not {dtype}")
    if (m, o) in REGISTER_SHAPES[dtype]:
        return "registers"
    need = multiout_shared_bytes(m, o, dtype)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"fused_multiout_solve: one query's augmented {m} x {m + o + 1} "
            f"matrix takes {need} bytes of shared memory in {dtype}, over "
            f"the {MAX_SHARED_BYTES} a block can use"
        )
    return "shared"


def fused_multiout_solve_bl_plain(
    Kin: torch.Tensor, Kcross: torch.Tensor, Kout, y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5, step by step as the kernel: ``Kin
    (m, m, B)``, ``Kcross (m, o, B)``, ``Kout (o, o)``, ``y (m, B)``; mean
    ``(o, B)``, covariance ``(o, o, B)``.

    Right-looking elimination of ``[Kin | Kcross | y]``: the floor comes
    from the mean diagonal of the input, before the loop; pivot ``j`` is
    ``sqrt(max(piv, floor))`` and row ``j`` is divided by it; the column
    below the pivot (read from the LOWER triangle, the row from the UPPER)
    is zeroed where the floor acted, so the trailing block is then left
    untouched; the whole trailing square is updated.
    """
    m, o = Kin.shape[0], Kcross.shape[1]
    finfo = torch.finfo(Kin.dtype)
    work = torch.cat([Kin, Kcross, y[:, None, :]], dim=1)  # (m, m+o+1, B)
    diag_scale = sum(work[j, j, :] for j in range(m)) / m
    floor = 10.0 * finfo.eps * torch.clamp_min(diag_scale, finfo.tiny)
    for j in range(m):
        piv = work[j, j, :]
        bad = (piv < floor)[None, :]
        inv = 1.0 / torch.sqrt(torch.maximum(piv, floor))
        rowj = work[j, j:, :] * inv[None, :]
        work[j, j:, :] = rowj
        if j < m - 1:
            lcol = work[j + 1:, j, :] * inv[None, :]
            lcol = torch.where(bad, torch.zeros_like(lcol), lcol)
            work[j + 1:, j:, :] = (
                work[j + 1:, j:, :] - lcol[:, None, :] * rowj[None, :, :]
            )
    zc = work[:, m:m + o, :]  # (m, o, B) = L^{-1} Kcross
    zy = work[:, m + o, :]  # (m, B) = L^{-1} y
    mean = torch.sum(zc * zy[:, None, :], dim=0)
    S = torch.sum(zc[:, :, None, :] * zc[:, None, :, :], dim=0)
    Kout = torch.as_tensor(Kout, dtype=Kin.dtype, device=Kin.device)
    return mean, Kout[:, :, None] - S


def _launch(Kin, Kcross, y, m, o, B, batch_last, design=None):
    """One K5 launch on CUDA tensors in either layout: the design of
    :func:`multiout_design`, or ``design`` where a caller compares the two
    (the kernel refuses a register launch of a shape it was not compiled
    for); returns ``(mean, S)`` in the same layout."""
    dtype, dev = Kin.dtype, Kin.device
    chosen = multiout_design(m, o, dtype)  # refuses what neither design takes
    design = design or chosen
    Kin, Kcross, y = Kin.contiguous(), Kcross.contiguous(), y.contiguous()
    shape = ((o, B), (o, o, B)) if batch_last else ((B, o), (B, o, o))
    mean = torch.empty(shape[0], dtype=dtype, device=dev)
    S = torch.empty(shape[1], dtype=dtype, device=dev)
    symbol = "multiout_solve_f32" if dtype == torch.float32 else "multiout_solve_f64"
    _build.check(
        _build.function("multiout_solve", symbol, _ARGTYPES)(
            _build.ptr(Kin), _build.ptr(Kcross), _build.ptr(y),
            _build.ptr(mean), _build.ptr(S), m, o, B, int(batch_last),
            int(design == "registers"), _build.stream(dev),
        ),
        "multiout_solve", "multiout_solve",
    )
    _build.count("multiout_solve", f"multiout_solve/{design}")
    return mean, S


def fused_multiout_solve_bl(Kin, Kcross, Kout, y, device=None):
    """Posterior (mean, cov) for multi-output blocks through K5, batch-last.

    ``Kin (m, m, B)`` observation blocks (nugget already applied),
    ``Kcross (m, o, B)``, ``Kout (o, o)`` prior output covariance,
    ``y (m, B)`` flattened observations.  Runs on ``device`` (default
    ``"cuda"``): the kernel there, the plain version for ``device="cpu"``.
    Returns mean ``(o, B)`` and posterior covariance ``(o, o, B)``, the
    contract of
    :func:`muygpys_torch.ops.lanes_solver.serve_mean_and_variance_multiout_bl`.
    """
    dev = config.device(device)
    Kin = torch.as_tensor(Kin, device=dev)
    dtype = Kin.dtype
    Kcross, y = (torch.as_tensor(t, dtype=dtype, device=dev) for t in (Kcross, y))
    Kout = torch.as_tensor(Kout, dtype=dtype, device=dev)
    m, B = Kin.shape[0], Kin.shape[-1]
    o = Kcross.shape[1] if Kcross.ndim == 3 else -1
    if (
        Kin.shape != (m, m, B) or Kcross.shape != (m, o, B)
        or y.shape != (m, B) or Kout.shape != (o, o)
    ):
        raise ValueError(
            f"fused_multiout_solve_bl shapes: Kin {tuple(Kin.shape)}, Kcross "
            f"{tuple(Kcross.shape)}, Kout {tuple(Kout.shape)}, y "
            f"{tuple(y.shape)}"
        )
    if dev.type == "cpu":
        return fused_multiout_solve_bl_plain(Kin, Kcross, Kout, y)
    mean, S = _launch(Kin, Kcross, y, m, o, B, batch_last=True)
    return mean, Kout[:, :, None] - S


def multiout_serve_cuda(Kin, Kcross, Kout, nn_targets, device=None):
    """Frontend-layout multi-output serve through K5: ``Kin (B, I, n, I, n)``
    (nugget applied), ``Kcross (B, I, n, O)``, ``nn_targets (B, I, n)``,
    ``Kout (O, O)``; returns mean ``(B, O)`` and covariance ``(B, O, O)``,
    the contract of
    :func:`muygpys_torch.ops.lanes_solver.multiout_serve_mean_and_variance`.

    On a CUDA device the tensors go to the kernel as they are (one query's
    block is contiguous, so nothing is transposed); ``device="cpu"`` runs
    the plain version on the batch-last views.
    """
    dev = config.device(device)
    Kin = torch.as_tensor(Kin, device=dev)
    dtype = Kin.dtype
    Kcross, nn_targets = (
        torch.as_tensor(t, dtype=dtype, device=dev) for t in (Kcross, nn_targets)
    )
    Kout = torch.as_tensor(Kout, dtype=dtype, device=dev)
    if Kin.ndim != 5 or Kin.shape[1:3] != Kin.shape[3:5]:
        raise ValueError(
            f"multiout_serve_cuda takes Kin (B, I, n, I, n), got "
            f"{tuple(Kin.shape)}"
        )
    B, I, n = Kin.shape[:3]
    o = Kcross.shape[-1]
    if (
        Kcross.shape != (B, I, n, o) or nn_targets.shape != (B, I, n)
        or Kout.shape != (o, o)
    ):
        raise ValueError(
            f"multiout_serve_cuda shapes: Kin {tuple(Kin.shape)}, Kcross "
            f"{tuple(Kcross.shape)}, Kout {tuple(Kout.shape)}, nn_targets "
            f"{tuple(nn_targets.shape)}"
        )
    if dev.type == "cpu":
        Kin_bl, Kc_bl, y_bl = multiout_frontend_bl(Kin, Kcross, nn_targets)
        mean, cov = fused_multiout_solve_bl_plain(Kin_bl, Kc_bl, Kout, y_bl)
        return mean.T, cov.permute(2, 0, 1)
    mean, S = _launch(Kin, Kcross, nn_targets, I * n, o, B, batch_last=False)
    return mean, Kout[None] - S
