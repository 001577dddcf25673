"""Batched per-neighborhood posterior solvers, standard layout.

Counterpart of :mod:`muygpys_tpu.ops.solve` for the univariate and
diagonal-multivariate layouts the ``"reference"`` engine and
:class:`muygpys_torch.gp.muygps.MuyGPS` use:
``Kin (b, n, n)``, ``Kcross (b, n)``, ``nn_targets (b, n)`` or
``(b, n, r)``.  The multi-output block layouts (shear) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _check_layout(Kin: torch.Tensor) -> None:
    if Kin.ndim != 3:
        raise NotImplementedError(
            f"Kin of shape {tuple(Kin.shape)}: multi-output block layouts "
            "are not ported yet"
        )


def _as_columns(nn_targets: torch.Tensor):
    squeeze = nn_targets.ndim == 2
    return (nn_targets[:, :, None] if squeeze else nn_targets), squeeze


def posterior_mean(Kin, Kcross, nn_targets, **kwargs) -> torch.Tensor:
    """``mu = Kcross Kin^{-1} Y`` per neighborhood."""
    _check_layout(Kin)
    y, squeeze = _as_columns(nn_targets)
    L = torch.linalg.cholesky(Kin)
    F = torch.cholesky_solve(Kcross[:, :, None], L)  # (b, n, 1)
    mean = (F.transpose(-2, -1) @ y)[:, 0, :]  # (b, r)
    return mean[:, 0] if squeeze else mean


def diagonal_variance(Kin, Kcross, Kout, **kwargs) -> torch.Tensor:
    """``Kout - Kcross Kin^{-1} Kcross^T`` per neighborhood."""
    _check_layout(Kin)
    L = torch.linalg.cholesky(Kin)
    V = torch.linalg.solve_triangular(L, Kcross[:, :, None], upper=False)
    return Kout - torch.sum(V[:, :, 0] ** 2, dim=-1)


def serve_mean_and_variance(
    Kin, Kcross, Kout, nn_targets, **kwargs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused mean + variance from ONE batched solve against the stacked
    right-hand sides ``[Kcross, Y]``."""
    _check_layout(Kin)
    y, squeeze = _as_columns(nn_targets)
    rhs = torch.cat([Kcross[:, :, None], y], dim=-1)
    sol = torch.linalg.solve(Kin, rhs)
    mean = torch.einsum("bn,bnr->br", Kcross, sol[:, :, 1:])
    var = Kout - torch.einsum("bn,bn->b", Kcross, sol[:, :, 0])
    return (mean[:, 0] if squeeze else mean), var
