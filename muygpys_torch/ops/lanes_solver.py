"""Batched Cholesky solver with the batch on the last axis.

Counterpart of :mod:`muygpys_tpu.ops.lanes_solver` (the ``"lanes"``
engine): ``K (n, n, B)``, so each step of the right-looking Cholesky and the
triangular substitutions is one elementwise op over the whole batch.  Plain
PyTorch, run eagerly; a Python loop over ``n`` replaces the unrolled JAX
loop.  The multi-output functions serve the lensing shear family, whose
flattened observation block has ``m = I * n`` rows.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cholesky_bl(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``K`` with shape ``(n, n, B)``.

    Where a pivot falls below the relative floor ``10 eps mean(diag K)``
    (per lane), the pivot is floored and the sub-diagonal column zeroed
    (Gill–Murray style), so a numerically singular neighborhood yields a
    nearby PSD surrogate instead of a NaN that poisons the batch — the same
    rule as ``muygpys_tpu.ops.lanes_solver.cholesky_bl``.
    """
    n = K.shape[0]
    finfo = torch.finfo(K.dtype)
    diag_scale = sum(K[j, j, :] for j in range(n)) / n  # (B,)
    pivot_floor = 10.0 * finfo.eps * torch.clamp_min(diag_scale, finfo.tiny)
    rows = torch.arange(n, device=K.device)[:, None]
    cols = []
    for j in range(n):
        c = K[:, j, :]  # (n, B)
        if j > 0:
            Lj = torch.stack([cols[k][j] for k in range(j)])  # (j, B)
            Lpre = torch.stack(cols, dim=1)  # (n, j, B)
            c = c - torch.einsum("ikb,kb->ib", Lpre, Lj)
        bad = (c[j] < pivot_floor)[None, :]
        d = torch.sqrt(torch.maximum(c[j], pivot_floor))
        col = torch.where(bad, torch.zeros_like(c), c / d)
        col = torch.where(rows == j, d[None, :], col)
        cols.append(torch.where(rows >= j, col, torch.zeros_like(col)))
    return torch.stack(cols, dim=1)  # (n, n, B)


def tri_solve_fwd_bl(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Solve ``L z = R`` with lower ``L (n, n, B)`` and ``R (n, r, B)``."""
    n = L.shape[0]
    zs = []
    for j in range(n):
        acc = R[j]  # (r, B)
        if j > 0:
            Lrow = torch.stack([L[j, k] for k in range(j)])  # (j, B)
            Z = torch.stack(zs)  # (j, r, B)
            acc = acc - torch.einsum("kb,krb->rb", Lrow, Z)
        zs.append(acc / L[j, j])
    return torch.stack(zs)  # (n, r, B)


def tri_solve_bwd_bl(L: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Solve ``L^T x = Z`` with lower ``L (n, n, B)`` and ``Z (n, r, B)``."""
    n = L.shape[0]
    xs = [None] * n
    for j in reversed(range(n)):
        acc = Z[j]
        ks = list(range(j + 1, n))
        if ks:
            Lcol = torch.stack([L[k, j] for k in ks])  # (m, B)
            X = torch.stack([xs[k] for k in ks])  # (m, r, B)
            acc = acc - torch.einsum("kb,krb->rb", Lcol, X)
        xs[j] = acc / L[j, j]
    return torch.stack(xs)


def solve_bl(K: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``K^{-1} R`` for SPD ``K (n, n, B)`` and ``R (n, r, B)``."""
    L = cholesky_bl(K)
    return tri_solve_bwd_bl(L, tri_solve_fwd_bl(L, R))


def serve_mean_and_variance_bl(
    Kin: torch.Tensor,
    Kcross: torch.Tensor,
    Kout,
    nn_targets: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused posterior mean + variance in batch-last layout.

    Args: ``Kin (n, n, B)``, ``Kcross (n, B)``, ``nn_targets (n, r, B)``.
    Returns mean ``(r, B)`` and variance ``(B,)``.
    """
    rhs = torch.cat([Kcross[:, None, :], nn_targets], dim=1)
    sol = solve_bl(Kin, rhs)  # (n, 1+r, B)
    mean = torch.einsum("nb,nrb->rb", Kcross, sol[:, 1:, :])
    var = Kout - torch.einsum("nb,nb->b", Kcross, sol[:, 0, :])
    return mean, var


def serve_mean_and_variance_multiout_bl(
    Kin: torch.Tensor,
    Kcross: torch.Tensor,
    Kout: torch.Tensor,
    nn_targets: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-output posterior (full covariance block) in batch-last layout,
    for kernels whose cross-covariance carries an output dimension (the
    lensing shear family): ``Kin (m, m, B)`` with ``m`` the flattened
    observation size, ``Kcross (m, o, B)``, ``Kout (o, o)``,
    ``nn_targets (m, B)``.

    One forward substitution against the stacked ``[Kcross | y]`` serves
    both moments: with ``z = L^{-1} [Kcross | y]``, ``mean = zc^T zy`` and
    ``cov = Kout - zc^T zc``.  Returns mean ``(o, B)`` and posterior
    covariance ``(o, o, B)``.
    """
    o = Kcross.shape[1]
    rhs = torch.cat([Kcross, nn_targets[:, None, :]], dim=1)
    z = tri_solve_fwd_bl(cholesky_bl(Kin), rhs)  # (m, o+1, B)
    zc, zy = z[:, :o, :], z[:, o, :]
    mean = torch.einsum("mob,mb->ob", zc, zy)
    Kout = torch.as_tensor(Kout, dtype=Kin.dtype, device=Kin.device)
    cov = Kout[:, :, None] - torch.einsum("mob,mpb->opb", zc, zc)
    return mean, cov


def multiout_frontend_bl(
    Kin: torch.Tensor, Kcross: torch.Tensor, nn_targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frontend block layout to batch-last operands: ``Kin (B, I, n, I, n)``,
    ``Kcross (B, I, n, O)``, ``nn_targets (B, I, n)`` become ``(m, m, B)``,
    ``(m, O, B)``, ``(m, B)`` with ``m = I * n`` (views, nothing is copied)."""
    B, I, n = Kin.shape[0], Kin.shape[1], Kin.shape[2]
    m = I * n
    o = Kcross.shape[-1]
    return (
        Kin.reshape(B, m, m).permute(1, 2, 0),
        Kcross.reshape(B, m, o).permute(1, 2, 0),
        nn_targets.reshape(B, m).T,
    )


def multiout_serve_mean_and_variance(
    Kin: torch.Tensor,
    Kcross: torch.Tensor,
    Kout: torch.Tensor,
    nn_targets: torch.Tensor,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frontend-layout multi-output serve through the batch-last solver:
    ``Kin (B, I, n, I, n)``, ``Kcross (B, I, n, O)``, ``nn_targets
    (B, I, n)``, ``Kout (O, O)``; returns mean ``(B, O)`` and posterior
    covariance ``(B, O, O)``."""
    Kin_bl, Kc_bl, y_bl = multiout_frontend_bl(Kin, Kcross, nn_targets)
    mean, cov = serve_mean_and_variance_multiout_bl(Kin_bl, Kc_bl, Kout, y_bl)
    return mean.T, cov.permute(2, 0, 1)
