"""Plain reference of a Matérn Gaussian process over nearest neighbours:
the kernel and the posterior mean and variance of each query from its
neighbourhood.

Written from the model's definition (MuyGPs: each query conditioned on its
``nn`` nearest training points), in plain PyTorch, with a dense Cholesky
solve per neighbourhood.  Distances inside a neighbourhood are taken by
direct differences.  Under the control's precision the factorisation runs
in float32 and every operand of the solve's products (the factor, the
right-hand sides, the solution, the cross-covariances) is read as TF32's
products read it (``reference/precision.py``).
"""

from __future__ import annotations

import math

import torch

from gpbench.reference.precision import matmul_operand as op

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)


def matern(r: torch.Tensor, length_scale, smoothness: float) -> torch.Tensor:
    """The Matérn correlation of distances ``r`` (closed forms)."""
    u = r / length_scale
    if smoothness == 0.5:
        return torch.exp(-u)
    if smoothness == 1.5:
        return (1.0 + SQRT3 * u) * torch.exp(-SQRT3 * u)
    if smoothness == 2.5:
        return (1.0 + SQRT5 * u + 5.0 / 3.0 * u * u) * torch.exp(-SQRT5 * u)
    if smoothness == math.inf:
        return torch.exp(-0.5 * u * u)
    raise ValueError(f"no closed form for smoothness {smoothness}")


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances between ``a (..., n, d)`` and ``b (..., m, d)``
    by direct differences (the gradient at zero distance is zero)."""
    d2 = torch.sum((a[..., :, None, :] - b[..., None, :, :]) ** 2, dim=-1)
    return torch.sqrt(torch.clamp_min(d2, torch.finfo(d2.dtype).tiny))


def neighbourhoods(train_x, train_y, nn_idx, queries, length_scale,
                   smoothness):
    """``(K, kc, y)`` of each query: ``(Q, n, n)``, ``(Q, n)``, ``(Q, n)``,
    with the noise not yet on K's diagonal."""
    nx = train_x[nn_idx]  # (Q, n, d)
    K = matern(_dist(nx, nx), length_scale, smoothness)
    kc = matern(_dist(queries[:, None, :], nx)[:, 0, :], length_scale,
                smoothness)
    return K, kc, train_y[nn_idx]


def nugget(K: torch.Tensor, noise) -> torch.Tensor:
    """``K + noise I``."""
    return K + noise * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def posterior(train_x, train_y, nn_idx, queries, length_scale, noise,
              smoothness, scale=1.0, block=8192):
    """Posterior mean ``(Q,)`` and variance ``(Q,)`` of each query from
    its neighbours ``nn_idx (Q, n)``, in blocks of queries; NaN where a
    neighbourhood's factorisation fails."""
    means, variances = [], []
    for s in range(0, queries.shape[0], block):
        K, kc, y = neighbourhoods(train_x, train_y, nn_idx[s:s + block],
                                  queries[s:s + block], length_scale,
                                  smoothness)
        L, info = torch.linalg.cholesky_ex(nugget(K, noise))
        rhs = op(torch.stack([kc, y], dim=-1))
        sol = op(torch.cholesky_solve(rhs, op(L)))
        kc = op(kc)
        failed = torch.where(info > 0, torch.nan, 0.0).to(kc.dtype)
        means.append(torch.sum(kc * sol[..., 1], dim=-1) + failed)
        variances.append(scale * (1.0 - torch.sum(kc * sol[..., 0], dim=-1))
                         + failed)
    return torch.cat(means), torch.cat(variances)
