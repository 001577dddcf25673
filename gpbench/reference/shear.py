"""Plain reference of the weak-lensing shear Gaussian process over nearest
neighbours: the 3 x 3 covariance of (convergence, shear 1, shear 2) as
second derivatives of a squared-exponential kernel over 2-D sky
coordinates, and each query's posterior mean and 3 x 3 covariance from its
neighbourhood.

Convention: the length scale ``ls`` enters as ``exp(-|dx|^2 / (2 ls))``,
the squared length scale of the underlying kernel.  The nugget is ``2 tau``
on the convergence outputs and ``tau`` on the two shears.  Under the
control's precision the factorisation runs in float32 and every operand of
the solve's products (the factor, the right-hand sides, the solution, the
cross-covariances) is read as TF32's products read it
(``reference/precision.py``).
"""

from __future__ import annotations

import torch

from gpbench.reference.precision import matmul_operand as op


def blocks(dx: torch.Tensor, ls) -> torch.Tensor:
    """The ``(..., 3, 3)`` covariance of the three outputs at differences
    ``dx (..., 2)``."""
    x, y = dx[..., 0], dx[..., 1]
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    e = torch.exp(-r2 / (2.0 * ls)) / ls**4
    xy = x * y
    kk = 0.25 * (8 * ls**2 - 8 * ls * r2 + 2 * x2 * y2 + x2 * x2 + y2 * y2) * e
    k1 = 0.25 * (6 * ls * (y2 - x2) + x2 * x2 - y2 * y2) * e
    k2 = 0.5 * xy * (r2 - 6 * ls) * e
    g11 = 0.25 * (4 * ls**2 - 4 * ls * r2 - 2 * x2 * y2 + x2 * x2
                  + y2 * y2) * e
    g12 = 0.5 * xy * (x2 - y2) * e
    g22 = (ls**2 - ls * r2 + x2 * y2) * e
    rows = [torch.stack(r, dim=-1) for r in
            ((kk, k1, k2), (k1, g11, g12), (k2, g12, g22))]
    return torch.stack(rows, dim=-2)


def posterior(train_x, train_y, nn_idx, queries, ls, tau, scale=1.0,
              block=2048):
    """Posterior mean ``(Q, 3)`` and covariance ``(Q, 3, 3)`` of each
    query from its neighbours ``nn_idx (Q, n)`` and their three-component
    targets ``train_y (N, 3)``, in blocks of queries; NaN where a
    neighbourhood's factorisation fails."""
    means, covs = [], []
    n = nn_idx.shape[1]
    kout = blocks(torch.zeros(2, dtype=train_x.dtype,
                              device=train_x.device), ls)
    noise = torch.cat([torch.full((n,), 2.0 * tau), torch.full((2 * n,), tau)])
    for s in range(0, queries.shape[0], block):
        idx = nn_idx[s:s + block]
        nx = train_x[idx]  # (b, n, 2)
        b = nx.shape[0]
        # (b, n, n, 3, 3) -> (b, 3, n, 3, n) -> (b, 3n, 3n): output-major
        kin = blocks(nx[:, :, None, :] - nx[:, None, :, :], ls)
        kin = kin.permute(0, 3, 1, 4, 2).reshape(b, 3 * n, 3 * n)
        kin = kin + torch.diag(noise.to(kin))
        # (b, n, 3, 3) -> (b, 3, n, 3) -> (b, 3n, 3)
        kc = blocks(queries[s:s + block, None, :] - nx, ls)
        kc = kc.permute(0, 2, 1, 3).reshape(b, 3 * n, 3)
        yv = train_y[idx].permute(0, 2, 1).reshape(b, 3 * n, 1)
        L, info = torch.linalg.cholesky_ex(kin)
        kc = op(kc)
        sol = op(torch.cholesky_solve(op(torch.cat([kc, yv], dim=-1)),
                                      op(L)))
        failed = torch.where(info > 0, torch.nan, 0.0).to(kc.dtype)
        means.append(torch.einsum("bmo,bm->bo", kc, sol[..., 3])
                     + failed[:, None])
        covs.append(scale * (kout - kc.transpose(1, 2) @ sol[..., :3])
                    + failed[:, None, None])
    return torch.cat(means), torch.cat(covs)
