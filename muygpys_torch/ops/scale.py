"""Analytic sigma^2 (variance scale) estimation.

Counterpart of :mod:`muygpys_tpu.ops.scale` for the univariate and
diagonal-multivariate layouts ``Kin (b, n, n)``:

    sigma^2 = (1 / (b n)) sum_i Y_i^T (Kin_i + eps)^{-1} Y_i

through one batched Cholesky, ``y^T K^{-1} y = |L^{-1} y|^2``.  The block
(5-D) layouts of the shear models are not ported yet.
"""

from __future__ import annotations

import torch


def analytic_scale_optim_unnormalized(Kin, nn_targets, **kwargs):
    """``sum_i |L_i^{-1} Y_i|^2`` for ``Kin (b, n, n)``, ``nn_targets
    (b, n)`` or ``(b, n, r)``."""
    if Kin.ndim != 3:
        raise NotImplementedError(
            f"Kin of shape {tuple(Kin.shape)}: multi-output block layouts "
            "are not ported yet"
        )
    if nn_targets.ndim == 2:
        nn_targets = nn_targets[:, :, None]
    L = torch.linalg.cholesky(Kin)
    W = torch.linalg.solve_triangular(L, nn_targets, upper=False)
    return torch.sum(W * W)


def analytic_scale_optim(Kin, nn_targets, **kwargs):
    """sigma^2 = numerator / (batch_count * nn_count)."""
    batch_count, nn_count = Kin.shape[0], Kin.shape[1]
    return analytic_scale_optim_unnormalized(Kin, nn_targets) / (
        batch_count * nn_count
    )
