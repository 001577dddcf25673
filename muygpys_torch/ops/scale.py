"""Analytic sigma^2 (variance scale) estimation.

Counterpart of :mod:`muygpys_tpu.ops.scale`:

    sigma^2 = (1 / (b n)) sum_i Y_i^T (Kin_i + eps)^{-1} Y_i

through one batched Cholesky, ``y^T K^{-1} y = |L^{-1} y|^2``, for
``Kin (b, n, n)`` and for the multi-output block layout ``(b, i, n, i, n)``
(flattened to ``i * n`` rows; the normalization stays ``b * n``).  Optional
``row_weights`` (0/1 per batch row) mask rows out of the numerator, and
``batch_count_global`` replaces the batch count of the normalization, as in
the JAX package.  Inside a sharded computation
(:func:`muygpys_torch.parallel.comm.reducing`) the numerator and the count
are global: each is all-reduced over the ranks, and the count is the global
sum of ``row_weights`` where they are given.
"""

from __future__ import annotations

from typing import Optional

import torch

from muygpys_torch.ops import solve as _solve
from muygpys_torch.parallel import comm


def _flatten(Kin, nn_targets):
    if Kin.ndim == 3:
        y = nn_targets if nn_targets.ndim == 3 else nn_targets[:, :, None]
        return Kin, y, Kin.shape[1]
    if Kin.ndim == 5:
        b, in_count, nn_count = Kin.shape[:3]
        all_count = in_count * nn_count
        return (
            Kin.reshape(b, all_count, all_count),
            nn_targets.reshape(b, all_count, 1),
            nn_count,
        )
    raise ValueError(
        f"unsupported Kin shape {tuple(Kin.shape)} for scale optim"
    )


def analytic_scale_optim_unnormalized(Kin, nn_targets, row_weights=None,
                                      **kwargs):
    """``sum_i w_i |L_i^{-1} Y_i|^2`` for ``Kin (b, n, n)``, ``nn_targets
    (b, n)`` or ``(b, n, r)``."""
    if nn_targets.ndim == 2:
        nn_targets = nn_targets[:, :, None]
    L = _solve.cholesky(Kin)
    W = torch.linalg.solve_triangular(L, nn_targets, upper=False)
    terms = W * W
    if row_weights is not None:
        terms = terms * torch.as_tensor(
            row_weights, dtype=terms.dtype, device=terms.device
        ).reshape(-1, 1, 1)
    return comm.batch_sum(terms)


def analytic_scale_optim(
    Kin,
    nn_targets,
    batch_count_global: Optional[float] = None,
    row_weights=None,
    **kwargs,
):
    """sigma^2 = numerator / (batch_count_global * nn_count).

    Without ``batch_count_global`` the count is the batch size, or the sum
    of ``row_weights`` where they are given."""
    Kin_flat, y_flat, nn_count = _flatten(Kin, nn_targets)
    if batch_count_global is None:
        if row_weights is not None:
            batch_count_global = comm.batch_sum(torch.as_tensor(
                row_weights, dtype=Kin.dtype, device=Kin.device
            ))
        else:
            batch_count_global = comm.batch_total(Kin.shape[0], Kin)
    return analytic_scale_optim_unnormalized(
        Kin_flat, y_flat, row_weights=row_weights
    ) / (batch_count_global * nn_count)
