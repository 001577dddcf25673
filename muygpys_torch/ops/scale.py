"""Analytic sigma^2 (variance scale) estimation.

Counterpart of :mod:`muygpys_tpu.ops.scale`:

    sigma^2 = (1 / (b n)) sum_i Y_i^T (Kin_i + eps)^{-1} Y_i

through one batched Cholesky, ``y^T K^{-1} y = |L^{-1} y|^2``, for
``Kin (b, n, n)`` and for the multi-output block layout ``(b, i, n, i, n)``
(flattened to ``i * n`` rows; the normalization stays ``b * n``).
"""

from __future__ import annotations

import torch

from muygpys_torch.ops import solve as _solve


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


def analytic_scale_optim_unnormalized(Kin, nn_targets, **kwargs):
    """``sum_i |L_i^{-1} Y_i|^2`` for ``Kin (b, n, n)``, ``nn_targets
    (b, n)`` or ``(b, n, r)``."""
    if nn_targets.ndim == 2:
        nn_targets = nn_targets[:, :, None]
    L = _solve.cholesky(Kin)
    W = torch.linalg.solve_triangular(L, nn_targets, upper=False)
    return torch.sum(W * W)


def analytic_scale_optim(Kin, nn_targets, **kwargs):
    """sigma^2 = numerator / (batch_count * nn_count)."""
    Kin_flat, y_flat, nn_count = _flatten(Kin, nn_targets)
    return analytic_scale_optim_unnormalized(Kin_flat, y_flat) / (
        Kin.shape[0] * nn_count
    )
