"""Neighborhood tensor assembly ops.

Counterpart of :mod:`muygpys_tpu.ops.tensors`: feature differences, the
``F2``/``l2`` collapses, ``safe_sqrt`` and the Gram-identity distance
assembly (``|a-b|^2 = |a|^2 + |b|^2 - 2 a.b``) that never materializes the
``(batch, nn, nn, feat)`` difference tensor; and the fast posterior mean's
self-inclusive neighborhoods (``fast_nn_update``,
``make_fast_predict_tensors``).  Index tensors are ``int64`` (PyTorch's
gather type).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _atleast_feature_dim(data: torch.Tensor) -> torch.Tensor:
    return data[:, None] if data.ndim == 1 else data


def crosswise_diffs(data, nn_data, data_indices, nn_indices) -> torch.Tensor:
    """Feature-wise differences between batch points and their neighbors,
    shape ``(batch, nn, feat)``."""
    locations = _atleast_feature_dim(data)[data_indices]
    points = _atleast_feature_dim(nn_data)[nn_indices]
    return locations[..., :, None, :] - points


def pairwise_diffs(data, nn_indices) -> torch.Tensor:
    """Pairwise feature differences within each neighborhood,
    shape ``(batch, nn, nn, feat)``."""
    points = _atleast_feature_dim(data)[nn_indices]
    return points[..., :, None, :] - points[..., None, :, :]


def crosswise_differences(locations, points) -> torch.Tensor:
    """Raw point-set crosswise differences ``(n, m, feat)``."""
    locations = _atleast_feature_dim(locations)
    points = _atleast_feature_dim(points)
    return locations[:, None, :] - points


def pairwise_differences(points) -> torch.Tensor:
    """Raw point-set pairwise differences: ``(n, n, 1)`` for ``(n,)``
    points, ``(n, n, feat)`` for ``(n, feat)``, ``(b, n, n, feat)`` for
    ``(b, n, feat)``."""
    if points.ndim == 1:
        return (points[:, None] - points[None, :])[:, :, None]
    if points.ndim == 2:
        return points[:, None, :] - points[None, :, :]
    if points.ndim == 3:
        return points[:, :, None, :] - points[:, None, :, :]
    raise ValueError(f"points shape {tuple(points.shape)} is not supported")


def F2(diffs: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences over the trailing (feature) axis."""
    return torch.sum(diffs**2, dim=-1)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with an exact 0 (and a zero, not infinite, gradient) at zeros —
    the pairwise tensors' diagonals are exact zeros."""
    positive = x > 0.0
    return torch.where(
        positive,
        torch.sqrt(torch.where(positive, x, torch.ones_like(x))),
        torch.zeros_like(x),
    )


def l2(diffs: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the trailing (feature) axis."""
    return safe_sqrt(F2(diffs))


def pairwise_F2(data, nn_indices) -> torch.Tensor:
    """Squared-l2 distances ``(batch, nn, nn)`` among each neighborhood via
    the Gram identity, clamped at 0 against cancellation.

    Each neighborhood is first moved to its first point.  The identity
    loses ~eps * |a|^2 absolute, which in f32 on unit-scale coordinates is
    a few 1e-7 against squared neighbor distances of ~1e-4: enough to make
    a neighborhood's kernel matrix indefinite at a short length scale and a
    small noise.  The shift is exact for nearby points (Sterbenz), so the
    loss falls to ~eps * |a - b|^2."""
    points = _atleast_feature_dim(data)[nn_indices]
    points = points - points[..., :1, :]
    sq = torch.sum(points * points, dim=-1)
    gram = points @ points.transpose(-2, -1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * gram
    return torch.clamp_min(d2, 0.0)


def crosswise_F2(data, nn_data, data_indices, nn_indices) -> torch.Tensor:
    """Squared-l2 distances ``(batch, nn)`` between batch points and their
    neighbors, by direct differences (the ``(batch, nn, feat)`` neighbor
    tensor is gathered either way, so the Gram identity would save nothing
    and lose the precision :func:`pairwise_F2` keeps); 1-D ``nn_indices``
    give one candidate set shared by every location (a knot grid)."""
    locations = _atleast_feature_dim(data)[data_indices]  # (batch, feat)
    points = _atleast_feature_dim(nn_data)[nn_indices]  # ([batch,] nn, feat)
    return F2(points - locations[..., None, :])


def make_heteroscedastic_tensor(measurement_noise, batch_nn_indices):
    """Per-neighbor noise variances ``(batch, nn)``."""
    return measurement_noise[batch_nn_indices]


def fast_nn_update(train_nn_indices: torch.Tensor) -> torch.Tensor:
    """Self-inclusive neighborhoods: row ``i`` becomes ``[i, nn_0, ...,
    nn_{k-2}]`` (the last neighbor drops out)."""
    train_count = train_nn_indices.shape[0]
    self_col = torch.arange(
        train_count, dtype=train_nn_indices.dtype,
        device=train_nn_indices.device,
    )[:, None]
    return torch.cat((self_col, train_nn_indices[:, :-1]), dim=1)


def make_fast_predict_tensors(
    batch_nn_indices, train_features, train_targets
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise differences ``(batch, nn, nn, feat)`` and targets over the
    self-inclusive neighborhoods of ``batch_nn_indices``."""
    nn_fast = fast_nn_update(batch_nn_indices)
    return pairwise_diffs(train_features, nn_fast), train_targets[nn_fast]


def batch_features_tensor(features, batch_indices) -> torch.Tensor:
    """The batch's feature rows ``(batch, feat)``."""
    return _atleast_feature_dim(features)[batch_indices]
