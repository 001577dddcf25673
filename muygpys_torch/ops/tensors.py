"""Neighborhood tensor assembly ops.

Counterpart of :mod:`muygpys_tpu.ops.tensors`: feature differences, the
``F2``/``l2`` collapses, ``safe_sqrt`` and the Gram-identity distance
assembly (``|a-b|^2 = |a|^2 + |b|^2 - 2 a.b``) that never materializes the
``(batch, nn, nn, feat)`` difference tensor.  Index tensors are ``int64``
(PyTorch's gather type).
"""

from __future__ import annotations

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
    the Gram identity, clamped at 0 against cancellation."""
    points = _atleast_feature_dim(data)[nn_indices]
    sq = torch.sum(points * points, dim=-1)
    gram = points @ points.transpose(-2, -1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * gram
    return torch.clamp_min(d2, 0.0)


def crosswise_F2(data, nn_data, data_indices, nn_indices) -> torch.Tensor:
    """Squared-l2 distances ``(batch, nn)`` between batch points and their
    neighbors via the Gram identity."""
    locations = _atleast_feature_dim(data)[data_indices]  # (batch, feat)
    points = _atleast_feature_dim(nn_data)[nn_indices]  # (batch, nn, feat)
    gram = torch.einsum("bf,bnf->bn", locations, points)
    d2 = (
        torch.sum(locations * locations, dim=-1)[..., None]
        + torch.sum(points * points, dim=-1)
        - 2.0 * gram
    )
    return torch.clamp_min(d2, 0.0)


def make_heteroscedastic_tensor(measurement_noise, batch_nn_indices):
    """Per-neighbor noise variances ``(batch, nn)``."""
    return measurement_noise[batch_nn_indices]
