"""Loss functions for leave-one-out cross-validation objectives.

Counterpart of :mod:`muygpys_tpu.ops.loss`: cross-entropy, mse, lool and
its unscaled form, pseudo-Huber and looph, as sums of per-point terms that
``torch.autograd`` differentiates; lool also takes full ``(b, r, r)``
covariance blocks (the shear family).  Every loss takes optional
``row_weights (batch,)`` multiplying each batch row's contribution (the
normalized mse divides by the weight total), as in the JAX package: 0/1
weights make padded rows absent.  Sums and counts run over the whole
batch: inside a sharded objective (:func:`muygpys_torch.parallel.comm.reducing`)
each is all-reduced over the ranks, as XLA's sum over a sharded axis is.
"""

from __future__ import annotations

import torch

from muygpys_torch.ops import solve as _solve
from muygpys_torch.parallel import comm


def _weights_like(predictions, row_weights):
    """Per-row weights broadcastable against ``predictions`` (or None)."""
    if row_weights is None:
        return None
    w = torch.as_tensor(
        row_weights, dtype=predictions.dtype, device=predictions.device
    )
    return w.reshape(w.shape[0], *([1] * (predictions.ndim - 1)))


def _weighted_sum(terms, row_weights):
    w = _weights_like(terms, row_weights)
    return comm.batch_sum(terms if w is None else terms * w)


def cross_entropy_fn(predictions, targets, eps: float = 1e-15,
                     row_weights=None, **kwargs):
    """Unnormalized log loss of softmaxed predictions vs one-hot targets,
    with probabilities clipped to ``[eps, 1 - eps]`` and renormalized (as
    sklearn's ``log_loss(..., normalize=False)``)."""
    one_hot = torch.where(targets > 0.0, 1.0, 0.0).to(predictions.dtype)
    probs = torch.softmax(predictions, dim=1)
    probs = torch.clamp(probs, eps, 1.0 - eps)
    probs = probs / torch.sum(probs, dim=1, keepdim=True)
    return -_weighted_sum(one_hot * torch.log(probs), row_weights)


def mse_fn_unnormalized(predictions, targets, row_weights=None, **kwargs):
    return _weighted_sum((predictions - targets) ** 2, row_weights)


def mse_fn(predictions, targets, row_weights=None, **kwargs):
    num = mse_fn_unnormalized(predictions, targets, row_weights=row_weights)
    if row_weights is None:
        return num / comm.batch_total(predictions.numel(), predictions)
    per_row = predictions.numel() // predictions.shape[0]
    return num / (
        comm.batch_sum(torch.as_tensor(
            row_weights, dtype=predictions.dtype, device=predictions.device
        )) * per_row
    )


def _floor_variances(variances):
    """Floor at a dtype-scaled epsilon: in f32, near-singular neighborhoods
    round the posterior variance slightly negative, and log() of it NaNs the
    whole objective."""
    return torch.clamp_min(variances, 10.0 * torch.finfo(variances.dtype).eps)


def _columns(variances, predictions):
    # guard against (b, r) / (b,) silently broadcasting to (b, b)
    if variances.ndim == 1 and predictions.ndim == 2:
        return variances[:, None]
    return variances


def lool_fn_unscaled(predictions, targets, variances, row_weights=None,
                     **kwargs):
    """Leave-one-out likelihood (Eq. 10 of arXiv:2209.11280); with full
    covariance blocks ``variances (b, r, r)`` its multivariate form,
    ``res^T C^{-1} res + log det C`` per point."""
    if variances.ndim in (1, predictions.ndim):
        variances = _columns(_floor_variances(variances), predictions)
        return _weighted_sum(
            (predictions - targets) ** 2 / variances + torch.log(variances),
            row_weights,
        )
    residual = predictions - targets
    if residual.ndim == 1:
        residual = residual[:, None]
    sol, logdet = _solve.solve_and_logdet(variances, residual[..., None])
    quad = (residual[..., None, :] @ sol)[..., 0, 0]
    return _weighted_sum(quad + logdet, row_weights)


def lool_fn(predictions, targets, variances, scale, row_weights=None,
            **kwargs):
    return lool_fn_unscaled(
        predictions, targets, scale * variances, row_weights=row_weights
    )


def pseudo_huber_fn(predictions, targets, boundary_scale: float = 1.5,
                    row_weights=None, **kwargs):
    bs2 = boundary_scale**2
    return bs2 * _weighted_sum(
        torch.sqrt(1.0 + ((targets - predictions) / boundary_scale) ** 2)
        - 1.0,
        row_weights,
    )


def looph_fn_unscaled(predictions, targets, variances,
                      boundary_scale: float = 3.0, row_weights=None,
                      **kwargs):
    """Leave-one-out pseudo-Huber (Eq. 8 of arXiv:2409.11577)."""
    variances = _floor_variances(_columns(variances, predictions))
    bs2 = boundary_scale**2
    return _weighted_sum(
        2.0 * bs2 * (
            torch.sqrt(1.0 + (targets - predictions) ** 2 / (bs2 * variances))
            - 1.0
        )
        + torch.log(variances),
        row_weights,
    )


def looph_fn(predictions, targets, variances, scale,
             boundary_scale: float = 3.0, row_weights=None, **kwargs):
    return looph_fn_unscaled(
        predictions, targets, scale * variances,
        boundary_scale=boundary_scale, row_weights=row_weights,
    )
