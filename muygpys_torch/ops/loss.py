"""Loss functions for leave-one-out cross-validation objectives.

Counterpart of :mod:`muygpys_tpu.ops.loss`: cross-entropy, mse, lool and
its unscaled form, pseudo-Huber and looph, as sums of per-point terms that
``torch.autograd`` differentiates; lool also takes full ``(b, r, r)``
covariance blocks (the shear family).  The per-row weights of the JAX
package (ragged sharding) wait for the sharding slice.
"""

from __future__ import annotations

import torch

from muygpys_torch.ops import solve as _solve


def cross_entropy_fn(predictions, targets, eps: float = 1e-15, **kwargs):
    """Unnormalized log loss of softmaxed predictions vs one-hot targets,
    with probabilities clipped to ``[eps, 1 - eps]`` and renormalized (as
    sklearn's ``log_loss(..., normalize=False)``)."""
    one_hot = torch.where(targets > 0.0, 1.0, 0.0).to(predictions.dtype)
    probs = torch.softmax(predictions, dim=1)
    probs = torch.clamp(probs, eps, 1.0 - eps)
    probs = probs / torch.sum(probs, dim=1, keepdim=True)
    return -torch.sum(one_hot * torch.log(probs))


def mse_fn(predictions, targets, **kwargs):
    return torch.sum((predictions - targets) ** 2) / predictions.numel()


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


def lool_fn_unscaled(predictions, targets, variances, **kwargs):
    """Leave-one-out likelihood (Eq. 10 of arXiv:2209.11280); with full
    covariance blocks ``variances (b, r, r)`` its multivariate form,
    ``res^T C^{-1} res + log det C`` per point."""
    if variances.ndim in (1, predictions.ndim):
        variances = _columns(_floor_variances(variances), predictions)
        return torch.sum(
            (predictions - targets) ** 2 / variances + torch.log(variances)
        )
    residual = predictions - targets
    if residual.ndim == 1:
        residual = residual[:, None]
    sol, logdet = _solve.solve_and_logdet(variances, residual[..., None])
    quad = (residual[..., None, :] @ sol)[..., 0, 0]
    return torch.sum(quad + logdet)


def lool_fn(predictions, targets, variances, scale, **kwargs):
    return lool_fn_unscaled(predictions, targets, scale * variances)


def pseudo_huber_fn(predictions, targets, boundary_scale: float = 1.5,
                    **kwargs):
    bs2 = boundary_scale**2
    return bs2 * torch.sum(
        torch.sqrt(1.0 + ((targets - predictions) / boundary_scale) ** 2)
        - 1.0
    )


def looph_fn_unscaled(predictions, targets, variances,
                      boundary_scale: float = 3.0, **kwargs):
    """Leave-one-out pseudo-Huber (Eq. 8 of arXiv:2409.11577)."""
    variances = _floor_variances(_columns(variances, predictions))
    bs2 = boundary_scale**2
    return torch.sum(
        2.0 * bs2 * (
            torch.sqrt(1.0 + (targets - predictions) ** 2 / (bs2 * variances))
            - 1.0
        )
        + torch.log(variances)
    )


def looph_fn(predictions, targets, variances, scale,
             boundary_scale: float = 3.0, **kwargs):
    return looph_fn_unscaled(
        predictions, targets, scale * variances, boundary_scale=boundary_scale
    )
