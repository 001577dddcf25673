"""Index-based convenience glue.

Counterpart of :mod:`muygpys_tpu.examples.from_indices`
(``tensors_from_indices``, ``posterior_mean_from_indices``,
``posterior_variance_from_indices``, ``regress_from_indices``,
``fast_posterior_mean_from_indices``, ``optimize_from_indices``).

Arrays that are not tensors go on ``config.device(device)`` (the card unless
the caller passes ``device="cpu"``), floating ones in ``config.ftype()``, as
``jnp.asarray`` gives the JAX package's float type; tensors stay where they
are, and index arrays follow the training features.  Results are tensors on
that device.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gp import MultivariateMuyGPS, MuyGPS
from muygpys_torch.optimize import LossFn, OptimizeFn, lool_fn


def placed(a, device=None) -> torch.Tensor:
    """``a`` as a tensor: a tensor as it is; an array on
    ``config.device(device)``, a floating one in ``config.ftype()``."""
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    dtype = config.ftype() if np.issubdtype(a.dtype, np.floating) else None
    return torch.as_tensor(a, dtype=dtype, device=config.device(device))


def _indices(indices, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(indices), device=like.device)


def tensors_from_indices(
    muygps: Union[MuyGPS, MultivariateMuyGPS],
    indices,
    nn_indices,
    test_features,
    train_features,
    train_targets,
    device=None,
):
    train_features = placed(train_features, device)
    return muygps.make_predict_tensors(
        _indices(indices, train_features),
        _indices(nn_indices, train_features),
        placed(test_features, train_features.device),
        train_features,
        placed(train_targets, train_features.device),
    )


def _kernels(muygps, crosswise, pairwise):
    return muygps.kernel(pairwise), muygps.kernel(crosswise)


def posterior_mean_from_indices(
    muygps: Union[MuyGPS, MultivariateMuyGPS],
    indices,
    nn_indices,
    test_features,
    train_features,
    train_targets,
    device=None,
):
    crosswise, pairwise, nn_targets = tensors_from_indices(
        muygps, indices, nn_indices, test_features, train_features,
        train_targets, device,
    )
    if isinstance(muygps, MultivariateMuyGPS):
        return muygps.posterior_mean(pairwise, crosswise, nn_targets)
    Kin, Kcross = _kernels(muygps, crosswise, pairwise)
    return muygps.posterior_mean(Kin, Kcross, nn_targets)


def posterior_variance_from_indices(
    muygps: Union[MuyGPS, MultivariateMuyGPS],
    indices,
    nn_indices,
    test_features,
    train_features,
    train_targets,
    device=None,
):
    crosswise, pairwise, _ = tensors_from_indices(
        muygps, indices, nn_indices, test_features, train_features,
        train_targets, device,
    )
    if isinstance(muygps, MultivariateMuyGPS):
        return muygps.posterior_variance(pairwise, crosswise)
    Kin, Kcross = _kernels(muygps, crosswise, pairwise)
    return muygps.posterior_variance(Kin, Kcross)


def regress_from_indices(
    muygps: Union[MuyGPS, MultivariateMuyGPS],
    indices,
    nn_indices,
    test_features,
    train_features,
    train_targets,
    device=None,
):
    """(mean, variance) for the indicated test points: the library solves
    of :mod:`muygpys_torch.ops.solve`, as JAX computes them outside
    Pallas."""
    crosswise, pairwise, nn_targets = tensors_from_indices(
        muygps, indices, nn_indices, test_features, train_features,
        train_targets, device,
    )
    if isinstance(muygps, MultivariateMuyGPS):
        return (
            muygps.posterior_mean(pairwise, crosswise, nn_targets),
            muygps.posterior_variance(pairwise, crosswise),
        )
    Kin, Kcross = _kernels(muygps, crosswise, pairwise)
    return (
        muygps.posterior_mean(Kin, Kcross, nn_targets),
        muygps.posterior_variance(Kin, Kcross),
    )


def fast_posterior_mean_from_indices(
    muygps: Union[MuyGPS, MultivariateMuyGPS],
    indices,
    nn_indices,
    test_features,
    train_features,
    closest_index,
    coeffs_tensor,
    device=None,
):
    """Serve-time fast mean against precomputed coefficients."""
    train_features = placed(train_features, device)
    model = (muygps.models[0] if isinstance(muygps, MultivariateMuyGPS)
             else muygps)
    crosswise = model.kernel.deformation.crosswise_tensor(
        placed(test_features, train_features.device),
        train_features,
        _indices(indices, train_features),
        _indices(nn_indices, train_features),
    )
    coeffs = coeffs_tensor[_indices(closest_index, coeffs_tensor)]
    if isinstance(muygps, MultivariateMuyGPS):
        return muygps.fast_posterior_mean(crosswise, coeffs)
    return muygps.fast_posterior_mean(muygps.kernel(crosswise), coeffs)


def optimize_from_indices(
    muygps: MuyGPS,
    batch_indices,
    batch_nn_indices,
    train_features,
    train_targets,
    loss_fn: LossFn = lool_fn,
    opt_fn: OptimizeFn = None,
    verbose: bool = False,
    device=None,
    **kwargs,
) -> MuyGPS:
    """Assemble the training tensors from indices and run the chassis
    (``Bayes_optimize`` by default)."""
    from muygpys_torch.optimize import Bayes_optimize

    if opt_fn is None:
        opt_fn = Bayes_optimize
    train_features = placed(train_features, device)
    crosswise, pairwise, batch_targets, batch_nn_targets = (
        muygps.make_train_tensors(
            np.asarray(batch_indices),
            np.asarray(batch_nn_indices),
            train_features,
            placed(train_targets, train_features.device),
        )
    )
    return opt_fn(
        muygps,
        batch_targets,
        batch_nn_targets,
        crosswise,
        pairwise,
        loss_fn=loss_fn,
        verbose=verbose,
        **kwargs,
    )
