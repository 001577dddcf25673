"""Fast posterior mean workflows: the offline precompute and the serve step.

Counterpart of :mod:`muygpys_tpu.examples.fast_posterior_mean`
(``make_fast_regressor``, ``make_fast_multivariate_regressor``, the
workflows ``fast_posterior_mean_any`` and ``do_fast_posterior_mean``) and
of its serve step (the query's nearest training point, then
:func:`muygpys_tpu.examples.from_indices.fast_posterior_mean_from_indices`).
``fast_nn_update`` is applied once, as in the JAX package.  The pairwise
and crosswise tensors come from the deformation (an isotropy's distances
through the Gram identity, never the ``(train, nn, nn, feat)``
differences).  Features and targets that are not tensors go on
``config.device(device)``, the card unless the caller passes
``device="cpu"``; tensors stay where they are.
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, Tuple, Union

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.examples.from_indices import (
    fast_posterior_mean_from_indices,
)
from muygpys_torch.gp import MultivariateMuyGPS, MuyGPS
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.ops.tensors import fast_nn_update


def _placed(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a
    return torch.as_tensor(np.asarray(a), device=config.device(device))


def _fast_pairwise(deformation, nbrs_lookup, train_features, train_targets,
                   device):
    """(pairwise tensor, self-inclusive nn_indices, their targets) over
    every training point's neighbourhood."""
    train_features = _placed(train_features, device)
    train_targets = _placed(train_targets, device)
    nn_indices, _ = nbrs_lookup.get_batch_nns(
        np.arange(train_features.shape[0])
    )
    nn_indices = fast_nn_update(
        torch.as_tensor(nn_indices, device=train_features.device)
    )
    pairwise = deformation.pairwise_tensor(train_features, nn_indices)
    return pairwise, nn_indices, train_targets[nn_indices]


def make_fast_regressor(
    muygps: MuyGPS,
    nbrs_lookup: NN_Wrapper,
    train_features,
    train_targets,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute ``C = (Kin + eps)^{-1} Y`` over self-inclusive
    neighborhoods; returns (coefficients, self-inclusive nn_indices), both
    on the features' device.  A neighbourhood whose factorization fails
    gets NaN coefficients."""
    pairwise, nn_indices, nn_targets = _fast_pairwise(
        muygps.kernel.deformation, nbrs_lookup, train_features,
        train_targets, device,
    )
    coeffs = muygps.fast_coefficients(muygps.kernel(pairwise), nn_targets)
    return coeffs, nn_indices


def make_fast_multivariate_regressor(
    mmuygps: MultivariateMuyGPS,
    nbrs_lookup: NN_Wrapper,
    train_features,
    train_targets,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(train, nn, response)`` coefficients and the self-inclusive
    nn_indices; every response's model shares the first one's
    deformation."""
    pairwise, nn_indices, nn_targets = _fast_pairwise(
        mmuygps.models[0].kernel.deformation, nbrs_lookup, train_features,
        train_targets, device,
    )
    return mmuygps.fast_coefficients(pairwise, nn_targets), nn_indices


def fast_posterior_mean_serve(
    muygps: Union[MuyGPS, MultivariateMuyGPS],
    nbrs_lookup: NN_Wrapper,
    test_features,
    train_features,
    nn_indices: torch.Tensor,
    coeffs: torch.Tensor,
) -> Tuple[torch.Tensor, np.ndarray]:
    """One request against the precomputed state: each query's nearest
    training point, that point's self-inclusive set, the crosswise tensor,
    one kernel evaluation and one contraction against the point's
    coefficients, in the coefficients' dtype on their device.  Returns
    (the means, the nearest training points)."""
    dev, dtype = coeffs.device, coeffs.dtype
    train_features = torch.as_tensor(train_features, dtype=dtype, device=dev)
    host = (test_features.cpu().numpy() if torch.is_tensor(test_features)
            else np.asarray(test_features))
    test = torch.as_tensor(host, dtype=dtype, device=dev)
    closest = nbrs_lookup.get_nns(host)[0][:, 0]
    near = torch.as_tensor(closest, device=dev)
    model = (muygps.models[0] if isinstance(muygps, MultivariateMuyGPS)
             else muygps)
    crosswise = model.kernel.deformation.crosswise_tensor(
        test, train_features, torch.arange(test.shape[0], device=dev),
        nn_indices[near],
    )
    if isinstance(muygps, MultivariateMuyGPS):
        return muygps.fast_posterior_mean(crosswise, coeffs[near]), closest
    return (
        muygps.fast_posterior_mean(muygps.kernel(crosswise), coeffs[near]),
        closest,
    )


def _decide_and_make_fast_regressor(
    muygps, nbrs_lookup, train_features, train_targets, device=None
):
    if isinstance(muygps, MultivariateMuyGPS):
        return make_fast_multivariate_regressor(
            muygps, nbrs_lookup, train_features, train_targets, device=device
        )
    return make_fast_regressor(
        muygps, nbrs_lookup, train_features, train_targets, device=device
    )


def _finished(t: torch.Tensor) -> torch.Tensor:
    """``t`` once the device has computed it (the timing keys are wall
    seconds of finished work)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t


def fast_posterior_mean_any(
    muygps: Union[MuyGPS, MultivariateMuyGPS],
    test_features,
    train_features,
    nbrs_lookup: NN_Wrapper,
    train_targets,
    device=None,
) -> Tuple[np.ndarray, torch.Tensor, Dict[str, float]]:
    """Offline precompute, then serve every test point: one KNN query, one
    kernel evaluation and one contraction.  Returns (the means as numpy,
    the coefficients on their device, the seconds of ``precompute``,
    ``agree`` (0.0, as in JAX), ``nn`` and ``pred``)."""
    test_features = np.asarray(test_features)
    time_start = perf_counter()
    coeffs, nn_indices = _decide_and_make_fast_regressor(
        muygps, nbrs_lookup, train_features, train_targets, device=device
    )
    _finished(coeffs)
    time_precomp = perf_counter()

    test_neighbors, _ = nbrs_lookup.get_nns(test_features)
    time_nn = perf_counter()

    closest_neighbor = np.asarray(test_neighbors)[:, 0]
    closest_set = nn_indices[
        torch.as_tensor(closest_neighbor, device=nn_indices.device)
    ].cpu().numpy()
    test_count = test_features.shape[0]
    posterior_mean = fast_posterior_mean_from_indices(
        muygps,
        np.arange(test_count),
        closest_set,
        test_features,
        _placed(train_features, coeffs.device),
        closest_neighbor,
        coeffs,
    )
    posterior_mean = posterior_mean.cpu().numpy()
    time_pred = perf_counter()

    timing = {
        "precompute": time_precomp - time_start,
        "agree": 0.0,
        "nn": time_nn - time_precomp,
        "pred": time_pred - time_nn,
    }
    return posterior_mean, coeffs, timing


def do_fast_posterior_mean(
    test_features,
    train_features,
    train_targets,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn=None,
    opt_fn=None,
    k_kwargs=None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    verbose: bool = False,
    device=None,
) -> Tuple[
    Union[MuyGPS, MultivariateMuyGPS],
    NN_Wrapper,
    np.ndarray,
    torch.Tensor,
    Dict[str, float],
]:
    """The whole fast-prediction workflow: train a model
    (``Bayes_optimize`` and ``lool_fn`` unless given), precompute its
    coefficients and serve the fast posterior mean of every test point."""
    from muygpys_torch.examples.regress import _decide_and_make_regressor
    from muygpys_torch.optimize import Bayes_optimize, lool_fn

    loss_fn = loss_fn if loss_fn is not None else lool_fn
    opt_fn = opt_fn if opt_fn is not None else Bayes_optimize

    muygps, nbrs_lookup = _decide_and_make_regressor(
        train_features, train_targets, nn_count=nn_count,
        batch_count=batch_count, loss_fn=loss_fn, opt_fn=opt_fn,
        k_kwargs=k_kwargs, nn_kwargs=nn_kwargs, opt_kwargs=opt_kwargs,
        verbose=verbose, device=device,
    )
    posterior_mean, coeffs, timing = fast_posterior_mean_any(
        muygps, test_features, train_features, nbrs_lookup, train_targets,
        device=device,
    )
    if verbose:
        print("fast posterior mean timing:")
        for k, v in timing.items():
            print(f"\t{k} time:{v}s")
    return muygps, nbrs_lookup, posterior_mean, coeffs, timing
