"""Fast posterior mean workflows: the offline precompute and the serve step.

Counterpart of :mod:`muygpys_tpu.examples.fast_posterior_mean`
(``make_fast_regressor``, ``make_fast_multivariate_regressor``) and of its
serve step (the query's nearest training point, then
:func:`muygpys_tpu.examples.from_indices.fast_posterior_mean_from_indices`).
``fast_nn_update`` is applied once, as in the JAX package.  The pairwise
and crosswise tensors come from the deformation (an isotropy's distances
through the Gram identity, never the ``(train, nn, nn, feat)``
differences).  Features and targets that are not tensors go on
``config.device(device)``, the card unless the caller passes
``device="cpu"``; tensors stay where they are.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from muygpys_torch import config
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
