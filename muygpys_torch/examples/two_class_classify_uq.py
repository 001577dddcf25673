"""Two-class classification with uncertainty quantification.

Counterpart of :mod:`muygpys_tpu.examples.two_class_classify_uq`
(``example_lambdas``, ``do_classify_uq``, ``classify_two_class_uq``,
``make_masks``, ``do_uq``, ``train_two_class_interval``: a grid search over
1999 cutoff values on the posterior confidence intervals' coverage of a
calibration batch), the UQ workflow of [muyskens2021star].  The surrogate
runs on ``config.device(device)`` (the card unless the caller passes
``device="cpu"``); cutoffs, masks and scores are numpy.
"""

from __future__ import annotations

from time import perf_counter
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from muygpys_torch.examples.classify import make_classifier
from muygpys_torch.examples.from_indices import regress_from_indices
from muygpys_torch.gp import MultivariateMuyGPS, MuyGPS
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.optimize import (
    Bayes_optimize,
    LossFn,
    OptimizeFn,
    cross_entropy_fn,
    get_balanced_batch,
)

example_lambdas = [
    lambda alpha, beta, correct_count, incorrect_count: np.argmin(
        alpha + beta
    ),
    lambda alpha, beta, correct_count, incorrect_count: np.argmin(
        2 * alpha + beta
    ),
    lambda alpha, beta, correct_count, incorrect_count: np.argmin(
        4 * alpha + beta
    ),
    lambda alpha, beta, correct_count, incorrect_count: np.argmin(
        10 * alpha + beta
    ),
    lambda alpha, beta, correct_count, incorrect_count: np.argmin(
        incorrect_count * alpha + correct_count * beta
    ),
]
"""Example cutoff-selection objectives trading type-1/type-2 error."""


def do_classify_uq(
    test_features,
    train_features,
    train_labels,
    nn_count: int = 30,
    opt_batch_count: int = 200,
    uq_batch_count: int = 500,
    loss_fn: LossFn = cross_entropy_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    uq_objectives: Union[List[Callable], Tuple[Callable, ...]] = (
        example_lambdas
    ),
    k_kwargs: Dict = None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
) -> Tuple[MuyGPS, NN_Wrapper, np.ndarray, np.ndarray]:
    """Two-class surrogate classification with tuned CI cutoffs.

    ``rng`` seeds BOTH the optimization batch and the UQ calibration batch,
    making the workflow reproducible regardless of global RNG state."""
    train_labels = np.asarray(train_labels)
    muygps, nbrs_lookup = make_classifier(
        train_features, train_labels, nn_count=nn_count,
        batch_count=opt_batch_count, loss_fn=loss_fn, opt_fn=opt_fn,
        k_kwargs=k_kwargs, nn_kwargs=nn_kwargs, opt_kwargs=opt_kwargs,
        rng=rng, verbose=verbose, device=device,
    )

    surrogate_predictions, variances, pred_timing = classify_two_class_uq(
        muygps, test_features, train_features, nbrs_lookup, train_labels,
        device=device,
    )

    min_label = np.min(train_labels[0, :])
    max_label = np.max(train_labels[0, :])
    mid_value = (min_label + max_label) / 2
    time_pred = perf_counter()

    one_hot_labels = 2 * np.argmax(train_labels, axis=1) - 1
    batch_indices, batch_nn_indices = get_balanced_batch(
        nbrs_lookup, one_hot_labels, uq_batch_count, rng=rng
    )
    time_uq_batch = perf_counter()

    cutoffs = train_two_class_interval(
        muygps, batch_indices, batch_nn_indices, train_features,
        train_labels, one_hot_labels, uq_objectives, device=device,
    )
    masks = make_masks(surrogate_predictions, cutoffs, variances, mid_value)
    time_cutoff = perf_counter()

    if verbose:
        print(f"uq batching time: {time_uq_batch - time_pred}")
        print(f"cutoff time: {time_cutoff - time_uq_batch}s")
        print("prediction time breakdown:")
        for k, v in pred_timing.items():
            print(f"\t{k} time:{v}s")
    return muygps, nbrs_lookup, surrogate_predictions, masks


def classify_two_class_uq(
    surrogate: Union[MuyGPS, MultivariateMuyGPS],
    test_features,
    train_features,
    train_nbrs_lookup: NN_Wrapper,
    train_labels,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """Binary surrogate means and variances, with the unanimous-neighborhood
    short-circuit (variance pinned to 0 there)."""
    test_features = np.asarray(test_features)
    train_labels = np.asarray(train_labels)

    time_start = perf_counter()
    test_nn_indices, _ = train_nbrs_lookup.get_nns(test_features)
    time_nn = perf_counter()

    nn_labels = train_labels[test_nn_indices, :]
    means = np.zeros((nn_labels.shape[0], 2))
    variances = np.zeros((nn_labels.shape[0]))
    nonconstant_mask = np.max(nn_labels[:, :, 0], axis=-1) != np.min(
        nn_labels[:, :, 0], axis=-1
    )
    means[~nonconstant_mask] = nn_labels[~nonconstant_mask, 0]
    time_agree = perf_counter()

    if np.sum(nonconstant_mask) > 0:
        mean_nc, var_nc = regress_from_indices(
            surrogate,
            np.where(nonconstant_mask)[0],
            test_nn_indices[nonconstant_mask],
            test_features,
            train_features,
            train_labels,
            device=device,
        )
        means[nonconstant_mask] = mean_nc.detach().cpu().numpy()
        variances[nonconstant_mask] = (
            var_nc.detach().cpu().numpy().reshape(-1)
        )
    time_pred = perf_counter()

    timing = {
        "nn": time_nn - time_start,
        "agree": time_agree - time_nn,
        "pred": time_pred - time_agree,
    }
    return means, variances, timing


def make_masks(
    predictions: np.ndarray,
    cutoffs: np.ndarray,
    variances: np.ndarray,
    mid_value: float,
) -> np.ndarray:
    """Ambiguity masks: True where the CI at each cutoff contains mid_value."""
    batch_count = predictions.shape[0]
    variances = np.asarray(variances).reshape((batch_count,))
    return np.array(
        [
            np.logical_and(
                predictions[:, 1] - cut * variances < mid_value,
                predictions[:, 1] + cut * variances > mid_value,
            )
            for cut in cutoffs
        ]
    )


def do_uq(
    surrogate_predictions: np.ndarray,
    test_labels: np.ndarray,
    masks: np.ndarray,
) -> Tuple[float, np.ndarray]:
    """Accuracy overall plus (ambiguous count, ambiguous acc, unambiguous acc)
    per objective mask."""
    correct = np.argmax(surrogate_predictions, axis=1) == np.argmax(
        np.asarray(test_labels), axis=1
    )
    uq = np.array(
        [
            [
                np.sum(mask),
                np.mean(correct[mask]) if np.sum(mask) else 0.0,
                np.mean(correct[~mask]) if np.sum(~mask) else 0.0,
            ]
            for mask in masks
        ]
    )
    return float(np.mean(correct)), uq


def train_two_class_interval(
    surrogate: MuyGPS,
    batch_indices,
    batch_nn_indices,
    train_features,
    train_responses,
    train_labels,
    objective_fns: Union[List[Callable], Tuple[Callable, ...]],
    device=None,
) -> np.ndarray:
    """Grid-search CI scale cutoffs minimizing each objective over 1999
    candidate values."""
    targets = np.asarray(train_labels)[np.asarray(batch_indices)]

    mean, variance = regress_from_indices(
        surrogate, batch_indices, batch_nn_indices, train_features,
        train_features, train_responses, device=device,
    )
    mean = mean.detach().cpu().numpy()
    variance = variance.detach().cpu().numpy().reshape(-1)
    predicted_labels = 2 * np.argmax(mean, axis=1) - 1

    correct_mask = predicted_labels == targets
    incorrect_mask = ~correct_mask

    cutv = np.linspace(0.01, 20, 1999)
    sd = np.sqrt(variance)

    def ambiguous_rate(mask):
        # fraction of `mask` rows whose CI at each cutoff crosses zero
        if np.sum(mask) == 0:
            return np.zeros_like(cutv)
        lo = mean[mask, 1][None, :] - cutv[:, None] * sd[mask][None, :]
        hi = mean[mask, 1][None, :] + cutv[:, None] * sd[mask][None, :]
        return np.mean(np.logical_and(lo < 0.0, hi > 0.0), axis=1)

    _alpha = 1.0 - ambiguous_rate(incorrect_mask)
    _beta = ambiguous_rate(correct_mask)

    correct_count = int(np.sum(correct_mask))
    incorrect_count = int(np.sum(incorrect_mask))
    return np.array(
        [
            cutv[obj_f(_alpha, _beta, correct_count, incorrect_count)]
            for obj_f in objective_fns
        ]
    )
