"""High-level classification workflows.

Counterpart of :mod:`muygpys_tpu.examples.classify` (``make_classifier``,
``make_multivariate_classifier``, ``do_classify``, ``classify_any``, with
the constant-neighborhood short-circuit that skips the GP solve where every
neighbor agrees).  Labels are one-hot rows; the surrogate regresses them
and the predicted class is the largest mean.  Arrays that are not tensors
go on ``config.device(device)`` (the card unless the caller passes
``device="cpu"``); predictions come back as numpy.
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from muygpys_torch import config
from muygpys_torch.examples.from_indices import (
    placed,
    posterior_mean_from_indices,
)
from muygpys_torch.gp import MultivariateMuyGPS, MuyGPS
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.optimize import (
    Bayes_optimize,
    LossFn,
    OptimizeFn,
    cross_entropy_fn,
    get_balanced_batch,
)


def make_classifier(
    train_features,
    train_labels,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn: LossFn = cross_entropy_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    k_kwargs: Dict = None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
) -> Tuple[MuyGPS, NN_Wrapper]:
    """Build a KNN index and a (optionally optimized) surrogate classifier
    on a class-balanced batch; ``rng`` seeds the batch sampling."""
    dev = config.device(device)
    train_features = np.asarray(train_features)
    train_labels = np.asarray(train_labels)
    time_start = perf_counter()

    nbrs_lookup = NN_Wrapper(train_features, nn_count, device=dev,
                             **(nn_kwargs or {}))
    time_nn = perf_counter()

    muygps = MuyGPS(**(k_kwargs or {}))
    if not muygps.fixed():
        labels = np.argmax(train_labels, axis=1)
        batch_indices, batch_nn_indices = get_balanced_batch(
            nbrs_lookup, labels, batch_count, rng=rng
        )
        crosswise, pairwise, batch_targets, batch_nn_targets = (
            muygps.make_train_tensors(
                batch_indices, batch_nn_indices, placed(train_features, dev),
                placed(train_labels, dev),
            )
        )
        muygps = opt_fn(
            muygps,
            batch_targets,
            batch_nn_targets,
            crosswise,
            pairwise,
            loss_fn=loss_fn,
            verbose=verbose,
            **(opt_kwargs or {}),
        )
    time_opt = perf_counter()
    if verbose:
        print(f"nn build time: {time_nn - time_start}s")
        print(f"opt time: {time_opt - time_nn}s")
    return muygps, nbrs_lookup


def make_multivariate_classifier(
    train_features,
    train_labels,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn: LossFn = cross_entropy_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    k_args: Union[List[Dict], Tuple[Dict, ...]] = None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
) -> Tuple[MultivariateMuyGPS, NN_Wrapper]:
    """One optimized surrogate per class column."""
    dev = config.device(device)
    train_features = np.asarray(train_features)
    train_labels = np.asarray(train_labels)
    _, class_count = train_labels.shape
    k_args = list(k_args or [])
    if len(k_args) != class_count:
        raise ValueError(
            f"supplied {len(k_args)} kernel configs for {class_count} classes"
        )

    nbrs_lookup = NN_Wrapper(train_features, nn_count, device=dev,
                             **(nn_kwargs or {}))
    mmuygps = MultivariateMuyGPS(*k_args)

    labels = np.argmax(train_labels, axis=1)
    batch_indices, batch_nn_indices = get_balanced_batch(
        nbrs_lookup, labels, batch_count, rng=rng
    )
    crosswise, pairwise, batch_targets, batch_nn_targets = (
        mmuygps.make_train_tensors(
            batch_indices, batch_nn_indices, placed(train_features, dev),
            placed(train_labels, dev),
        )
    )
    for i, model in enumerate(mmuygps.models):
        if not model.fixed():
            mmuygps.models[i] = opt_fn(
                model,
                batch_targets[:, i:i + 1],
                batch_nn_targets[:, :, i:i + 1],
                crosswise,
                pairwise,
                loss_fn=loss_fn,
                verbose=verbose,
                **(opt_kwargs or {}),
            )
    return mmuygps, nbrs_lookup


def _decide_and_make_classifier(
    train_features,
    train_labels,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn: LossFn = cross_entropy_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    k_kwargs=None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
):
    if isinstance(k_kwargs, (list, tuple)):
        return make_multivariate_classifier(
            train_features, train_labels, nn_count=nn_count,
            batch_count=batch_count, loss_fn=loss_fn, opt_fn=opt_fn,
            k_args=k_kwargs, nn_kwargs=nn_kwargs, opt_kwargs=opt_kwargs,
            rng=rng, verbose=verbose, device=device,
        )
    return make_classifier(
        train_features, train_labels, nn_count=nn_count,
        batch_count=batch_count, loss_fn=loss_fn, opt_fn=opt_fn,
        k_kwargs=k_kwargs, nn_kwargs=nn_kwargs, opt_kwargs=opt_kwargs,
        rng=rng, verbose=verbose, device=device,
    )


def do_classify(
    test_features,
    train_features,
    train_labels,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn: LossFn = cross_entropy_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    k_kwargs=None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
) -> Tuple[Union[MuyGPS, MultivariateMuyGPS], NN_Wrapper, np.ndarray]:
    """Train, then predict every test point's surrogate class scores."""
    classifier, nbrs_lookup = _decide_and_make_classifier(
        train_features, train_labels, nn_count=nn_count,
        batch_count=batch_count, loss_fn=loss_fn, opt_fn=opt_fn,
        k_kwargs=k_kwargs, nn_kwargs=nn_kwargs, opt_kwargs=opt_kwargs,
        rng=rng, verbose=verbose, device=device,
    )
    surrogate_predictions, pred_timing = classify_any(
        classifier, test_features, train_features, nbrs_lookup, train_labels,
        device=device,
    )
    if verbose:
        print("prediction time breakdown:")
        for key, val in pred_timing.items():
            print(f"\t{key} time:{val}s")
    return classifier, nbrs_lookup, surrogate_predictions


def classify_any(
    surrogate: Union[MuyGPS, MultivariateMuyGPS],
    test_features,
    train_features,
    train_nbrs_lookup: NN_Wrapper,
    train_labels,
    device=None,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Surrogate-regression class scores with the constant-neighborhood
    short-circuit: unanimous neighborhoods take their neighbors' label and
    skip the GP solve."""
    test_features = np.asarray(test_features)
    train_labels = np.asarray(train_labels)
    _, class_count = train_labels.shape
    one_hot_false = float(np.min(train_labels[0, :]))

    time_start = perf_counter()
    test_nn_indices, _ = train_nbrs_lookup.get_nns(test_features)
    time_nn = perf_counter()

    nn_labels = train_labels[test_nn_indices, :]
    predictions = np.full((nn_labels.shape[0], class_count), one_hot_false)
    nonconstant_mask = np.max(nn_labels[:, :, 0], axis=-1) != np.min(
        nn_labels[:, :, 0], axis=-1
    )
    predictions[~nonconstant_mask, :] = nn_labels[~nonconstant_mask, 0, :]
    time_agree = perf_counter()

    if np.sum(nonconstant_mask) > 0:
        predictions[nonconstant_mask] = posterior_mean_from_indices(
            surrogate,
            np.where(nonconstant_mask)[0],
            test_nn_indices[nonconstant_mask, :],
            test_features,
            train_features,
            train_labels,
            device=device,
        ).detach().cpu().numpy()
    time_pred = perf_counter()

    timing = {
        "nn": time_nn - time_start,
        "agree": time_agree - time_nn,
        "pred": time_pred - time_agree,
    }
    return predictions, timing
