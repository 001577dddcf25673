"""High-level regression workflows.

Counterpart of :mod:`muygpys_tpu.examples.regress` (``make_regressor``,
``make_multivariate_regressor``, ``do_regress``, ``regress_any``): the
MuyGPyS train()/predict() API.  The neighbor index is ``NN_Wrapper(train,
nn_count, device=device, **nn_kwargs)``; the model trains through
``opt_fn`` (``Bayes_optimize`` by default) on a sampled batch, and its
scale is fit on the same batch.  Arrays that are not tensors go on
``config.device(device)`` (the card unless the caller passes
``device="cpu"``) in ``config.ftype()``; predictions come back as numpy.
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from muygpys_torch import config
from muygpys_torch.examples.from_indices import placed, regress_from_indices
from muygpys_torch.gp import MultivariateMuyGPS, MuyGPS
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.optimize import (
    Bayes_optimize,
    LossFn,
    OptimizeFn,
    lool_fn,
    sample_batch,
)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def make_regressor(
    train_features,
    train_targets,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn: LossFn = lool_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    k_kwargs: Dict = None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
) -> Tuple[MuyGPS, NN_Wrapper]:
    """Build a KNN index and a (optionally optimized) MuyGPS regressor;
    ``rng`` seeds the batch sampling."""
    dev = config.device(device)
    train_features = np.asarray(train_features)
    train_count = train_features.shape[0]
    time_start = perf_counter()

    nbrs_lookup = NN_Wrapper(train_features, nn_count, device=dev,
                             **(nn_kwargs or {}))
    time_nn = perf_counter()

    muygps = MuyGPS(**(k_kwargs or {}))
    skip_opt = muygps.fixed()
    if not skip_opt or muygps.scale.__class__.__name__ != "FixedScale":
        features_d = placed(train_features, dev)
        targets_d = placed(train_targets, dev)
        batch_indices, batch_nn_indices = sample_batch(
            nbrs_lookup, batch_count, train_count, rng=rng
        )
        crosswise, pairwise, batch_targets, batch_nn_targets = (
            muygps.make_train_tensors(
                batch_indices, batch_nn_indices, features_d, targets_d
            )
        )
        if not skip_opt:
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
            crosswise, pairwise, batch_targets, batch_nn_targets = (
                muygps.make_train_tensors(
                    batch_indices, batch_nn_indices, features_d, targets_d
                )
            )
        muygps.optimize_scale(pairwise, batch_nn_targets)
    time_opt = perf_counter()

    if verbose:
        print(f"nn build time: {time_nn - time_start}s")
        print(f"opt time: {time_opt - time_nn}s")
    return muygps, nbrs_lookup


def make_multivariate_regressor(
    train_features,
    train_targets,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn: LossFn = lool_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    k_args: Union[List[Dict], Tuple[Dict, ...]] = None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
) -> Tuple[MultivariateMuyGPS, NN_Wrapper]:
    """Build a KNN index and one optimized model per response column."""
    dev = config.device(device)
    train_features = np.asarray(train_features)
    train_count, response_count = np.shape(train_targets)
    k_args = list(k_args or [])
    if len(k_args) != response_count:
        raise ValueError(
            f"supplied {len(k_args)} kernel configs for "
            f"{response_count} responses"
        )

    nbrs_lookup = NN_Wrapper(train_features, nn_count, device=dev,
                             **(nn_kwargs or {}))
    mmuygps = MultivariateMuyGPS(*k_args)

    batch_indices, batch_nn_indices = sample_batch(
        nbrs_lookup, batch_count, train_count, rng=rng
    )
    crosswise, pairwise, batch_targets, batch_nn_targets = (
        mmuygps.make_train_tensors(
            batch_indices, batch_nn_indices, placed(train_features, dev),
            placed(train_targets, dev),
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
    mmuygps.optimize_scale(pairwise, batch_nn_targets)
    return mmuygps, nbrs_lookup


def _decide_and_make_regressor(
    train_features,
    train_targets,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn: LossFn = lool_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    k_kwargs=None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
):
    if isinstance(k_kwargs, (list, tuple)):
        return make_multivariate_regressor(
            train_features, train_targets, nn_count=nn_count,
            batch_count=batch_count, loss_fn=loss_fn, opt_fn=opt_fn,
            k_args=k_kwargs, nn_kwargs=nn_kwargs, opt_kwargs=opt_kwargs,
            rng=rng, verbose=verbose, device=device,
        )
    return make_regressor(
        train_features, train_targets, nn_count=nn_count,
        batch_count=batch_count, loss_fn=loss_fn, opt_fn=opt_fn,
        k_kwargs=k_kwargs, nn_kwargs=nn_kwargs, opt_kwargs=opt_kwargs,
        rng=rng, verbose=verbose, device=device,
    )


def do_regress(
    test_features,
    train_features,
    train_targets,
    nn_count: int = 30,
    batch_count: int = 200,
    loss_fn: LossFn = lool_fn,
    opt_fn: OptimizeFn = Bayes_optimize,
    k_kwargs=None,
    nn_kwargs: Dict = None,
    opt_kwargs: Dict = None,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = False,
    device=None,
) -> Tuple[
    Union[MuyGPS, MultivariateMuyGPS], NN_Wrapper, np.ndarray, np.ndarray
]:
    """Train, then predict mean and variance for every test point."""
    regressor, nbrs_lookup = _decide_and_make_regressor(
        train_features, train_targets, nn_count=nn_count,
        batch_count=batch_count, loss_fn=loss_fn, opt_fn=opt_fn,
        k_kwargs=k_kwargs, nn_kwargs=nn_kwargs, opt_kwargs=opt_kwargs,
        rng=rng, verbose=verbose, device=device,
    )
    posterior_mean, posterior_variance, pred_timing = regress_any(
        regressor, test_features, train_features, nbrs_lookup, train_targets,
        device=device,
    )
    if verbose:
        print("prediction time breakdown:")
        for key, val in pred_timing.items():
            print(f"\t{key} time:{val}s")
    return regressor, nbrs_lookup, posterior_mean, posterior_variance


def regress_any(
    regressor: Union[MuyGPS, MultivariateMuyGPS],
    test_features,
    train_features,
    train_nbrs_lookup: NN_Wrapper,
    train_targets,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """Predict mean and variance for every test point; the timing dict has
    the seconds of the neighbor search (``nn``) and of the prediction
    (``pred``, the results on the host included)."""
    test_features = np.asarray(test_features)
    test_count = test_features.shape[0]

    time_start = perf_counter()
    test_nn_indices, _ = train_nbrs_lookup.get_nns(test_features)
    time_nn = perf_counter()

    posterior_mean, posterior_variance = regress_from_indices(
        regressor,
        np.arange(test_count),
        test_nn_indices,
        test_features,
        train_features,
        train_targets,
        device=device,
    )
    posterior_mean = _numpy(posterior_mean)
    posterior_variance = _numpy(posterior_variance)
    time_pred = perf_counter()

    timing = {
        "nn": time_nn - time_start,
        "agree": 0.0,
        "pred": time_pred - time_nn,
    }
    return posterior_mean, posterior_variance, timing
