"""Epoch-based mini-batch optimization loop (experimental).

Counterpart of :mod:`muygpys_tpu.optimize.experimental.chassis`
(``optimize_from_tensors_mini_batch``): a fresh batch every epoch, the
Bayesian optimizer's state optionally kept across epochs and the previous
epochs' maxima optionally probed again, and, under an anisotropic
deformation, the neighbor index rebuilt on features rescaled by the learned
length scales.
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gp.deformation import Anisotropy
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.optimize.batch import sample_batch
from muygpys_torch.optimize.bayes import BayesianOptimization
from muygpys_torch.optimize.chassis import (
    Bayes_optimize,
    _get_opt_lists,
    _new_muygps,
    scalar_objective,
)
from muygpys_torch.optimize.loss import LossFn, lool_fn


def _rescaled_index(muygps, params, train_features, nn_count, nn_kwargs,
                    device):
    """The neighbor index over the features divided by the anisotropic
    length scales in ``params`` (stored values where a name is absent)."""
    ls = muygps.kernel.deformation.length_scale
    values = ls.set_defaults(**params)
    scales = np.array([float(values[p.name()]) for p in ls._params])
    return NN_Wrapper(train_features / scales, nn_count, device=device,
                      **(nn_kwargs or {}))


def optimize_from_tensors_mini_batch(
    muygps,
    train_features,
    train_responses,
    nn_count: int,
    batch_count: int,
    train_count: int,
    num_epochs: int = 1,
    keep_state: bool = False,
    probe_previous: bool = False,
    batch_features=None,
    loss_fn: LossFn = lool_fn,
    obj_method: str = "loo_crossval",
    loss_kwargs: Optional[Dict] = None,
    verbose: bool = False,
    nn_kwargs: Optional[Dict] = None,
    rng: Optional[np.random.Generator] = None,
    engine: str = "bayes",
    device=None,
    **kwargs,
) -> Tuple[object, NN_Wrapper, float, int, int]:
    """Optimize hyperparameters over fresh mini-batches each epoch.

    ``engine="bayes"``: one Bayesian-optimizer maximize an epoch
    (``init_points`` + ``n_iter`` probes, 5 + 20 by default; ``random_state``
    seeds it); ``keep_state=True`` keeps the optimizer, and its probes,
    across epochs; ``probe_previous=True`` probes every earlier epoch's
    maximum again.  ``engine="device-lbfgs"``: one whole L-BFGS trajectory
    an epoch through :func:`~muygpys_torch.optimize.make_device_trainer`
    (lool, mse or looph): every epoch's batch has the first one's shape, so
    on a card every epoch after the first replays the same captured graph;
    ``keep_state=True`` starts each epoch from the previous optimum.

    ``batch_features``: any value other than ``None`` trains a hierarchical
    (nonstationary) length scale; each epoch's features are
    ``train_features[batch_indices]``, derived here (the batch changes every
    epoch, so a caller's array could not stay aligned).

    Features that are not a tensor go on ``device`` (default ``"cuda"``) in
    ``config.ftype()``, as ``jnp.asarray`` gives the JAX package's float
    type; a tensor stays where it is, and the neighbor index and the
    optimization run there.  Responses follow the features.

    Returns (optimized model, final nbrs_lookup, seconds, probe count,
    total optimization steps).
    """
    if obj_method != "loo_crossval":
        raise ValueError(f"unsupported objective method {obj_method}")
    if engine not in ("bayes", "device-lbfgs"):
        raise ValueError(f"unknown engine {engine!r} (bayes, device-lbfgs)")
    rng = rng if rng is not None else np.random.default_rng()
    if torch.is_tensor(train_features):
        dev = train_features.device
        features_np = train_features.cpu().numpy()
    else:
        dev = config.device(device)
        features_np = np.asarray(train_features)
        train_features = torch.as_tensor(features_np, dtype=config.ftype(),
                                         device=dev)
    if not torch.is_tensor(train_responses):
        train_responses = torch.as_tensor(
            np.asarray(train_responses), dtype=train_features.dtype
        )
    train_responses = train_responses.to(dev)

    x0_names, x0, bounds = _get_opt_lists(muygps, verbose=verbose)
    bounds_map = {n: tuple(bounds[i]) for i, n in enumerate(x0_names)}
    x0_map = {n: float(x0[i]) for i, n in enumerate(x0_names)}
    maximize_kwargs = {
        k: kwargs[k] for k in kwargs if k in {"init_points", "n_iter"}
    }
    maximize_kwargs.setdefault("init_points", 5)
    maximize_kwargs.setdefault("n_iter", 20)
    optimizer_kwargs = {k: kwargs[k] for k in kwargs if k in {"random_state"}}

    nbrs_lookup = NN_Wrapper(features_np, nn_count, device=dev,
                             **(nn_kwargs or {}))
    anisotropic = isinstance(muygps.kernel.deformation, Anisotropy)
    to_probe = [x0_map]
    optimizer = None
    total_pts_probed = 0
    total_opt_steps = 0
    time_start = perf_counter()

    trainer = None
    trainer_z = None
    best_params = x0_map
    if engine == "device-lbfgs":
        from muygpys_torch.optimize.device_chassis import make_device_trainer

        loss_name = loss_fn.name.removesuffix("_fn")
        if loss_name not in ("lool", "mse", "looph"):
            raise ValueError(
                f"engine='device-lbfgs' supports lool/mse/looph, not "
                f"{loss_name}; use engine='bayes'"
            )
        trainer = make_device_trainer(
            muygps, loss=loss_name, verbose=verbose, device=dev
        )

    batch_indices = None
    for epoch in range(num_epochs):
        batch_indices, batch_nn_indices = sample_batch(
            nbrs_lookup, batch_count, train_count, rng=rng
        )
        crosswise, pairwise, batch_targets, nn_targets = (
            muygps.make_train_tensors(
                batch_indices, batch_nn_indices, train_features,
                train_responses,
            )
        )
        epoch_bf = (
            None if batch_features is None
            else train_features[torch.as_tensor(batch_indices, device=dev)]
        )
        if engine == "device-lbfgs":
            trained, info = trainer(
                batch_targets, nn_targets, crosswise, pairwise,
                z_init=trainer_z if keep_state else None,
                batch_features=epoch_bf,
            )
            if keep_state:
                trainer_z = info["z"]
            total_opt_steps += info["iterations"]
            # the trained clone keeps its parameters free: read the optimum
            names2, vals2, _ = trained.get_opt_params()
            best_params = {n: float(v) for n, v in zip(names2, vals2)}
            epoch_max = best_params
        else:
            obj_fn = Bayes_optimize.make_obj_fn(
                muygps, batch_targets, nn_targets, crosswise, pairwise,
                batch_features=epoch_bf, loss_fn=loss_fn,
                loss_kwargs=loss_kwargs or dict(),
            )
            if keep_state and optimizer is not None:
                optimizer._f = scalar_objective(obj_fn)
            else:
                optimizer = BayesianOptimization(
                    f=scalar_objective(obj_fn),
                    pbounds=bounds_map,
                    verbose=1 if verbose else 0,
                    **optimizer_kwargs,
                )
            if probe_previous:
                for point in to_probe:
                    optimizer.probe(point, lazy=True)
                    total_pts_probed += 1
            elif epoch == 0:
                optimizer.probe(to_probe[0], lazy=True)
                total_pts_probed += 1
            optimizer.maximize(**maximize_kwargs)
            total_opt_steps += (
                maximize_kwargs["init_points"] + maximize_kwargs["n_iter"]
            )
            epoch_max = optimizer.max["params"]
            to_probe.append(epoch_max)
        if verbose:
            print(f"{epoch}, {epoch_max}")
        # rebuild neighborhoods under the learned anisotropic scaling
        if anisotropic and epoch < num_epochs - 1:
            nbrs_lookup = _rescaled_index(
                muygps, epoch_max, features_np, nn_count, nn_kwargs, dev
            )
    time_stop = perf_counter()

    final_params = (
        best_params if engine == "device-lbfgs" else optimizer.max["params"]
    )
    new_muygps = _new_muygps(muygps, x0_names, bounds, final_params)
    scale_kwargs = {}
    if batch_features is not None:
        scale_kwargs["batch_features"] = epoch_bf
    new_muygps = new_muygps.optimize_scale(pairwise, nn_targets,
                                           **scale_kwargs)
    return (
        new_muygps,
        nbrs_lookup,
        time_stop - time_start,
        total_pts_probed,
        total_opt_steps,
    )
