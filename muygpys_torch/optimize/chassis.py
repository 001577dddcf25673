"""Outer-loop optimization chassis.

Counterpart of :mod:`muygpys_tpu.optimize.chassis`: ``OptimizeFn``,
``Bayes_optimize``, ``L_BFGS_B_optimize`` and ``Adam_optimize``.  The two
gradient chassis optimize in the unconstrained z-space of
:mod:`muygpys_torch.optimize.bijectors`, on exact ``torch.autograd``
gradients through the whole objective (kernel -> Cholesky -> loss),
eagerly: one objective evaluation is one forward and one backward pass.

``Bayes_optimize`` is derivative-free: the Gaussian-process surrogate and
expected improvement of :mod:`muygpys_torch.optimize.bayes` over the
parameters' box bounds (5 random probes and 20 suggested ones by default,
after a probe at the model's current values), one objective evaluation a
probe with no gradient.  A probe whose Cholesky fails scores as a
non-finite one does (``-1e12``), as in JAX, where the factorization
returns NaN.

A hierarchical (nonstationary) length scale needs the batch's features:
pass ``batch_features=`` to the chassis or to ``make_obj_fn``.

``L_BFGS_B_optimize`` is scipy's L-BFGS-B.  A proposal whose objective or
gradient is not finite scores a large finite penalty, so the line search
backtracks instead of ending the run at the initial point; a Cholesky that
fails counts as such a proposal (``torch.linalg.cholesky`` raises where the
JAX factorization returns NaN).  When the objective or gradient is not
finite at the initial point, the chassis runs derivative-free.

``Adam_optimize`` is a ``torch.optim.Adam`` loop with the JAX package's
defaults (learning rate 0.05, 200 steps), the counterpart of its
``lax.scan`` over optax Adam.
"""

from __future__ import annotations

import math
from copy import deepcopy
from typing import Callable, Dict, Optional

import numpy as np
import torch

from muygpys_torch.optimize import bijectors
from muygpys_torch.optimize.bayes import BayesianOptimization
from muygpys_torch.optimize.loss import LossFn, lool_fn
from muygpys_torch.optimize.objective import make_loo_crossval_fn

#: objective value given to scipy for a proposal that is not finite
PENALTY = 1e12


def _new_muygps(muygps, x0_names, bounds, opt_dict):
    """Clone the model with optimized values clipped to bounds, re-made."""
    ret = deepcopy(muygps)
    for i, key in enumerate(x0_names):
        lb, ub = bounds[i]
        val = float(np.clip(float(opt_dict[key]), lb, ub))
        if key == "noise":
            ret.noise._set_val(val)
        else:
            ret.kernel._hyperparameters[key]._set_val(val)
    ret._make()
    return ret


def _get_opt_lists(muygps, verbose: bool = False):
    x0_names, x0, bounds = muygps.get_opt_params()
    if verbose:
        print(f"parameters to be optimized: {x0_names}")
        print(f"bounds: {bounds}")
        print(f"initial x0: {x0}")
    return x0_names, x0, bounds


def _value_and_grad_z(obj_fn: Callable, x0_names, bounds, like):
    """``z (numpy) -> (value, dvalue/dz)`` by one forward and one backward
    pass, in the dtype and on the device of the tensor ``like``."""
    to_theta, _ = bijectors.make_param_bijector(x0_names, bounds)

    def value_and_grad(z):
        zt = torch.tensor(
            z, dtype=like.dtype, device=like.device, requires_grad=True
        )
        val = obj_fn(**to_theta({n: zt[i] for i, n in enumerate(x0_names)}))
        (g,) = torch.autograd.grad(val, zt)
        return float(val.detach()), g.detach().cpu().numpy().astype(float)

    return value_and_grad


def _scipy_optimize(muygps, obj_fn, like, verbose: bool = False, **kwargs):
    """L-BFGS-B in z-space on autograd gradients (derivative-free when the
    initial point gives no finite gradient)."""
    from scipy import optimize as opt

    x0_names, x0, bounds = _get_opt_lists(muygps, verbose=verbose)
    lo, hi = bounds[:, 0], bounds[:, 1]
    z0 = bijectors.inverse_np(x0, lo, hi)
    vag = _value_and_grad_z(obj_fn, x0_names, bounds, like)
    try:
        val, g = vag(z0)
        use_grad = bool(np.isfinite(val) and np.all(np.isfinite(g)))
    except torch.linalg.LinAlgError:
        use_grad = False

    if use_grad:

        def fun(z):
            try:
                v, g = vag(z)
            except torch.linalg.LinAlgError:
                return PENALTY, np.zeros_like(z)
            if not (np.isfinite(v) and np.all(np.isfinite(g))):
                return PENALTY, np.zeros_like(g)
            return -v, -g

        optres = opt.minimize(fun, z0, method="L-BFGS-B", jac=True, **kwargs)
    else:

        def fun(z):
            theta = bijectors.forward_np(z, lo, hi)
            with torch.no_grad():
                try:
                    v = float(obj_fn(
                        **{n: float(theta[i]) for i, n in enumerate(x0_names)}
                    ))
                except torch.linalg.LinAlgError:
                    return PENALTY
            return -v if np.isfinite(v) else PENALTY

        optres = opt.minimize(fun, z0, method="L-BFGS-B", **kwargs)
    if verbose:
        print(f"optimizer results: \n{optres}")
    theta = bijectors.forward_np(optres.x, lo, hi)
    return _new_muygps(
        muygps, x0_names, bounds, {n: theta[i] for i, n in enumerate(x0_names)}
    )


def scalar_objective(obj_fn: Callable) -> Callable:
    """``obj_fn`` as a function of floats returning a float, without
    gradients; a failed Cholesky gives NaN, which the Bayesian optimizer
    scores ``-1e12`` (as a NaN factor is in JAX)."""

    def scalar_obj(**params):
        with torch.no_grad():
            try:
                return float(obj_fn(**params))
            except torch.linalg.LinAlgError:
                return math.nan

    return scalar_obj


def _bayes_opt_optimize(muygps, obj_fn, like, verbose: bool = False,
                        **kwargs):
    """Bayesian optimization over the box bounds (``init_points`` random
    probes and ``n_iter`` suggested ones, 5 and 20 by default, after a
    probe at the current values; ``random_state`` seeds the draws)."""
    x0_names, x0, bounds = _get_opt_lists(muygps, verbose=verbose)
    maximize_kwargs = {
        k: kwargs[k] for k in kwargs if k in {"init_points", "n_iter"}
    }
    maximize_kwargs.setdefault("init_points", 5)
    maximize_kwargs.setdefault("n_iter", 20)
    optimizer_kwargs = {k: kwargs[k] for k in kwargs if k in {"random_state"}}
    optimizer = BayesianOptimization(
        f=scalar_objective(obj_fn),
        pbounds={n: tuple(bounds[i]) for i, n in enumerate(x0_names)},
        verbose=1 if verbose else 0,
        **optimizer_kwargs,
    )
    optimizer.probe({n: x0[i] for i, n in enumerate(x0_names)}, lazy=True)
    optimizer.maximize(**maximize_kwargs)
    return _new_muygps(muygps, x0_names, bounds, optimizer.max["params"])


def _adam_optimize(
    muygps,
    obj_fn,
    like,
    verbose: bool = False,
    learning_rate: float = 0.05,
    n_iter: int = 200,
    **kwargs,
):
    """Adam ascent in z-space: one forward and backward pass per step."""
    x0_names, x0, bounds = _get_opt_lists(muygps, verbose=verbose)
    to_theta, to_z = bijectors.make_param_bijector(x0_names, bounds)
    z0 = to_z({n: x0[i] for i, n in enumerate(x0_names)})
    z = torch.tensor(
        [z0[n] for n in x0_names], dtype=like.dtype, device=like.device,
        requires_grad=True,
    )
    adam = torch.optim.Adam([z], lr=learning_rate)
    for it in range(n_iter):
        adam.zero_grad()
        neg = -obj_fn(**to_theta({n: z[i] for i, n in enumerate(x0_names)}))
        neg.backward()
        adam.step()
        if verbose and it % max(1, n_iter // 10) == 0:
            print(f"adam iter {it}: obj={-float(neg):.6g}")
    theta = to_theta({n: z[i] for i, n in enumerate(x0_names)})
    return _new_muygps(
        muygps, x0_names, bounds,
        {n: float(v.detach()) for n, v in theta.items()},
    )


class OptimizeFn:
    """Model-agnostic outer optimization loop functor."""

    def __init__(self, optimize_fn: Callable, make_obj_fn: Callable):
        self._fn = optimize_fn
        self._make_obj_fn = make_obj_fn

    def __call__(
        self,
        muygps,
        batch_targets,
        batch_nn_targets,
        crosswise_diffs,
        pairwise_diffs,
        batch_features=None,
        loss_fn: LossFn = lool_fn,
        loss_kwargs: Optional[Dict] = None,
        target_mask=None,
        verbose: bool = False,
        **kwargs,
    ):
        """Optimize the model's free parameters over a fixed training batch
        (tensors on any device; the optimization runs where they are).
        ``batch_features`` (the batch points' features) is needed by a
        hierarchical length scale."""
        pairwise_diffs = torch.as_tensor(pairwise_diffs)
        obj_fn = self.make_obj_fn(
            muygps,
            batch_targets,
            batch_nn_targets,
            crosswise_diffs,
            pairwise_diffs,
            batch_features=batch_features,
            target_mask=target_mask,
            loss_fn=loss_fn,
            loss_kwargs=loss_kwargs,
        )
        return self._fn(
            muygps, obj_fn, pairwise_diffs, verbose=verbose, **kwargs
        )

    def make_obj_fn(
        self,
        muygps,
        batch_targets,
        batch_nn_targets,
        crosswise_diffs,
        pairwise_diffs,
        batch_features=None,
        target_mask=None,
        loss_fn: LossFn = lool_fn,
        loss_kwargs: Optional[Dict] = None,
        **kwargs,
    ) -> Callable:
        pairwise_diffs = torch.as_tensor(pairwise_diffs)

        def like(x):
            return torch.as_tensor(
                x, dtype=pairwise_diffs.dtype, device=pairwise_diffs.device
            )

        return self._make_obj_fn(
            loss_fn,
            muygps.kernel.get_opt_fn(),
            muygps.get_opt_mean_fn(),
            muygps.get_opt_var_fn(),
            muygps.scale.get_opt_fn(muygps),
            pairwise_diffs,
            like(crosswise_diffs),
            like(batch_nn_targets),
            like(batch_targets),
            batch_features=(
                None if batch_features is None else like(batch_features)
            ),
            target_mask=target_mask,
            loss_kwargs=loss_kwargs,
        )


Bayes_optimize = OptimizeFn(_bayes_opt_optimize, make_loo_crossval_fn)
"""Bayesian-optimization chassis (GP surrogate + expected improvement)."""


L_BFGS_B_optimize = OptimizeFn(_scipy_optimize, make_loo_crossval_fn)
"""scipy L-BFGS-B chassis on exact autograd gradients."""

Adam_optimize = OptimizeFn(_adam_optimize, make_loo_crossval_fn)
"""torch.optim.Adam chassis (ascent in z-space; for epoch-style loops)."""
