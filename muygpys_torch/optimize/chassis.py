"""Outer-loop optimization chassis.

Counterpart of :mod:`muygpys_tpu.optimize.chassis`: ``OptimizeFn``,
``L_BFGS_B_optimize`` and ``Adam_optimize``.  Both optimize in the
unconstrained z-space of :mod:`muygpys_torch.optimize.bijectors`, on exact
``torch.autograd`` gradients through the whole objective (kernel ->
Cholesky -> loss), eagerly: one objective evaluation is one forward and one
backward pass.

``L_BFGS_B_optimize`` is scipy's L-BFGS-B.  A proposal whose objective or
gradient is not finite scores a large finite penalty, so the line search
backtracks instead of ending the run at the initial point; a Cholesky that
fails counts as such a proposal (``torch.linalg.cholesky`` raises where the
JAX factorization returns NaN).  When the objective or gradient is not
finite at the initial point, the chassis runs derivative-free.

``Adam_optimize`` is a ``torch.optim.Adam`` loop with the JAX package's
defaults (learning rate 0.05, 200 steps), the counterpart of its
``lax.scan`` over optax Adam.  ``Bayes_optimize`` is not ported yet.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Callable, Dict, Optional

import numpy as np
import torch

from muygpys_torch.optimize import bijectors
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
        loss_fn: LossFn = lool_fn,
        loss_kwargs: Optional[Dict] = None,
        target_mask=None,
        verbose: bool = False,
        **kwargs,
    ):
        """Optimize the model's free parameters over a fixed training batch
        (tensors on any device; the optimization runs where they are)."""
        pairwise_diffs = torch.as_tensor(pairwise_diffs)
        obj_fn = self.make_obj_fn(
            muygps,
            batch_targets,
            batch_nn_targets,
            crosswise_diffs,
            pairwise_diffs,
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
        target_mask=None,
        loss_fn: LossFn = lool_fn,
        loss_kwargs: Optional[Dict] = None,
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
            target_mask=target_mask,
            loss_kwargs=loss_kwargs,
        )


L_BFGS_B_optimize = OptimizeFn(_scipy_optimize, make_loo_crossval_fn)
"""scipy L-BFGS-B chassis on exact autograd gradients."""

Adam_optimize = OptimizeFn(_adam_optimize, make_loo_crossval_fn)
"""torch.optim.Adam chassis (ascent in z-space; for epoch-style loops)."""
