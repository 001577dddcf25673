"""Fused-objective L-BFGS-B chassis: the production training path.

Counterpart of :func:`muygpys_tpu.optimize.Fused_L_BFGS_B_optimize`: the
same result contract as :data:`muygpys_torch.optimize.L_BFGS_B_optimize`
for the production model classes (Matern with any fixed or free smoothness,
or RBF, Isotropy or Anisotropy, homo- or heteroscedastic noise, loss in lool,
mse, looph, huber), with the objective evaluated by

- ``engine="kernel"`` (alias ``"pallas"``, the JAX name): K2, one launch per evaluation
  returning the value AND the analytic gradient
  (:func:`muygpys_torch.optimize.fused_objective.make_fused_train_objective`);
  a free smoothness, or a fixed one without a closed form, goes through the
  traced-nu surrogate and must stay inside ``[0.05, 10]`` on the l2 metric;
- ``engine="lanes"``: the lane-layout objective under ``torch.autograd``
  (:func:`muygpys_torch.optimize.fast_objective.make_fast_loo_objective`),
  general smoothness through the exact Bessel path.

A lensing shear model (``ShearKernel``, ``ShearKernel2in3out``) with loss
mse, or lool under a ``FixedScale``, trains on the shared-factorization
assembly of :mod:`muygpys_torch.optimize.shear_objective` in its batched
layout under ``torch.autograd``, whatever ``engine`` says.  Shear lool with
an ``AnalyticScale`` is a different objective (the scale is re-estimated at
every evaluation) and raises a ``ValueError`` that names the generic
``L_BFGS_B_optimize`` chassis, which trains it.

Unlike the JAX chassis there is no fallback: on a CUDA device a kernel that
does not build or launch, or a probe at the initial point that is not
finite, raises.  An unsupported model class raises ``ValueError`` before any
launch.  A hierarchical (nonstationary) length scale is such a class for
K2: ``engine="kernel"`` raises a ``ValueError`` naming ``engine="lanes"``
(where JAX falls back to its lanes engine), and ``engine="lanes"`` trains
it, given ``batch_features=`` (the batch points' features).

A batch sharded over a mesh (DTensors of
:func:`muygpys_torch.parallel.shard_batch`) trains through K2 on each
rank's rows (the epilogue's sums all-reduced) or, for a shear model, the
shear assembly with its loss reduced over the ranks; every rank runs scipy
on the same values and ends on the same optimum.  ``engine="lanes"``
refuses a sharded batch of any other model.

    model = Fused_L_BFGS_B_optimize(model, bt, bnt, cw, pw, loss="lool")
"""

from __future__ import annotations

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gp.kernels.experimental import (
    ShearKernel,
    ShearKernel2in3out,
)
from muygpys_torch.optimize import bijectors
from muygpys_torch.optimize.chassis import (
    PENALTY,
    _get_opt_lists,
    _new_muygps,
)
from muygpys_torch.optimize.fast_objective import make_fast_loo_objective
from muygpys_torch.optimize.fused_objective import make_fused_train_objective
from muygpys_torch.optimize.shear_objective import (
    make_shear_loo_objective,
    shear_objective_supports,
)
from muygpys_torch.parallel.sharding import sharded_batch


def Fused_L_BFGS_B_optimize(
    muygps,
    batch_targets,
    batch_nn_targets,
    crosswise_dists,
    pairwise_dists,
    loss: str = "lool",
    engine: str = "kernel",
    verbose: bool = False,
    interpret=None,
    batch_features=None,
    device=None,
    **kwargs,
):
    """L-BFGS-B over the fused LOO objective on ``device`` (default
    ``"cuda"``; ``"cpu"`` runs K2's plain version); returns the optimized
    model.  ``engine="pallas"`` (JAX's default) is ``"kernel"``.
    ``interpret`` is JAX's Pallas-interpreter switch, taken and unused: on
    the CPU the kernels' plain versions run.  ``batch_features`` is read by
    a hierarchical length scale (``engine="lanes"``).  Extra keyword
    arguments go to ``scipy.optimize.minimize``."""
    from scipy import optimize as opt

    engine = config.kernel_alias(engine)
    if engine not in ("kernel", "lanes"):
        raise ValueError(f"unknown engine {engine!r} (kernel, lanes)")
    shear = isinstance(muygps.kernel, (ShearKernel, ShearKernel2in3out))
    if engine == "lanes" and not shear and sharded_batch(
            [pairwise_dists])[0] is not None:
        raise ValueError(
            "a sharded batch trains through engine=\"kernel\" (K2, its "
            "sums all-reduced) or the generic L_BFGS_B_optimize chassis"
        )
    dev = config.device(device)
    x0_names, x0, bounds = _get_opt_lists(muygps, verbose=verbose)
    args = (muygps, batch_targets, batch_nn_targets, crosswise_dists,
            pairwise_dists)
    if shear and not shear_objective_supports(muygps, loss):
        raise ValueError(
            f"the fused chassis trains a shear model with loss 'mse', or "
            f"'lool' under a FixedScale; got loss {loss!r} with "
            f"{type(muygps.scale).__name__}.  Use the generic "
            "L_BFGS_B_optimize chassis, which re-estimates the scale at "
            "every evaluation"
        )
    if engine == "kernel" and not shear:
        vag, _ = make_fused_train_objective(*args, loss=loss, device=dev)
    else:
        if shear:
            obj_fn, _ = make_shear_loo_objective(
                *args, loss=loss, layout="batched", device=dev
            )
        else:
            obj_fn, _ = make_fast_loo_objective(
                *args, loss=loss, batch_features=batch_features, device=dev
            )
        dtype = torch.as_tensor(pairwise_dists).dtype

        def vag(params):
            theta = {
                n: torch.tensor(float(v), dtype=dtype, device=dev,
                                requires_grad=True)
                for n, v in params.items()
            }
            value = obj_fn(theta)
            value.backward()
            return value.detach(), {n: t.grad for n, t in theta.items()}

    # probe at x0: with a non-finite initial objective the NaN-safe `fun`
    # below would return the penalty and L-BFGS-B would "converge" at x0,
    # silently returning the unoptimized model
    v0, g0 = vag({n: x0[i] for i, n in enumerate(x0_names)})
    if not (
        np.isfinite(float(v0))
        and all(np.isfinite(float(g0[n])) for n in x0_names)
    ):
        raise ValueError(
            f"fused objective is non-finite at the initial point "
            f"(value={float(v0)!r}); check the model's initial "
            "hyperparameters, or use the generic L_BFGS_B_optimize chassis "
            "(it falls back to derivative-free search)"
        )

    # optimize in unconstrained z-space; the bijector chain rule is applied
    # to the engines' theta-space gradients on the host
    lo, hi = bounds[:, 0], bounds[:, 1]
    z0 = bijectors.inverse_np(x0, lo, hi)

    def fun(z):
        theta = bijectors.forward_np(z, lo, hi)
        try:
            v, g = vag({n: theta[i] for i, n in enumerate(x0_names)})
        except torch.linalg.LinAlgError:
            # the batched shear layout factorizes with torch.linalg.cholesky,
            # which raises where the floored block elimination carries on
            return PENALTY, np.zeros_like(z)
        # value and gradient reach the host in one transfer
        vg = torch.stack([v] + [g[n] for n in x0_names]).double().cpu()
        fv, gt = float(vg[0]), vg[1:].numpy()
        gz = gt * bijectors.dforward_dz_np(z, lo, hi)
        if not (np.isfinite(fv) and np.all(np.isfinite(gz))):
            # NaN-safe line search: see chassis._scipy_optimize
            return PENALTY, np.zeros_like(gz)
        return -fv, -gz

    optres = opt.minimize(fun, z0, method="L-BFGS-B", jac=True, **kwargs)
    if verbose:
        print(f"optimizer results: \n{optres}")
    theta = bijectors.forward_np(optres.x, lo, hi)
    return _new_muygps(
        muygps, x0_names, bounds, {n: theta[i] for i, n in enumerate(x0_names)}
    )
