"""Fast LOO objective for the lensing shear family.

Counterpart of :mod:`muygpys_tpu.optimize.shear_objective`: the generic
composed objective factorizes the same ``(I * nn, I * nn)`` observation
blocks once for the posterior mean and again for the covariance; this
assembly shares ONE factorization between the mean and the full ``(O, O)``
covariance, in either solver layout, under ``torch.autograd``:

- ``layout="lanes"``: the batch-last floored block elimination of
  :mod:`muygpys_torch.ops.lanes_solver` (a Python loop of ``I * nn`` steps);
- ``layout="batched"``: one flattened ``(B, m, m)`` Cholesky
  (:func:`muygpys_torch.ops.solve.cholesky`: NaN for a failed factor inside
  ``sync_free``, as the device chassis steps it) and a single stacked
  triangular solve.

Losses: ``"mse"`` on the posterior mean and ``"lool"``, the multivariate
leave-one-out likelihood over the full ``(O, O)`` covariance blocks
(:func:`muygpys_torch.ops.loss.lool_fn_unscaled`).  Objectives return
``-loss``, to be maximized, as every other objective of the package.  A
batch sharded over a mesh (DTensors of
:func:`muygpys_torch.parallel.shard_batch`) gives the objective of the
whole batch on every rank: each rank assembles and solves its local rows and
the loss's sums are all-reduced (:mod:`muygpys_torch.parallel.comm`).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gp.hyperparameter import FixedScale
from muygpys_torch.gp.kernels.experimental import (
    ShearKernel,
    ShearKernel2in3out,
)
from muygpys_torch.ops import solve as _solve
from muygpys_torch.ops.lanes_solver import multiout_serve_mean_and_variance
from muygpys_torch.ops.loss import lool_fn_unscaled
from muygpys_torch.parallel import comm
from muygpys_torch.parallel.sharding import sharded_batch


def shear_objective_supports(muygps, loss: str = "mse") -> bool:
    """True iff :func:`make_shear_loo_objective` covers this model.

    ``loss="lool"`` requires a FIXED scale: the assembly bakes the model's
    stored scale into the covariance, whereas the generic objective
    re-estimates an ``AnalyticScale`` at every evaluation, so routing such a
    model here would train a different objective.  ``"mse"`` is mean-only
    and scale-free, so any scale functor is fine."""
    if not isinstance(muygps.kernel, (ShearKernel, ShearKernel2in3out)):
        return False
    if loss == "mse":
        return True
    if loss != "lool":
        return False
    return isinstance(muygps.scale, FixedScale)


def make_shear_loo_objective(
    muygps,
    batch_targets,
    batch_nn_targets,
    crosswise_diffs,
    pairwise_diffs,
    loss: str = "mse",
    layout: str = "lanes",
    device=None,
) -> Tuple[Callable, List[str]]:
    """Build ``obj_fn(params_dict) -> -loss`` for a shear-family model.

    Args:
        muygps: MuyGPS with a :class:`ShearKernel` or
            :class:`ShearKernel2in3out` (DifferenceIsotropy deformation,
            homoscedastic or ShearNoise33 noise; a fixed scalar scale under
            lool).
        batch_targets: ``(B, O)`` observed outputs at the batch points.
        batch_nn_targets: ``(B, I, nn)`` flattened neighbor observations.
        crosswise_diffs / pairwise_diffs: the deformation's difference
            tensors ``(B, nn, 2)`` / ``(B, nn, nn, 2)``.
        device: where the objective runs (default ``"cuda"``).

    Returns ``(obj_fn, free_param_names)``; values passed as tensors that
    require grad are differentiated by ``torch.autograd``.
    """
    if not shear_objective_supports(muygps, loss):
        raise ValueError(
            f"shear objective supports ShearKernel/ShearKernel2in3out "
            f"with loss mse/lool; got {type(muygps.kernel)} / {loss!r}"
        )
    if layout not in ("lanes", "batched"):
        raise ValueError(f"unknown layout {layout!r}")
    dev = config.device(device)
    group, (batch_targets, batch_nn_targets, crosswise_diffs,
            pairwise_diffs) = sharded_batch([
        batch_targets, batch_nn_targets, crosswise_diffs, pairwise_diffs
    ])

    kernel = muygps.kernel
    names, _, _ = muygps.get_opt_params()
    ls0 = float(kernel.deformation.length_scale())
    noise0 = float(muygps.noise())
    scale = np.asarray(muygps.scale(), dtype=float)
    if loss == "lool" and scale.size != 1:
        raise ValueError(
            "shear lool objective takes a scalar scale; got one of shape "
            f"{scale.shape}"
        )
    scale = float(scale.reshape(-1)[0])

    pw = torch.as_tensor(pairwise_diffs, device=dev)
    dtype = pw.dtype
    bt, bnt, cw = (
        torch.as_tensor(t, dtype=dtype, device=dev)
        for t in (batch_targets, batch_nn_targets, crosswise_diffs)
    )
    Kout = kernel.Kout().to(dtype=dtype, device=dev)
    B, I, nn = bnt.shape
    m = I * nn
    o = Kout.shape[0]

    def obj_fn(params):
        ls = params.get("length_scale", ls0)
        noise = params.get("noise", noise0)
        Kin = kernel(pw, length_scale=ls)  # (B, I, nn, I, nn)
        Kcross = kernel(cw, length_scale=ls)  # (B, I, nn, O)
        Kp = muygps.noise.perturb(Kin, noise=noise)
        if layout == "lanes":
            mean, cov = multiout_serve_mean_and_variance(Kp, Kcross, Kout, bnt)
        else:
            L = _solve.cholesky(Kp.reshape(B, m, m))
            rhs = torch.cat(
                [Kcross.reshape(B, m, o), bnt.reshape(B, m, 1)], dim=2
            )
            # ONE factorization, one stacked substitution
            Z = torch.linalg.solve_triangular(L, rhs, upper=False)
            zc, zy = Z[:, :, :o], Z[:, :, o]
            mean = torch.einsum("bmo,bm->bo", zc, zy)
            cov = Kout[None] - torch.einsum("bmo,bmp->bop", zc, zc)
        if loss == "mse":
            return -comm.batch_sum((mean - bt) ** 2) / comm.batch_total(
                bt.numel(), bt)
        return -lool_fn_unscaled(mean, bt, scale * cov)

    if group is not None:
        from muygpys_torch.optimize.chassis import sharded_objective

        sharded = sharded_objective(
            lambda local_obj=obj_fn, **p: local_obj(p), group
        )

        def obj_fn(params):
            return sharded(**params)

    return obj_fn, list(names)
