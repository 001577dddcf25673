"""The K2 objective of a model and a training batch.

Counterpart of :func:`muygpys_tpu.pallas.fused_train.make_fused_train_objective`:
the model's parameters become K2's runtime parameter vector, and one
evaluation is one K2 launch (:func:`muygpys_torch.gpu.fused_train.fused_train_stats_bl`)
plus the host epilogue, returning the value and the analytic gradient.  The
model classes and losses are those of
:func:`muygpys_torch.optimize.fast_objective.make_fast_loo_objective`.  A
free Matern smoothness, or a fixed one without a closed form, rides the
traced-nu surrogate (:mod:`muygpys_torch.gpu.matern_nu`).  A fixed
smoothness builds its coefficient vector once, with the objective; a free
one builds it, with the nu-tangent sets, at every evaluation.  Both build on
the objective's device, in the data's dtype.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import torch

from muygpys_torch import config
from muygpys_torch.gp.deformation import Anisotropy
from muygpys_torch.gp.kernels import RBF
from muygpys_torch.gp.kernels.matern import CLOSED_FORMS
from muygpys_torch.gp.noise import HeteroscedasticNoise
from muygpys_torch.gpu.fused_train import (
    FusedLOO,
    _epilogue,
    fused_train_stats_bl,
)
from muygpys_torch.gpu.matern_nu import NU_MAX, NU_MIN, matern_nu_coeffs
from muygpys_torch.optimize.fast_objective import (
    batch_last,
    check_model,
    is_hierarchical,
)


class FusedTrainObjective:
    """The fused LOO objective of one training batch.

    ``self(params_dict) -> (value, grads_dict)`` is the JAX package's
    ``value_and_grad_fn`` contract; :meth:`value` is the differentiable form
    over a 1-D tensor ordered as :attr:`names`, through
    :class:`muygpys_torch.gpu.fused_train.FusedLOO`.  ``defaults`` holds
    K2's parameter vector (length scales, noise, stored noise and, when it
    is free, the smoothness) as 0-d tensors keyed by name; a free
    parameter's value replaces its default.
    """

    def __init__(self, names: Sequence[str], defaults: Dict, stats_fn,
                 epilogue):
        self.names = list(names)
        self._defaults = defaults
        self._stats_fn = stats_fn
        self._epilogue = epilogue

    def evaluate(self, theta: torch.Tensor):
        """``(value, gradient)`` at a 1-D ``theta`` ordered as
        :attr:`names`, on the objective's device (any float dtype; the
        gradient comes back in ``theta``'s): one K2 launch (and, under a
        free smoothness, one launch of the coefficient constructor) and the
        epilogue's tensor operations, with nothing read back to the host,
        so the device chassis captures it in its graph."""
        vals = dict(self._defaults)
        like = next(iter(vals.values()))
        vals.update(zip(self.names, theta.to(like.dtype)))
        value, grads = self._epilogue(
            self._stats_fn(torch.stack(list(vals.values())))
        )
        if not self.names:
            return value, theta.new_zeros((0,))
        return value, torch.stack([grads[nm] for nm in self.names]).to(
            theta.dtype
        )

    def value(self, theta: torch.Tensor) -> torch.Tensor:
        """The objective at ``theta`` (ordered as :attr:`names`),
        differentiable through ``FusedLOO``."""
        return FusedLOO.apply(theta, self.evaluate)

    def __call__(self, params: Dict):
        like = next(iter(self._defaults.values()))
        theta = torch.tensor(
            [float(params.get(nm, self._defaults[nm])) for nm in self.names],
            dtype=like.dtype, device=like.device,
        )
        value, grad = self.evaluate(theta)
        return value, dict(zip(self.names, grad))


def make_fused_train_objective(
    muygps, batch_targets, batch_nn_targets, crosswise_dists, pairwise_dists,
    loss: str = "lool", boundary_scale: float = None, device=None,
):
    """K2 value-and-gradient LOO objective for the fused chassis.

    The model classes of
    :func:`muygpys_torch.optimize.fast_objective.make_fast_loo_objective`:
    Matern (a fixed closed-form smoothness by its formula; a free one, with
    bounds inside ``[0.05, 10]``, or any other fixed one in that range
    through the traced-nu surrogate with analytic d/dnu rows, l2 metric
    only) or RBF; Isotropy (distance
    tensors ``(B, n)`` / ``(B, n, n)``) or Anisotropy (per-feature
    differences ``(B, n, d)`` / ``(B, n, n, d)``, one derivative group per
    feature); homoscedastic or heteroscedastic noise; loss in {lool, mse,
    looph, huber}.  A hierarchical length scale raises ``ValueError``,
    naming ``engine="lanes"``, before anything runs.  ``boundary_scale`` defaults per loss: 3.0 for looph,
    1.5 for huber.  Runs on ``device`` (default ``"cuda"``; ``"cpu"`` runs
    K2's plain version).

    Returns ``(objective, free_param_names)``: ``objective(params_dict) ->
    (value, grads_dict)`` in the maximization convention, and
    ``objective.value(theta)`` the ``torch.autograd`` form.
    """
    loss = check_model(muygps, loss)
    if is_hierarchical(muygps):
        raise ValueError(
            "K2 takes one length scale (or one per feature), not a "
            "hierarchical field; train a hierarchical model with "
            "engine=\"lanes\" (or the generic chassis), passing "
            "batch_features="
        )
    if boundary_scale is None:
        boundary_scale = 3.0 if loss == "looph" else 1.5
    dev = config.device(device)
    kernel = muygps.kernel
    names, _, _ = muygps.get_opt_params()
    pw_bl, cw_bl, y_bl, t_bl, d_feat = batch_last(
        muygps, batch_targets, batch_nn_targets, crosswise_dists,
        pairwise_dists, dev,
    )
    ls = kernel.deformation.length_scale
    ls_params = list(ls) if isinstance(kernel.deformation, Anisotropy) else [ls]
    ls_keys = tuple(p.name() for p in ls_params)
    if isinstance(muygps.noise, HeteroscedasticNoise):
        noise_free, noise0 = False, 0.0
        noise_nn = torch.as_tensor(
            muygps.noise(), dtype=pw_bl.dtype, device=dev
        ).T.contiguous()
    else:
        noise_free = "noise" in names
        noise0 = float(muygps.noise())
        noise_nn = None
    smoothness, smoothness_free = _kernel_smoothness(kernel)
    gen = smoothness == "gen"
    dtype = pw_bl.dtype
    defaults = {
        key: torch.tensor(float(val), dtype=dtype, device=dev)
        for key, val in [(p.name(), p()) for p in ls_params]
        + [("noise", noise0), ("stored noise", noise0)]
        + ([("smoothness", kernel.smoothness())] if smoothness_free else [])
    }
    launch = functools.partial(
        fused_train_stats_bl, pw_bl.contiguous(), cw_bl.contiguous(),
        y_bl.contiguous(), noise_nn=noise_nn, smoothness=smoothness,
        metric_power=1 if kernel.deformation.metric.name == "l2" else 2,
        noise_free=noise_free, smoothness_free=smoothness_free,
        d_feat=d_feat, device=dev,
    )
    # the whole nu-dependence of the kernel, ~10^2 scalars, built where the
    # data lies and in its dtype
    if smoothness_free:
        def stats_fn(vec):
            return launch(
                vec[:-1], gen_coeffs=matern_nu_coeffs(vec[-1], need_dnu=True)
            )
    elif gen:
        nu = torch.tensor(float(kernel.smoothness()), dtype=dtype, device=dev)
        stats_fn = functools.partial(launch, gen_coeffs=matern_nu_coeffs(nu))
    else:
        stats_fn = launch
    epilogue = functools.partial(
        _epilogue, t_bl=t_bl, loss=loss, free_names=names, n=pw_bl.shape[0],
        boundary_scale=boundary_scale, ls_keys=ls_keys,
    )
    return FusedTrainObjective(names, defaults, stats_fn, epilogue), names


def _kernel_smoothness(kernel):
    """``(smoothness argument of K2, whether it is free)`` for a model's
    kernel: ``"rbf"``, a closed-form order, or ``"gen"`` for a free or any
    other fixed order, which must lie in the surrogate's certified domain
    and on the l2 metric."""
    if isinstance(kernel, RBF):
        return "rbf", False
    nu = float(kernel.smoothness())
    free = not kernel.smoothness.fixed()
    if free:
        lo, hi = kernel.smoothness.get_bounds()
        if not (NU_MIN <= lo and hi <= NU_MAX):
            raise ValueError(
                f"free smoothness bounds ({lo}, {hi}) exceed the certified "
                f"surrogate domain [{NU_MIN}, {NU_MAX}]"
            )
    elif nu in CLOSED_FORMS:
        return nu, False
    elif not (NU_MIN <= nu <= NU_MAX):
        raise ValueError(
            f"fixed smoothness {nu} outside the certified surrogate domain "
            f"[{NU_MIN}, {NU_MAX}]"
        )
    if kernel.deformation.metric.name != "l2":
        raise ValueError("general-smoothness Matern requires the l2 metric")
    return "gen", free
