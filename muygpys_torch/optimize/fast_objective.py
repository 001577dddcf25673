"""Lane-layout LOO objective, differentiated by ``torch.autograd``.

Counterpart of :func:`muygpys_tpu.optimize.fast_objective.make_fast_loo_objective`
with ``layout="lanes"``: the production model classes are assembled in the
batch-last ``(n, n, B)`` layout of :mod:`muygpys_torch.ops.lanes_solver`,
with ONE floored Cholesky shared by the posterior mean, the variance and
sigma^2.  It is the ``engine="lanes"`` of
:func:`muygpys_torch.optimize.Fused_L_BFGS_B_optimize`, and a second
derivation of K2's analytic gradient (:mod:`muygpys_torch.gpu.fused_train`)
that does not depend on JAX.

Covered: Matern with a fixed closed-form nu (its closed form) or any other
fixed or free nu (the exact Bessel path of :mod:`muygpys_torch.ops.bessel`,
differentiable in nu), or RBF; Isotropy or Anisotropy;
a hierarchical (nonstationary) length scale under Isotropy, its field
re-solved from the knot values at every evaluation (pass
``batch_features``); homoscedastic (optionally free) or heteroscedastic
noise; loss lool, mse, looph or huber (unnormalized pseudo-Huber on the
mean).  The reference's
stored-noise sigma^2 quirk is carried over exactly: sigma^2 perturbs Kin
with the model's STORED noise, so a free noise costs a second
factorization and d sigma^2 / d noise = 0.

``layout="batched"`` keeps the batch first, ``(B, n, n)``, and factors with
one batched ``torch.linalg.cholesky`` and one stacked triangular solve, as
the JAX package's batched layout does with ``jnp.linalg.cholesky``.  It is
the objective of the device chassis (:mod:`muygpys_torch.optimize.device_chassis`),
which steps it inside :func:`muygpys_torch.ops.solve.sync_free`: there a
failed factorization is NaN (scored as the chassis' large penalty) instead
of an error, and nothing is read back to the host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from muygpys_torch import config
from muygpys_torch.gp.deformation import Anisotropy, Isotropy
from muygpys_torch.gp.kernels import Matern, RBF
from muygpys_torch.gp.noise import HeteroscedasticNoise, HomoscedasticNoise
from muygpys_torch.ops import kernels as _k
from muygpys_torch.ops import solve as _solve
from muygpys_torch.ops.lanes_solver import cholesky_bl, tri_solve_fwd_bl
from muygpys_torch.ops.loss import looph_fn, lool_fn, mse_fn, pseudo_huber_fn
from muygpys_torch.ops.tensors import safe_sqrt

#: loss-name aliases: the functor registry calls the mean-only robust loss
#: ``pseudo_huber_fn`` while the fast objectives use the short name
_LOSS_ALIASES = {"pseudo_huber": "huber"}
LOSSES = ("lool", "mse", "looph", "huber")


def check_model(muygps, loss: str) -> str:
    """Raise a clear error for a model class or loss the fast objectives do
    not take, before anything runs; returns the canonical loss name."""
    loss = _LOSS_ALIASES.get(loss, loss)
    kernel = muygps.kernel
    if not isinstance(kernel, (Matern, RBF)):
        raise ValueError(
            f"the fast objectives train Matern and RBF kernels, not "
            f"{type(kernel).__name__}; the shear models train through "
            "make_shear_loo_objective"
        )
    if not isinstance(kernel.deformation, (Isotropy, Anisotropy)):
        raise ValueError(
            "fast objective requires an Isotropy or Anisotropy deformation, "
            f"not {type(kernel.deformation)}"
        )
    if not isinstance(
        muygps.noise, (HomoscedasticNoise, HeteroscedasticNoise)
    ):
        raise ValueError(
            "fast objective requires homo- or heteroscedastic noise, not "
            f"{type(muygps.noise)}"
        )
    if loss not in LOSSES:
        raise ValueError(
            f"fast objective supports lool/mse/looph/huber, not {loss!r}"
        )
    return loss


def batch_last(muygps, batch_targets, batch_nn_targets, crosswise_dists,
               pairwise_dists, dev):
    """The training tensors moved to ``dev`` in batch-last layout:
    ``pw (n, n[, d], B)``, ``cw (n[, d], B)``, ``y (n, r, B)``,
    ``t (r, B)``, and the anisotropic feature count ``d`` (0 isotropic)."""
    pw = torch.as_tensor(pairwise_dists, device=dev)
    dtype = pw.dtype
    cw = torch.as_tensor(crosswise_dists, dtype=dtype, device=dev)
    y = torch.as_tensor(batch_nn_targets, dtype=dtype, device=dev)
    t = torch.as_tensor(batch_targets, dtype=dtype, device=dev)
    if y.ndim == 2:
        y = y[:, :, None]
    if t.ndim == 1:
        t = t[:, None]
    deformation = muygps.kernel.deformation
    if isinstance(deformation, Anisotropy):
        d_feat = len(deformation.length_scale)
        if pw.ndim != 4 or pw.shape[-1] != d_feat:
            raise ValueError(
                "anisotropic objectives expect per-feature difference "
                f"tensors (B, n, n, {d_feat}); got {tuple(pw.shape)}"
            )
        pw_bl, cw_bl = pw.permute(1, 2, 3, 0), cw.permute(1, 2, 0)
    else:
        d_feat = 0
        if pw.ndim != 3:
            raise ValueError(
                f"isotropic objectives expect distances (B, n, n); got "
                f"{tuple(pw.shape)}"
            )
        pw_bl, cw_bl = pw.permute(1, 2, 0), cw.permute(1, 0)
    return pw_bl, cw_bl, y.permute(1, 2, 0), t.permute(1, 0), d_feat


def is_hierarchical(muygps) -> bool:
    """True iff the model's length scale is a hierarchical (nonstationary)
    parameter."""
    from muygpys_torch.gp.hyperparameter.experimental import (
        NamedHierarchicalParameter,
    )

    deformation = muygps.kernel.deformation
    return isinstance(deformation, Isotropy) and isinstance(
        deformation.length_scale, NamedHierarchicalParameter
    )


def _hierarchical_field(muygps, batch_features, like):
    """``params -> (B,)`` length scales of a hierarchical model at the
    batch's features (the knot values by name in ``params``), or ``None``
    for any other model.  The features are read at every call, so a
    caller may refill their tensor between calls."""
    if not is_hierarchical(muygps):
        return None
    if batch_features is None:
        raise ValueError(
            "hierarchical (nonstationary) length scales need batch_features"
        )
    hier = muygps.kernel.deformation.length_scale
    hname = hier.name()
    bf = torch.as_tensor(batch_features, dtype=like.dtype, device=like.device)

    def field(params):
        knots = {k: v for k, v in params.items() if k.startswith(hname)}
        return hier(bf, **knots)

    return field


def fast_objective_supports(muygps, loss: str = "lool") -> bool:
    """True iff :func:`make_fast_loo_objective` covers this model class."""
    loss = _LOSS_ALIASES.get(loss, loss)
    kernel = muygps.kernel
    return (
        isinstance(kernel, (Matern, RBF))
        and isinstance(kernel.deformation, (Isotropy, Anisotropy))
        and isinstance(
            muygps.noise, (HomoscedasticNoise, HeteroscedasticNoise)
        )
        and loss in LOSSES
    )


def make_fast_loo_objective(
    muygps,
    batch_targets,
    batch_nn_targets,
    crosswise_dists,
    pairwise_dists,
    loss: str = "lool",
    layout: str = "lanes",
    boundary_scale: float = None,
    batch_features=None,
    device=None,
) -> Tuple[Callable, list]:
    """Build ``obj_fn(params_dict) -> -loss`` in lane layout.

    Args:
        muygps: Matern (any fixed or free smoothness) or RBF, Isotropy or
            Anisotropy, homoscedastic or heteroscedastic noise.
        batch_targets: ``(B, r)`` or ``(B,)``.
        batch_nn_targets: ``(B, n, r)`` or ``(B, n)``.
        crosswise_dists / pairwise_dists: what ``make_train_tensors`` gives
            for the model's deformation — distances ``(B, n)`` /
            ``(B, n, n)`` for Isotropy, per-feature differences
            ``(B, n, d)`` / ``(B, n, n, d)`` for Anisotropy.
        layout: ``"lanes"`` (the floored batch-last elimination) or
            ``"batched"`` (batch first, one batched Cholesky).
        batch_features: ``(B, f)`` the batch points' features, needed by a
            hierarchical length scale (its field is evaluated there at
            every call, from the tensor as it then is).
        device: where the objective runs (default ``"cuda"``).

    Returns:
        ``(obj_fn, free_param_names)``; ``obj_fn`` takes a dict of free
        parameters (floats or tensors that require grad) and returns the
        negated loss, to be maximized.
    """
    if layout not in ("lanes", "batched"):
        raise ValueError(f"unknown layout {layout!r} (lanes, batched)")
    loss = check_model(muygps, loss)
    if boundary_scale is None:
        # the reference's own per-loss defaults (optimize/loss.py)
        boundary_scale = 3.0 if loss == "looph" else 1.5
    dev = config.device(device)
    kernel = muygps.kernel
    if isinstance(kernel, RBF):
        nu0 = None

        def kfn(dists, nu):
            return _k.rbf_fn(dists)

    else:
        nu0 = kernel.smoothness()
        matern_fn = kernel._kernel_fn  # closed form, or Bessel path in nu

        def kfn(dists, nu):
            return matern_fn(dists, smoothness=nu)

    names, _, _ = muygps.get_opt_params()
    if layout == "batched":
        return _batched_objective(muygps, batch_targets, batch_nn_targets,
                                  crosswise_dists, pairwise_dists, loss,
                                  boundary_scale, dev, kfn, nu0,
                                  batch_features), names
    pw_bl, cw_bl, y_bl, t_bl, d_feat = batch_last(
        muygps, batch_targets, batch_nn_targets, crosswise_dists,
        pairwise_dists, dev,
    )
    n, B = pw_bl.shape[0], pw_bl.shape[-1]
    metric_name = kernel.deformation.metric.name
    ls_param = kernel.deformation.length_scale
    field = _hierarchical_field(muygps, batch_features, pw_bl)

    if d_feat:
        ls_names = [p.name() for p in ls_param]
        ls0 = [p() for p in ls_param]

        def scaled_dists(params):
            ls = torch.stack([
                torch.as_tensor(
                    params.get(nm, v), dtype=pw_bl.dtype, device=dev
                )
                for nm, v in zip(ls_names, ls0)
            ])
            u_p = torch.sum((pw_bl / ls[None, None, :, None]) ** 2, dim=2)
            u_c = torch.sum((cw_bl / ls[None, :, None]) ** 2, dim=1)
            if metric_name == "l2":
                return safe_sqrt(u_p), safe_sqrt(u_c)
            return u_p, u_c

    elif field is not None:
        apply_ls = kernel.deformation.metric.apply_length_scale

        def scaled_dists(params):
            ls_b = field(params)  # (B,) nonstationary field
            return (apply_ls(pw_bl, ls_b[None, None, :]),
                    apply_ls(cw_bl, ls_b[None, :]))

    else:
        apply_ls = kernel.deformation.metric.apply_length_scale

        def scaled_dists(params):
            ls = params.get("length_scale", ls_param())
            return apply_ls(pw_bl, ls), apply_ls(cw_bl, ls)

    eye_bl = torch.eye(n, dtype=pw_bl.dtype, device=dev)[:, :, None]
    if isinstance(muygps.noise, HeteroscedasticNoise):
        eps_bl = torch.as_tensor(
            muygps.noise(), dtype=pw_bl.dtype, device=dev
        ).T  # (n, B)
        noise0 = None
        noise_is_free = False
    else:
        noise0 = float(muygps.noise())
        noise_is_free = "noise" in names

    def obj_fn(params):
        u_p, u_c = scaled_dists(params)
        nu = params.get("smoothness", nu0)
        Kraw = kfn(u_p, nu)
        Kcross = kfn(u_c, nu)  # (n, B)
        if noise0 is None:
            Kin = Kraw + eye_bl * eps_bl[:, None, :]
        else:
            Kin = Kraw + params.get("noise", noise0) * eye_bl
        L = cholesky_bl(Kin)
        rhs = torch.cat([Kcross[:, None, :], y_bl], dim=1)
        Z = tri_solve_fwd_bl(L, rhs)  # (n, 1+r, B) = L^{-1}[Kc, Y]
        zc, zy = Z[:, 0, :], Z[:, 1:, :]
        mean = torch.einsum("nb,nrb->rb", zc, zy)  # Kc^T Kin^{-1} Y
        var = 1.0 - torch.einsum("nb,nb->b", zc, zc)
        if loss == "mse":
            return -mse_fn(mean, t_bl)
        if loss == "huber":
            return -pseudo_huber_fn(mean, t_bl, boundary_scale=boundary_scale)
        if noise_is_free:
            zy0 = tri_solve_fwd_bl(cholesky_bl(Kraw + noise0 * eye_bl), y_bl)
        else:
            zy0 = zy
        scale = torch.sum(zy0 * zy0) / (B * n)  # analytic sigma^2
        # the losses take (B, r) predictions and (B,) variances
        if loss == "looph":
            return -looph_fn(mean.T, t_bl.T, var, scale,
                             boundary_scale=boundary_scale)
        return -lool_fn(mean.T, t_bl.T, var, scale)

    return obj_fn, names


def _batched_objective(muygps, batch_targets, batch_nn_targets,
                       crosswise_dists, pairwise_dists, loss, boundary_scale,
                       dev, kfn, nu0, batch_features=None):
    """``obj_fn`` of the batched layout: the JAX package's batched branch,
    operation for operation."""
    kernel = muygps.kernel
    names, _, _ = muygps.get_opt_params()
    pw = torch.as_tensor(pairwise_dists, device=dev)
    dtype = pw.dtype
    cw = torch.as_tensor(crosswise_dists, dtype=dtype, device=dev)
    y = torch.as_tensor(batch_nn_targets, dtype=dtype, device=dev)
    t = torch.as_tensor(batch_targets, dtype=dtype, device=dev)
    if y.ndim == 2:
        y = y[:, :, None]  # (B, n, r)
    if t.ndim == 1:
        t = t[:, None]  # (B, r)
    B, n = pw.shape[0], pw.shape[1]
    metric_name = kernel.deformation.metric.name
    ls_param = kernel.deformation.length_scale
    field = _hierarchical_field(muygps, batch_features, pw)
    if isinstance(kernel.deformation, Anisotropy):
        d_feat = len(ls_param)
        if pw.ndim != 4 or pw.shape[-1] != d_feat:
            raise ValueError(
                "anisotropic objectives expect per-feature difference "
                f"tensors (B, n, n, {d_feat}); got {tuple(pw.shape)}"
            )
        ls_names = [p.name() for p in ls_param]
        ls0 = [p() for p in ls_param]

        def scaled_dists(params):
            ls = torch.stack([
                torch.as_tensor(params.get(nm, v), dtype=dtype, device=dev)
                for nm, v in zip(ls_names, ls0)
            ])
            u_p = torch.sum((pw / ls) ** 2, dim=3)
            u_c = torch.sum((cw / ls) ** 2, dim=2)
            if metric_name == "l2":
                return safe_sqrt(u_p), safe_sqrt(u_c)
            return u_p, u_c

    elif field is not None:
        apply_ls = kernel.deformation.metric.apply_length_scale

        def scaled_dists(params):
            ls_b = field(params)  # (B,) nonstationary field
            return (apply_ls(pw, ls_b[:, None, None]),
                    apply_ls(cw, ls_b[:, None]))

    else:
        if pw.ndim != 3:
            raise ValueError(
                f"isotropic objectives expect distances (B, n, n); got "
                f"{tuple(pw.shape)}"
            )
        apply_ls = kernel.deformation.metric.apply_length_scale

        def scaled_dists(params):
            ls = params.get("length_scale", ls_param())
            return apply_ls(pw, ls), apply_ls(cw, ls)

    eye = torch.eye(n, dtype=dtype, device=dev)[None]  # (1, n, n)
    if isinstance(muygps.noise, HeteroscedasticNoise):
        eps = torch.as_tensor(muygps.noise(), dtype=dtype, device=dev)
        noise0, noise_is_free = None, False
    else:
        noise0 = float(muygps.noise())
        noise_is_free = "noise" in names

    def tri_fwd(L, R):
        return torch.linalg.solve_triangular(L, R, upper=False)

    def obj_fn(params):
        nu = params.get("smoothness", nu0)
        u_p, u_c = scaled_dists(params)
        Kraw = kfn(u_p, nu)
        Kcross = kfn(u_c, nu)  # (B, n)
        if noise0 is None:
            Kin = Kraw + eye * eps[:, None, :]
        else:
            Kin = Kraw + params.get("noise", noise0) * eye
        L = _solve.cholesky(Kin)
        Z = tri_fwd(L, torch.cat([Kcross[:, :, None], y], dim=2))
        zc, zy = Z[:, :, 0], Z[:, :, 1:]  # L^{-1} Kcross, L^{-1} Y
        mean = torch.einsum("bn,bnr->br", zc, zy)
        var = 1.0 - torch.einsum("bn,bn->b", zc, zc)
        if loss == "mse":
            return -torch.sum((mean - t) ** 2) / t.numel()
        if loss == "huber":
            bs2 = boundary_scale**2
            return -bs2 * torch.sum(
                torch.sqrt(1.0 + (mean - t) ** 2 / bs2) - 1.0
            )
        if noise_is_free:
            zy0 = tri_fwd(_solve.cholesky(Kraw + noise0 * eye), y)
        else:
            zy0 = zy
        scale = torch.sum(zy0 * zy0) / (B * n)  # analytic sigma^2
        sv = torch.clamp_min(scale * var, 10.0 * torch.finfo(var.dtype).eps)
        sv_b = sv[:, None]
        sq = (mean - t) ** 2
        if loss == "looph":
            bs2 = boundary_scale**2
            return -torch.sum(
                2.0 * bs2 * (torch.sqrt(1.0 + sq / (bs2 * sv_b)) - 1.0)
                + torch.log(sv_b)
            )
        return -torch.sum(sq / sv_b + torch.log(sv_b))

    return obj_fn
