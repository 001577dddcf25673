"""K2: fused LOO statistics with analytic derivatives, CUDA kernel wrapper,
its plain PyTorch version, the epilogue and the autograd form.

Counterpart of :mod:`muygpys_tpu.pallas.fused_train`.  From the batch-last
training tensors the kernel (``csrc/fused_train.cu``) computes, per batch
point, the LOO value rows (mean, var, q) and their analytic derivatives with
respect to the length scales, the noise and (under ``smoothness="gen"`` with
``smoothness_free``) the Matern smoothness, through the quadratic-form
identities (with ``a = Kin^{-1} kc`` and ``b = Kin^{-1} y``):

    mean  = kc^T b          dmean = dkc^T b - a^T dK b
    var   = 1 - kc^T a      dvar  = -2 dkc^T a + a^T dK a
    q     = sum_r y^T b     dq    = -sum_r b^T dK b

with sigma^2 under the model's stored noise (a second factorization when
the noise is free; d sigma^2 / d noise = 0), exactly as the TPU kernel.
A host epilogue turns the rows into the scalar objective and its gradient
(:func:`_epilogue`), and :class:`FusedLOO` makes one kernel launch plus the
epilogue a ``torch.autograd.Function`` whose backward is ``grad_out`` times
the stored analytic gradient — the counterpart of the ``jax.custom_vjp``
of ``optimize/device_chassis.py``.  The objective of a model and a training
batch is assembled in :mod:`muygpys_torch.optimize.fused_objective`; this
module knows no model class.

The layout at the public functions is the JAX package's (batch last).
General smoothness rides the traced-nu surrogate K4
(:mod:`muygpys_torch.gpu.matern_nu`, ``csrc/matern_nu.cuh``): the
coefficient vector is a runtime input, so the smoothness changes between
optimizer steps without a rebuild.  ``train_tile_cap`` is a TPU VMEM rule
with no counterpart here: the launcher sizes a block from its shared memory.

K2 has two hand-written designs (``csrc/fused_train.cu``), chosen by shape
(:func:`train_design`): the register design for ``n <= 32`` and ``r <= 4``
(each point's rows in registers, right-looking elimination), the
shared-memory design for the rest; a shape whose one point does not fit a
block's shared memory in either is refused.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from muygpys_torch import config
from muygpys_torch.gpu import _build
from muygpys_torch.gpu import matern_nu as _nu
from muygpys_torch.ops.lanes_solver import (
    cholesky_bl,
    tri_solve_bwd_bl,
    tri_solve_fwd_bl,
)

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]

#: shared memory one block can use on an H100 (bytes)
MAX_SHARED_BYTES = 232448
#: the register design's compile-time bounds: one lane per row, and the
#: right-hand-side counts it is compiled for
REGS_MAX_N = 32
_REGS_RHS = (1, 2, 4)


def train_shared_bytes(design, n, r, d_feat, smoothness_free, dtype, ncoef=0):
    """Shared memory of a one-point block of ``design`` ("registers" or
    "shared"), as ``csrc/fused_train.cu`` counts it: the point's elements
    (``regs_point_elems`` or ``point_elems``) plus the block's length-scale
    coefficients and the staged K4 vector."""
    size = dtype.itemsize
    dd = d_feat if d_feat else 1
    ld = n | 1
    if design == "registers":
        R = next(c for c in _REGS_RHS if c >= r)
        vw = 16 // size
        rb = 32 + (1 + R + vw - 1) // vw * vw
        elems = (2 * rb + (1 + 2 * R) * 32 + n * 33 + dd * n * ld + dd * n
                 + R * n + n)
        elems = (elems + 3) // 4 * 4
    else:
        nu = int(smoothness_free)
        elems = n * ld * (dd + 1 + nu) + n * (3 + dd + 1 + 2 * r + nu)
    return size * (elems + 2 * dd + ncoef)


@functools.lru_cache(maxsize=None)
def train_design(n, r, d_feat, smoothness_free, dtype, ncoef=0) -> str:
    """The K2 design the launcher takes for a shape: "registers" when
    ``n <= 32``, ``r <= 4`` and one point fits a block, else "shared" when
    one point fits; raises ``ValueError`` when neither takes it (cached: a
    training run asks once per evaluation for the same shape)."""
    args = (n, r, d_feat, smoothness_free, dtype, ncoef)
    if (n <= REGS_MAX_N and r <= _REGS_RHS[-1]
            and train_shared_bytes("registers", *args) <= MAX_SHARED_BYTES):
        return "registers"
    need = train_shared_bytes("shared", *args)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"fused_train_stats: one point (n={n}, r={r}, d_feat={d_feat}) "
            f"takes {need} bytes of shared memory in {dtype}, over the "
            f"{MAX_SHARED_BYTES} a block can use"
        )
    return "shared"


def _smoothness_code(
    smoothness, gen_coeffs, metric_power, smoothness_free: bool
) -> int:
    """K2's smoothness code; raises on what it does not take."""
    if smoothness_free and smoothness != "gen":
        raise ValueError(
            'smoothness_free requires smoothness="gen" (closed forms are '
            "fixed-order by construction)"
        )
    return _nu.check_smoothness(
        "fused_train_stats_bl", smoothness, gen_coeffs, metric_power,
        _nu._LEN_DNU if smoothness_free else _nu._LEN_DT,
    )


def train_tail_terms(dtype) -> int:
    """Tail Chebyshev terms K2 evaluates: f32 training trims the series to 24
    (~2e-5 on phi, far inside gradient tolerances); f64 keeps all of it."""
    return _nu.TAIL_TERMS_TRAIN_F32 if dtype == torch.float32 else _nu.NTAIL


def _kernel_and_deriv(u, smoothness, gen_coeffs=None, need_dnu=False):
    """Returns (K(u), H(u) = u dK/du[, dK/dnu]) elementwise.

    ``"gen"`` evaluates the traced-nu surrogate: ``t = sqrt(2 nu) u`` with
    the factor in ``gen_coeffs[0]``; the full dK/dnu at fixed u folds the
    argument chain ``dt/dnu = t / (2 nu)`` (``gen_coeffs[4] = 1 / (2 nu)``)
    into the partial from the nu-tangent coefficient sets."""
    if smoothness == "gen":
        co = torch.as_tensor(gen_coeffs, dtype=u.dtype, device=u.device)
        t = co[0] * u
        out = _nu.matern_nu_eval(
            t, co, need_dt=True, need_dnu=need_dnu,
            tail_terms=train_tail_terms(u.dtype),
        )
        H = t * out[1]
        if need_dnu:
            return out[0], H, out[2] + co[4] * H
        return out[0], H
    if smoothness == 0.5:
        e = torch.exp(-u)
        return e, -u * e
    if smoothness == 1.5:
        e = torch.exp(-u * _SQRT3)
        return (1.0 + _SQRT3 * u) * e, -3.0 * u * u * e
    if smoothness == 2.5:
        e = torch.exp(-u * _SQRT5)
        t = _SQRT5 * u
        return (1.0 + t + t * t / 3.0) * e, -(5.0 / 3.0) * u * u * (1.0 + t) * e
    if smoothness == math.inf:
        e = torch.exp(-(u * u) / 2.0)
        return e, -u * u * e
    e = torch.exp(-u / 2.0)  # "rbf": u is the F2 distance scaled by 1/ls^2
    return e, -0.5 * u * e


def _matvec_bl(G, x):
    """w = G x per lane, x (n, B) -> (n, B); G symmetric (n, n, B)."""
    return torch.sum(G * x[:, None, :], dim=0)


def fused_train_stats_bl_plain(
    pw, cw, y, params, noise_nn=None, gen_coeffs=None, smoothness=1.5,
    metric_power=1, noise_free=False, smoothness_free=False, d_feat=0,
):
    """Plain PyTorch version of K2, in the TPU kernel's order (the same
    floored factorization of :func:`muygpys_torch.ops.lanes_solver.cholesky_bl`,
    substitutions and contractions).  Arguments as
    :func:`fused_train_stats_bl`; returns ``(C, B)``."""
    _smoothness_code(smoothness, gen_coeffs, metric_power, smoothness_free)
    n = pw.shape[0]
    r = y.shape[1]
    d_eff = d_feat if d_feat else 1
    if d_feat:
        accp = accc = 0.0
        wps, wcs = [], []
        for f in range(d_feat):
            invf = 1.0 / params[f]
            dpf = pw[:, :, f, :] * invf
            dcf = cw[:, f, :] * invf
            wps.append(dpf * dpf)
            wcs.append(dcf * dcf)
            accp = accp + wps[-1]
            accc = accc + wcs[-1]
        u_p = torch.sqrt(accp) if metric_power == 1 else accp
        u_c = torch.sqrt(accc) if metric_power == 1 else accc
    else:
        ls = params[0]
        inv = 1.0 / ls if metric_power == 1 else 1.0 / (ls * ls)
        u_p = pw * inv
        u_c = cw * inv
    if smoothness_free:
        K, H, S = _kernel_and_deriv(u_p, smoothness, gen_coeffs, True)
        kc, Hc, Sc = _kernel_and_deriv(u_c, smoothness, gen_coeffs, True)
    else:
        K, H = _kernel_and_deriv(u_p, smoothness, gen_coeffs)
        kc, Hc = _kernel_and_deriv(u_c, smoothness, gen_coeffs)
    if d_feat:
        tiny = torch.finfo(y.dtype).tiny
        fp = torch.clamp_min(accp, tiny)
        fc = torch.clamp_min(accc, tiny)
        Gs = [(-metric_power / params[f]) * H * (wps[f] / fp)
              for f in range(d_feat)]
        gcs = [(-metric_power / params[f]) * Hc * (wcs[f] / fc)
               for f in range(d_feat)]
    else:
        gcoef = -metric_power / params[0]
        Gs, gcs = [gcoef * H], [gcoef * Hc]

    eye = torch.eye(n, dtype=y.dtype, device=y.device)[:, :, None]
    if noise_nn is not None:
        nugget = eye * noise_nn[:, None, :]
    else:
        nugget = params[d_eff] * eye
    L = cholesky_bl(K + nugget)
    Z = tri_solve_fwd_bl(L, torch.cat([kc[:, None, :], y], dim=1))
    X = tri_solve_bwd_bl(L, Z)
    a, b = X[:, 0, :], X[:, 1:, :]
    zc, zy = Z[:, 0, :], Z[:, 1:, :]
    mean = torch.sum(zc[:, None, :] * zy, dim=0)  # (r, B)
    var = 1.0 - torch.sum(zc * zc, dim=0)
    if noise_free:
        # sigma^2 under the model's STORED noise (reference quirk)
        L0 = cholesky_bl(K + params[d_eff + 1] * eye)
        Zy0 = tri_solve_fwd_bl(L0, y)
        b0 = tri_solve_bwd_bl(L0, Zy0)
        q = torch.sum(Zy0 * Zy0, dim=(0, 1))
    else:
        b0 = b
        q = torch.sum(zy * zy, dim=(0, 1))
    rows = [mean, var[None, :], q[None, :]]

    def group_rows(G, gc):
        wa = _matvec_bl(G, a)
        dmL = (torch.sum(gc[:, None, :] * b, dim=0)
               - torch.sum(wa[:, None, :] * b, dim=0))
        dvL = -2.0 * torch.sum(gc * a, dim=0) + torch.sum(wa * a, dim=0)
        dqL = torch.zeros_like(q)
        for k in range(r):
            w0 = _matvec_bl(G, b0[:, k, :])
            dqL = dqL - torch.sum(w0 * b0[:, k, :], dim=0)
        return [dmL, dvL[None, :], dqL[None, :]]

    for G, gc in zip(Gs, gcs):
        rows += group_rows(G, gc)
    dmN = -torch.sum(a[:, None, :] * b, dim=0)
    dvN = torch.sum(a * a, dim=0)
    rows += [dmN, dvN[None, :]]
    if smoothness_free:
        # the same algebra as a length scale, with the dK/dnu fields
        rows += group_rows(S, Sc)
    return torch.cat(rows, dim=0)


def fused_train_stats_bl(
    pw, cw, y, params, noise_nn=None, gen_coeffs=None, smoothness=1.5,
    metric_power=1, noise_free=False, smoothness_free=False, d_feat=0,
    device=None,
):
    """Per-point LOO statistics and analytic derivative rows,
    ``((r+2) + G(r+2) + (r+1) [+ (r+2)], B)`` with ``G`` length-scale groups
    (1 isotropic, ``d_feat`` anisotropic); the optional tail is the d/dnu
    group under ``smoothness_free``.

    Isotropic (``d_feat=0``): distances ``pw (n, n, B)``, ``cw (n, B)``,
    ``params = [length_scale, noise, stored_noise]``.  Anisotropic
    (``d_feat=d``): per-feature differences ``pw (n, n, d, B)``,
    ``cw (n, d, B)``, ``params = [ls_0..ls_{d-1}, noise, stored_noise]``.
    ``y (n, r, B)``; optional ``noise_nn (n, B)`` heteroscedastic nugget
    (never free, so not with ``noise_free``).  ``metric_power`` 1 = l2,
    2 = F2.  ``smoothness="gen"`` takes a
    :func:`muygpys_torch.gpu.matern_nu.matern_nu_coeffs` vector in
    ``gen_coeffs`` (built with ``need_dnu=True`` when ``smoothness_free``)
    and requires the l2 metric.  Hyperparameters and coefficients are
    runtime values: one build serves every optimizer step.

    Runs on ``device`` (default ``"cuda"``): K2 there (the design of
    :func:`train_design`), the plain version for ``device="cpu"``.
    """
    dev = config.device(device)
    code = _smoothness_code(
        smoothness, gen_coeffs, metric_power, smoothness_free
    )
    if noise_nn is not None and noise_free:
        raise ValueError(
            "heteroscedastic nugget tensors are never free parameters"
        )
    pw = torch.as_tensor(pw, device=dev)
    dtype = pw.dtype
    cw = torch.as_tensor(cw, dtype=dtype, device=dev)
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    params = torch.as_tensor(params, dtype=dtype, device=dev)
    if noise_nn is not None:
        noise_nn = torch.as_tensor(noise_nn, dtype=dtype, device=dev)
    n, B = pw.shape[0], pw.shape[-1]
    r = y.shape[1] if y.ndim == 3 else 0
    d_eff = d_feat if d_feat else 1
    want_pw = (n, n, d_feat, B) if d_feat else (n, n, B)
    want_cw = (n, d_feat, B) if d_feat else (n, B)
    if (
        pw.shape != want_pw or cw.shape != want_cw
        or y.shape != (n, r, B) or r < 1
        or params.shape != (d_eff + 2,)
        or (noise_nn is not None and noise_nn.shape != (n, B))
    ):
        raise ValueError(
            f"fused_train_stats_bl shapes (d_feat={d_feat}): pw "
            f"{tuple(pw.shape)}, cw {tuple(cw.shape)}, y {tuple(y.shape)}, "
            f"params {tuple(params.shape)}"
        )
    if dev.type == "cpu":
        return fused_train_stats_bl_plain(
            pw, cw, y, params, noise_nn, gen_coeffs, smoothness,
            metric_power, noise_free, smoothness_free, d_feat,
        )
    return _launch(
        pw, cw, y, params, noise_nn, gen_coeffs, code, metric_power,
        noise_free, smoothness_free, d_feat,
    )


def _launch(
    pw, cw, y, params, noise_nn, gen_coeffs, code, metric_power, noise_free,
    smoothness_free, d_feat, design=None,
):
    """One K2 launch on CUDA tensors of checked shapes: the design of
    :func:`train_design`, or ``design`` where a caller compares the two
    (the kernel refuses a register launch outside its bounds).  Every
    objective evaluation of a training run comes through here, so it keeps
    its Python work short: the kernel is ~0.05 ms on an H100."""
    dtype = pw.dtype
    if dtype is not torch.float32 and dtype is not torch.float64:
        raise ValueError(f"fused_train_stats_bl takes f32 or f64, not {dtype}")
    n, B = pw.shape[0], pw.shape[-1]
    r = y.shape[1]
    gen = None
    if gen_coeffs is not None:
        gen = torch.as_tensor(gen_coeffs, dtype=dtype, device=pw.device)
        gen = gen.contiguous()
    ncoef = 0 if gen is None else gen.numel()
    if design is None:
        design = train_design(n, r, d_feat, smoothness_free, dtype, ncoef)
    pw, cw, y, params = (pw.contiguous(), cw.contiguous(), y.contiguous(),
                         params.contiguous())
    rows = (r + 2) * (2 + (d_feat or 1) + bool(smoothness_free)) - 1
    out = torch.empty((rows, B), dtype=dtype, device=pw.device)
    fn = _build.function(
        "fused_train", _SYMBOLS[dtype is torch.float64], _ARGTYPES
    )
    with _build.on_device(pw.device):
        rc = fn(
            pw.data_ptr(), cw.data_ptr(), y.data_ptr(), params.data_ptr(),
            None if noise_nn is None else noise_nn.contiguous().data_ptr(),
            None if gen is None else gen.data_ptr(), out.data_ptr(),
            n, d_feat, r, B, code, metric_power, int(noise_free),
            int(smoothness_free), ncoef, train_tail_terms(dtype),
            int(design == "registers"), _build.stream(pw.device),
        )
    _build.check(rc, "fused_train", "fused_train_stats")
    _build.count(*_COUNTS[design])
    return out


_SYMBOLS = ("fused_train_stats_f32", "fused_train_stats_f64")
_COUNTS = {d: ("fused_train_stats", f"fused_train_stats/{d}")
           for d in ("registers", "shared")}


def _epilogue(
    stats, t_bl, loss, free_names, n, boundary_scale=None,
    ls_keys=("length_scale",),
):
    """Scalar objective (-loss) and gradient dict from the per-point rows.

    All four losses take the SAME rows: the robust ones (pseudo-Huber
    ``"huber"``, leave-one-out pseudo-Huber ``"looph"``) differ from mse and
    lool by an elementwise Huber weight on the residual terms.  ``ls_keys``
    names the length-scale derivative groups in emission order."""
    if boundary_scale is None:
        boundary_scale = 3.0 if loss == "looph" else 1.5
    r, B = t_bl.shape
    G = len(ls_keys)
    mean, var, q = stats[0:r], stats[r], stats[r + 1]
    base = r + 2
    dmLs, dvLs, dqLs = [], [], []
    for j in range(G):
        o = base + j * (r + 2)
        dmLs.append(stats[o:o + r])
        dvLs.append(stats[o + r])
        dqLs.append(stats[o + r + 1])
    o = base + G * (r + 2)
    dmN, dvN = stats[o:o + r], stats[o + r]
    smoothness_free = "smoothness" in free_names
    if smoothness_free:
        o = o + r + 1
        dmS, dvS, dqS = stats[o:o + r], stats[o + r], stats[o + r + 1]

    e = mean - t_bl  # (r, B)
    grads = {}
    if loss == "mse":
        value = -torch.sum(e * e) / t_bl.numel()
        for key, dmL in zip(ls_keys, dmLs):
            if key in free_names:
                grads[key] = -2.0 * torch.sum(e * dmL) / t_bl.numel()
        if "noise" in free_names:
            grads["noise"] = -2.0 * torch.sum(e * dmN) / t_bl.numel()
        if smoothness_free:
            grads["smoothness"] = -2.0 * torch.sum(e * dmS) / t_bl.numel()
        return value, grads

    if loss == "huber":
        # unnormalized pseudo-Huber on the posterior mean
        bs2 = boundary_scale * boundary_scale
        rad = torch.sqrt(1.0 + (e * e) / bs2)
        value = -bs2 * torch.sum(rad - 1.0)
        for key, dmL in zip(ls_keys, dmLs):
            if key in free_names:
                grads[key] = -torch.sum(e * dmL / rad)
        if "noise" in free_names:
            grads["noise"] = -torch.sum(e * dmN / rad)
        if smoothness_free:
            grads["smoothness"] = -torch.sum(e * dmS / rad)
        return value, grads

    s = torch.sum(q) / (B * n)  # analytic sigma^2 (global)
    # the variance floor: where it is active the derivative of sv is zero
    floor = 10.0 * torch.finfo(var.dtype).eps
    raw_sv = s * var
    clamped = raw_sv < floor
    sv = torch.clamp_min(raw_sv, floor)

    if loss == "looph":
        bs2 = boundary_scale * boundary_scale
        rad = torch.sqrt(1.0 + (e * e) / (bs2 * sv[None, :]))
        value = -(2.0 * bs2 * torch.sum(rad - 1.0) + r * torch.sum(torch.log(sv)))

        def dloss(dm, dv, ds):
            dsv = torch.where(clamped, 0.0, ds * var + s * dv)
            return (
                torch.sum(2.0 * e * dm / (rad * sv[None, :]))
                - torch.sum((e * e) / rad * (dsv / (sv * sv))[None, :])
                + r * torch.sum(dsv / sv)
            )

    else:  # lool
        value = -(torch.sum(e * e / sv[None, :]) + r * torch.sum(torch.log(sv)))

        def dloss(dm, dv, ds):
            dsv = torch.where(clamped, 0.0, ds * var + s * dv)
            return (
                torch.sum(2.0 * e * dm / sv[None, :])
                - torch.sum((e * e) * (dsv / (sv * sv))[None, :])
                + r * torch.sum(dsv / sv)
            )

    for key, dmL, dvL, dqL in zip(ls_keys, dmLs, dvLs, dqLs):
        if key in free_names:
            grads[key] = -dloss(dmL, dvL, torch.sum(dqL) / (B * n))
    if "noise" in free_names:
        # d sigma^2 / d noise == 0 under the stored-noise quirk
        grads["noise"] = -dloss(dmN, dvN, torch.zeros((), dtype=var.dtype,
                                                      device=var.device))
    if smoothness_free:
        grads["smoothness"] = -dloss(dmS, dvS, torch.sum(dqS) / (B * n))
    return value, grads


class FusedLOO(torch.autograd.Function):
    """``value = objective(theta)`` by one K2 launch and the epilogue; the
    backward multiplies ``grad_out`` by the analytic gradient the forward
    stored (no reverse mode through the factorization)."""

    @staticmethod
    def forward(ctx, theta, evaluate):
        value, grad = evaluate(theta.detach())
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, grad_out):
        (grad,) = ctx.saved_tensors
        return grad_out * grad, None
