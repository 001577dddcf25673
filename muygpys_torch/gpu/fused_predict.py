"""K1 and K1b: fused posterior solves, CUDA kernel wrappers and their plain
PyTorch versions.

Counterpart of :mod:`muygpys_tpu.pallas.fused_predict`.
:func:`fused_predict_coords_bl` (K1): from neighbor *coordinates* the kernel
(``csrc/fused_predict.cu``) computes per-feature length-scaled distances, the
Matern/RBF kernel, the nugget, and eliminates the augmented ``[K | kc | y]``
in place (no pivot floor, like the TPU kernel) to read off the posterior
mean and variance.  :func:`fused_predict_bl` (K1b) does the same from
pre-assembled *distance* tensors.  Each has two designs, picked by
:func:`k1_design` (a warp per query eliminating in registers for
``n <= 32`` and ``r <= 4``, else in shared memory); both register designs
run one elimination, ``regs_solve_and_emit`` in ``csrc/fused_predict.cu``.
Hyperparameters are runtime inputs, so
one build serves every trained model; with ``smoothness="gen"`` so is the
Matern smoothness, through a coefficient vector of
:func:`muygpys_torch.gpu.matern_nu.matern_nu_coeffs` (K4, ``matern_nu.cuh``).

The layout at the public functions is the JAX package's (batch last), so the
tests compare like with like.
"""

from __future__ import annotations

import ctypes
import math

import torch

from muygpys_torch import config
from muygpys_torch.gpu import _build
from muygpys_torch.gpu import matern_nu as _nu
from muygpys_torch.ops import kernels as _k

_COORDS_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
)
#: the register design's bounds (``csrc/fused_predict.cu``)
REGISTER_MAX_N = 32
REGISTER_MAX_R = 4
_DISTS_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
)


def serve_tail_terms(dtype) -> int:
    """Tail Chebyshev terms K1 and K1b evaluate: f32 serving trims the series
    to 28 (truncation <= 1.7e-8 absolute on phi across nu in [0.05, 10], two
    orders below the f32 serving budget); f64 keeps all of it."""
    return _nu.TAIL_TERMS_SERVE_F32 if dtype == torch.float32 else _nu.NTAIL


def _kernel_value(u, smoothness, gen_coeffs=None):
    if smoothness == "gen":
        # u is the ls-scaled l2 distance; t = sqrt(2 nu) u, sqrt(2 nu) in
        # slot 0 of the coefficient vector
        co = torch.as_tensor(gen_coeffs, dtype=u.dtype, device=u.device)
        return _nu.matern_nu_eval(
            co[0] * u, co, tail_terms=serve_tail_terms(u.dtype)
        )
    if smoothness == "rbf":
        return _k.rbf_fn(u)  # u is the F2 distance scaled by 1/ls^2
    return {
        0.5: _k.matern_05_fn,
        1.5: _k.matern_15_fn,
        2.5: _k.matern_25_fn,
        math.inf: _k.matern_inf_fn,
    }[smoothness](u)


def _solve_and_emit(K, kc, y):
    """Eliminate the augmented ``[K | kc | y]`` in the TPU kernel's order
    (one rsqrt per pivot, no pivot floor); mean ``(r, B)``, var ``(B,)``."""
    n = K.shape[0]
    work = torch.cat([K, kc[:, None, :], y], dim=1)  # (n, n + 1 + r, B)
    for j in range(n):
        inv = torch.rsqrt(work[j, j, :])
        rowj = work[j, j:, :] * inv[None, :]
        work[j, j:, :] = rowj
        if j < n - 1:
            lcol = work[j + 1:, j, :] * inv[None, :]
            work[j + 1:, j:, :] = (
                work[j + 1:, j:, :] - lcol[:, None, :] * rowj[None, :, :]
            )
    zc = work[:, n, :]
    zy = work[:, n + 1:, :]
    return torch.sum(zc[:, None, :] * zy, dim=0), 1.0 - torch.sum(zc * zc, dim=0)


def fused_predict_coords_bl_plain(
    nf, q, y, params, noise_nn=None, gen_coeffs=None, smoothness=1.5,
    metric_power=1,
):
    """Plain PyTorch version of K1, in the TPU kernel's elimination order.

    ``nf (n, d, B)``, ``q (d, B)``, ``y (n, r, B)``,
    ``params = [ls_0..ls_{d-1}, noise]``, optional ``noise_nn (n, B)``,
    ``gen_coeffs`` under ``smoothness="gen"``.
    Returns mean ``(r, B)`` and variance ``(B,)``.
    """
    _nu.check_smoothness(
        "fused_predict_coords_bl", smoothness, gen_coeffs, metric_power,
        _nu._LEN_VAL,
    )
    n, d, _ = nf.shape
    acc_p = acc_c = 0.0
    for f in range(d):
        inv = 1.0 / params[f]
        xf = nf[:, f, :] * inv  # (n, B)
        qf = q[f][None, :] * inv
        dp = xf[:, None, :] - xf[None, :, :]  # (n, n, B)
        dc = xf - qf
        acc_p = acc_p + dp * dp
        acc_c = acc_c + dc * dc
    if metric_power == 1:
        acc_p, acc_c = torch.sqrt(acc_p), torch.sqrt(acc_c)
    eye = torch.eye(n, dtype=nf.dtype, device=nf.device)[:, :, None]
    K = _kernel_value(acc_p, smoothness, gen_coeffs)
    if noise_nn is not None:
        K = K + eye * noise_nn[:, None, :]
    else:
        K = K + params[d] * eye
    kc = _kernel_value(acc_c, smoothness, gen_coeffs)
    return _solve_and_emit(K, kc, y)


def fused_predict_bl_plain(
    pw, cw, y, params, gen_coeffs=None, smoothness=1.5, metric_power=1
):
    """Plain PyTorch version of K1b.  ``pw (n, n, B)``, ``cw (n, B)``,
    ``y (n, r, B)``, ``params = [length_scale, noise]``.  Returns mean
    ``(r, B)`` and variance ``(B,)``."""
    _nu.check_smoothness(
        "fused_predict_bl", smoothness, gen_coeffs, metric_power,
        _nu._LEN_VAL,
    )
    n = pw.shape[0]
    ls, noise = params[0], params[1]
    inv = 1.0 / ls if metric_power == 1 else 1.0 / (ls * ls)
    eye = torch.eye(n, dtype=pw.dtype, device=pw.device)[:, :, None]
    K = _kernel_value(pw * inv, smoothness, gen_coeffs) + noise * eye
    kc = _kernel_value(cw * inv, smoothness, gen_coeffs)
    return _solve_and_emit(K, kc, y)


def k1_design(n, r, dtype, smoothness=1.5) -> str:
    """The design a K1 or K1b launch takes: ``"registers"`` (one lane per
    row of the augmented matrix, eliminated in registers) for ``n <= 32``
    and ``r <= 4`` in f32 and f64, every closed form, RBF and ``"gen"``;
    else ``"shared"`` (the matrix in shared memory)."""
    if isinstance(smoothness, torch.Tensor) or (
        smoothness not in _nu.SMOOTHNESS_CODES
    ):
        raise ValueError(f"k1_design: no kernel takes smoothness {smoothness!r}")
    if (
        dtype in (torch.float32, torch.float64)
        and 1 <= n <= REGISTER_MAX_N and 1 <= r <= REGISTER_MAX_R
    ):
        return "registers"
    return "shared"


def _symbol(name, dtype):
    return f"{name}_f32" if dtype == torch.float32 else f"{name}_f64"


def _launch(nf, q, y, params, noise_nn, gen, code, metric_power,
            smoothness=1.5, design=None):
    """One K1 launch on contiguous CUDA tensors of checked shapes: the
    design of :func:`k1_design`, or ``design`` where a caller compares the
    two (the kernel refuses a register launch outside its bounds).
    Returns mean ``(r, B)`` and var ``(B,)``."""
    n, d, B = nf.shape
    r = y.shape[1]
    dtype, dev = nf.dtype, nf.device
    design = design or k1_design(n, r, dtype, smoothness)
    mean = torch.empty((r, B), dtype=dtype, device=dev)
    var = torch.empty((B,), dtype=dtype, device=dev)
    fn = _build.function(
        "fused_predict", _symbol("fused_predict_coords", dtype),
        _COORDS_ARGTYPES,
    )
    with _build.on_device(dev):
        rc = fn(
            *(_build.ptr(t) for t in (nf, q, y, params, noise_nn, gen)),
            _build.ptr(mean), _build.ptr(var), n, d, r, B, code,
            metric_power, serve_tail_terms(dtype),
            int(design == "registers"), _build.stream(dev),
        )
    _build.check(rc, "fused_predict", "fused_predict_coords")
    _build.count("fused_predict_coords", f"fused_predict_coords/{design}")
    if smoothness == "gen":
        _build.count("fused_predict_coords/gen")
    return mean, var


def _gen_on_device(gen_coeffs, dtype, dev):
    """The value part of the coefficient vector, contiguous on ``dev``."""
    if gen_coeffs is None:
        return None
    return torch.as_tensor(gen_coeffs, dtype=dtype, device=dev)[
        :_nu._LEN_VAL
    ].contiguous()


def fused_predict_coords_bl(
    nf, q, y, params, noise_nn=None, gen_coeffs=None, smoothness=1.5,
    metric_power=1, device=None,
):
    """Posterior (mean, var) streaming neighbor coordinates through K1.

    ``nf (n, d, B)`` neighbor features, ``q (d, B)`` queries,
    ``y (n, B)`` or ``(n, r, B)`` neighbor targets,
    ``params = [ls_0..ls_{d-1}, noise]`` (replicate a scalar length scale
    for isotropy), optional ``noise_nn (n, B)`` per-neighbor nugget that
    replaces the scalar noise.  ``metric_power`` 1 = l2, 2 = F2;
    ``smoothness`` in {0.5, 1.5, 2.5, inf, "rbf", "gen"}; ``"gen"`` takes a
    :func:`muygpys_torch.gpu.matern_nu.matern_nu_coeffs` vector in
    ``gen_coeffs`` (a runtime input: any smoothness, one build) and requires
    ``metric_power == 1``.  Unit prior variance.

    Runs on ``device`` (default ``"cuda"``): the kernel there (the design
    of :func:`k1_design`), the plain version for ``device="cpu"``.  Returns
    mean ``(r, B)``, var ``(B,)``.
    """
    dev = config.device(device)
    code = _nu.check_smoothness(
        "fused_predict_coords_bl", smoothness, gen_coeffs, metric_power,
        _nu._LEN_VAL,
    )
    nf = torch.as_tensor(nf, device=dev)
    dtype = nf.dtype
    q = torch.as_tensor(q, dtype=dtype, device=dev)
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    if y.ndim == 2:
        y = y[:, None, :]
    params = torch.as_tensor(params, dtype=dtype, device=dev)
    if noise_nn is not None:
        noise_nn = torch.as_tensor(noise_nn, dtype=dtype, device=dev)
    n, d, B = nf.shape
    r = y.shape[1]
    if (
        q.shape != (d, B) or y.shape != (n, r, B) or params.shape != (d + 1,)
        or (noise_nn is not None and noise_nn.shape != (n, B))
    ):
        raise ValueError(
            f"fused_predict_coords_bl shapes: nf {tuple(nf.shape)}, q "
            f"{tuple(q.shape)}, y {tuple(y.shape)}, params "
            f"{tuple(params.shape)}"
        )
    if dev.type == "cpu":
        return fused_predict_coords_bl_plain(
            nf, q, y, params, noise_nn, gen_coeffs, smoothness, metric_power
        )
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused_predict_coords_bl takes f32 or f64, not {dtype}")
    nf, q, y, params = (t.contiguous() for t in (nf, q, y, params))
    noise_nn = None if noise_nn is None else noise_nn.contiguous()
    return _launch(
        nf, q, y, params, noise_nn, _gen_on_device(gen_coeffs, dtype, dev),
        code, metric_power, smoothness,
    )


def fused_predict_bl(
    pw, cw, y, params, gen_coeffs=None, smoothness=1.5, metric_power=1,
    device=None,
):
    """Posterior (mean, var) from batch-last distance tensors through K1b.

    ``pw (n, n, B)`` pairwise and ``cw (n, B)`` crosswise distances (l2, or
    F2 with ``metric_power=2``), ``y (n, B)`` or ``(n, r, B)``,
    ``params = [length_scale, noise]``; ``smoothness`` and ``gen_coeffs`` as
    :func:`fused_predict_coords_bl`.  Unit prior variance.

    Runs on ``device`` (default ``"cuda"``): the kernel there (the design
    of :func:`k1_design`), the plain version for ``device="cpu"``.  Returns
    mean ``(r, B)``, var ``(B,)``.
    """
    dev = config.device(device)
    code = _nu.check_smoothness(
        "fused_predict_bl", smoothness, gen_coeffs, metric_power, _nu._LEN_VAL
    )
    pw = torch.as_tensor(pw, device=dev)
    dtype = pw.dtype
    cw, y, params = (
        torch.as_tensor(t, dtype=dtype, device=dev) for t in (cw, y, params)
    )
    if y.ndim == 2:
        y = y[:, None, :]
    n, B = pw.shape[0], pw.shape[-1]
    r = y.shape[1]
    if (
        pw.shape != (n, n, B) or cw.shape != (n, B) or y.shape != (n, r, B)
        or params.shape != (2,)
    ):
        raise ValueError(
            f"fused_predict_bl shapes: pw {tuple(pw.shape)}, cw "
            f"{tuple(cw.shape)}, y {tuple(y.shape)}, params "
            f"{tuple(params.shape)}"
        )
    if dev.type == "cpu":
        return fused_predict_bl_plain(
            pw, cw, y, params, gen_coeffs, smoothness, metric_power
        )
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused_predict_bl takes f32 or f64, not {dtype}")
    pw, cw, y, params = (t.contiguous() for t in (pw, cw, y, params))
    return _launch_dists(
        pw, cw, y, params, _gen_on_device(gen_coeffs, dtype, dev), code,
        metric_power, smoothness,
    )


def _launch_dists(pw, cw, y, params, gen, code, metric_power, smoothness=1.5,
                  design=None):
    """One K1b launch on contiguous CUDA tensors of checked shapes: the
    design of :func:`k1_design`, or ``design`` where a caller compares the
    two (the kernel refuses a register launch outside its bounds).
    Returns mean ``(r, B)`` and var ``(B,)``."""
    n, r, B = y.shape
    dtype, dev = pw.dtype, pw.device
    design = design or k1_design(n, r, dtype, smoothness)
    mean = torch.empty((r, B), dtype=dtype, device=dev)
    var = torch.empty((B,), dtype=dtype, device=dev)
    fn = _build.function(
        "fused_predict", _symbol("fused_predict", dtype), _DISTS_ARGTYPES
    )
    with _build.on_device(dev):
        rc = fn(
            *(_build.ptr(t) for t in (pw, cw, y, params, gen, mean, var)),
            n, r, B, code, metric_power, serve_tail_terms(dtype),
            int(design == "registers"), _build.stream(dev),
        )
    _build.check(rc, "fused_predict", "fused_predict")
    _build.count("fused_predict", f"fused_predict/{design}")
    return mean, var
