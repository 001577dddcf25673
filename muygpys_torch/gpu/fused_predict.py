"""K1: fused coordinate-streaming posterior solve, CUDA kernel wrapper and
its plain PyTorch version.

Counterpart of ``muygpys_tpu.pallas.fused_predict.fused_predict_coords_bl``:
from neighbor *coordinates* the kernel (``csrc/fused_predict.cu``) computes
per-feature length-scaled distances, the Matern/RBF kernel, the nugget, and
eliminates the augmented ``[K | kc | y]`` in place (no pivot floor, like the
TPU kernel) to read off the posterior mean and variance.  Hyperparameters
are runtime inputs, so one build serves every trained model.

The layout at this public function is the JAX package's (batch last), so the
tests compare like with like.  The distance-input variant
``fused_predict_bl`` and general smoothness (``"gen"``) are not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

from muygpys_torch import config
from muygpys_torch.gpu import _build
from muygpys_torch.ops import kernels as _k

_SMOOTHNESS_CODES = {0.5: 0, 1.5: 1, 2.5: 2, math.inf: 3, "rbf": 4}

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _smoothness_code(smoothness) -> int:
    if smoothness not in _SMOOTHNESS_CODES:
        raise ValueError(
            f"fused_predict_coords_bl supports smoothness 0.5/1.5/2.5/inf/"
            f"'rbf'; got {smoothness!r} (general smoothness is not ported "
            "yet)"
        )
    return _SMOOTHNESS_CODES[smoothness]


def _kernel_value(u, smoothness):
    if smoothness == "rbf":
        return _k.rbf_fn(u)  # u is the F2 distance scaled by 1/ls^2
    return {
        0.5: _k.matern_05_fn,
        1.5: _k.matern_15_fn,
        2.5: _k.matern_25_fn,
        math.inf: _k.matern_inf_fn,
    }[smoothness](u)


def fused_predict_coords_bl_plain(
    nf, q, y, params, noise_nn=None, smoothness=1.5, metric_power=1
):
    """Plain PyTorch version of K1, in the TPU kernel's elimination order.

    ``nf (n, d, B)``, ``q (d, B)``, ``y (n, r, B)``,
    ``params = [ls_0..ls_{d-1}, noise]``, optional ``noise_nn (n, B)``.
    Returns mean ``(r, B)`` and variance ``(B,)``.
    """
    _smoothness_code(smoothness)
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
    K = _kernel_value(acc_p, smoothness)
    if noise_nn is not None:
        K = K + eye * noise_nn[:, None, :]
    else:
        K = K + params[d] * eye
    kc = _kernel_value(acc_c, smoothness)
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


def fused_predict_coords_bl(
    nf, q, y, params, noise_nn=None, smoothness=1.5, metric_power=1,
    device=None,
):
    """Posterior (mean, var) streaming neighbor coordinates through K1.

    ``nf (n, d, B)`` neighbor features, ``q (d, B)`` queries,
    ``y (n, B)`` or ``(n, r, B)`` neighbor targets,
    ``params = [ls_0..ls_{d-1}, noise]`` (replicate a scalar length scale
    for isotropy), optional ``noise_nn (n, B)`` per-neighbor nugget that
    replaces the scalar noise.  ``metric_power`` 1 = l2, 2 = F2;
    ``smoothness`` in {0.5, 1.5, 2.5, inf, "rbf"}.  Unit prior variance.

    Runs on ``device`` (default ``"cuda"``): the kernel there, the plain
    version for ``device="cpu"``.  Returns mean ``(r, B)``, var ``(B,)``.
    """
    dev = config.device(device)
    code = _smoothness_code(smoothness)
    if metric_power not in (1, 2):
        raise ValueError(f"metric_power must be 1 or 2, got {metric_power}")
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
            nf, q, y, params, noise_nn, smoothness, metric_power
        )
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused_predict_coords_bl takes f32 or f64, not {dtype}")
    ins = [t.contiguous() for t in (nf, q, y, params)]
    noise_nn = None if noise_nn is None else noise_nn.contiguous()
    mean = torch.empty((r, B), dtype=dtype, device=dev)
    var = torch.empty((B,), dtype=dtype, device=dev)
    symbol = (
        "fused_predict_coords_f32" if dtype == torch.float32
        else "fused_predict_coords_f64"
    )
    fn = _build.function("fused_predict", symbol, _ARGTYPES)
    rc = fn(
        *(_build.ptr(t) for t in ins), _build.ptr(noise_nn),
        _build.ptr(mean), _build.ptr(var),
        n, d, r, B, code, metric_power, _build.stream(dev),
    )
    _build.check(rc, "fused_predict", "fused_predict_coords")
    _build.launches["fused_predict_coords"] += 1
    return mean, var
