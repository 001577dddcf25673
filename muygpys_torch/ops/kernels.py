"""Scalar kernel functions, elementwise over distance tensors.

Counterpart of :mod:`muygpys_tpu.ops.kernels`.  RBF consumes *squared*
distances already scaled by ``1/l^2``; Matern consumes plain distances
already scaled by ``1/l``.  The general-order Matern (``matern_gen_fn``)
goes through the exact Bessel path of :mod:`muygpys_torch.ops.bessel` and
is differentiable in the smoothness.
"""

from __future__ import annotations

import math

import torch

from muygpys_torch.ops.bessel import kve

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


def rbf_fn(squared_dists: torch.Tensor) -> torch.Tensor:
    return torch.exp(-squared_dists / 2.0)


def matern_05_fn(dists: torch.Tensor) -> torch.Tensor:
    return torch.exp(-dists)


def matern_15_fn(dists: torch.Tensor) -> torch.Tensor:
    K = dists * _SQRT3
    return (1.0 + K) * torch.exp(-K)


def matern_25_fn(dists: torch.Tensor) -> torch.Tensor:
    K = dists * _SQRT5
    return (1.0 + K + K * K / 3.0) * torch.exp(-K)


def matern_inf_fn(dists: torch.Tensor) -> torch.Tensor:
    return torch.exp(-(dists**2) / 2.0)


def matern_gen_fn(dists: torch.Tensor, smoothness) -> torch.Tensor:
    """General-order Matern:
    ``k(d) = 2^{1-v}/Gamma(v) (sqrt(2v) d)^v K_v(sqrt(2v) d)``, ``k(0) = 1``.

    Computed through the exponentially scaled ``kve`` with the prefactor in
    log space: ``k = exp((1-v) ln 2 - lnGamma(v) + v ln t - t) kve(v, t)``.
    """
    dtype = dists.dtype
    v = torch.as_tensor(smoothness, dtype=dtype, device=dists.device)
    eps = 1e-12 if dtype == torch.float64 else 1e-6
    zero = dists <= 0.0
    d_safe = torch.where(zero, torch.full_like(dists, eps), dists)
    t = torch.sqrt(2.0 * v) * d_safe
    log_pref = (1.0 - v) * math.log(2.0) - torch.lgamma(v)
    val = torch.exp(log_pref + v * torch.log(t) - t) * kve(v, t)
    return torch.where(zero, torch.ones_like(val), val)
