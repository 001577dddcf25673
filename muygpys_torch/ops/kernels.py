"""Scalar kernel functions, elementwise over distance tensors.

Counterpart of :mod:`muygpys_tpu.ops.kernels` for the closed forms.  RBF
consumes *squared* distances already scaled by ``1/l^2``; Matern consumes
plain distances already scaled by ``1/l``.  The general-order Matern
(``matern_gen_fn``) waits for the general-smoothness slice.
"""

from __future__ import annotations

import torch

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
