"""Unconstrained reparameterization of bounded hyperparameters.

Counterpart of :mod:`muygpys_tpu.optimize.bijectors`: every chassis
optimizes ``z`` with ``theta = lo + (hi - lo) * sigmoid(z)``, so a proposal
can never leave its box (a negative nugget is impossible by construction).
The tensor forms are differentiable by ``torch.autograd`` and run where
their tensors lie (the device chassis applies the chain rule of the fused
K2 objective on the card with :func:`dforward_dz`); the numpy twins serve
the host-side chassis.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# keep the inverse away from the saturated tails: sigmoid(+-18.4) ~ 1e-8 of
# the interval width, far tighter than any recovery tolerance
_Z_CLIP = 18.420680743952367  # = logit(1 - 1e-8)


def forward(z, lo, hi):
    """Unconstrained ``z`` -> ``theta`` in the open box ``(lo, hi)``."""
    return lo + (hi - lo) * torch.sigmoid(z)


def dforward_dz(z, lo, hi):
    """d theta / d z of :func:`forward`, in the order of the sigmoid's
    derivative rule: ``(hi - lo) * (s * (1 - s))``."""
    s = torch.sigmoid(z)
    return (hi - lo) * (s * (1.0 - s))


def inverse(theta, lo, hi):
    """Box ``theta`` -> unconstrained ``z`` (clipped out of the tails)."""
    t = (torch.as_tensor(theta) - lo) / (hi - lo)
    return torch.clamp(torch.log(t) - torch.log1p(-t), -_Z_CLIP, _Z_CLIP)


def inverse_np(theta, lo, hi) -> np.ndarray:
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    t = np.clip((np.asarray(theta, float) - lo) / (hi - lo), 1e-12, 1 - 1e-12)
    return np.clip(np.log(t) - np.log1p(-t), -_Z_CLIP, _Z_CLIP)


def forward_np(z, lo, hi) -> np.ndarray:
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    s = 1.0 / (1.0 + np.exp(-np.asarray(z, float)))
    return lo + (hi - lo) * s


def dforward_dz_np(z, lo, hi) -> np.ndarray:
    """d theta / d z, the host-side chain-rule factor."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    s = 1.0 / (1.0 + np.exp(-np.asarray(z, float)))
    return (hi - lo) * s * (1.0 - s)


def make_param_bijector(
    names: Sequence[str], bounds
) -> Tuple[callable, callable]:
    """(to_theta, to_z) over name-keyed dicts for a free-parameter set:
    ``to_theta`` on tensors (inside objectives), ``to_z`` the host-side
    initializer."""
    bounds = np.asarray(bounds, float)
    lo = {n: float(bounds[i, 0]) for i, n in enumerate(names)}
    hi = {n: float(bounds[i, 1]) for i, n in enumerate(names)}

    def to_theta(zdict: Dict) -> Dict:
        return {n: forward(z, lo[n], hi[n]) for n, z in zdict.items()}

    def to_z(tdict: Dict) -> Dict:
        return {
            n: float(inverse_np(t, lo[n], hi[n])) for n, t in tdict.items()
        }

    return to_theta, to_z
