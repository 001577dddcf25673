"""Noise model interface.

Counterpart of :class:`muygpys_tpu.gp.noise.NoiseFn`.
"""

from __future__ import annotations

from typing import Callable


class NoiseFn:
    """Interface: ``perturb`` a covariance tensor, or wrap a function so
    its first (covariance) argument is perturbed (``perturb_fn``)."""

    def perturb(self, Kin, **kwargs):
        raise NotImplementedError

    def perturb_fn(self, fn: Callable) -> Callable:
        raise NotImplementedError
