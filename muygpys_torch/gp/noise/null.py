"""Null (zero) noise model.

Counterpart of :class:`muygpys_tpu.gp.noise.NullNoise`: a fixed parameter
named ``noise`` whose value is 0 and whose perturbation is the identity.
"""

from __future__ import annotations

from typing import Callable

from muygpys_torch.gp.hyperparameter import Parameter
from muygpys_torch.gp.noise.noise_fn import NoiseFn


class NullNoise(Parameter, NoiseFn):
    """Zero-noise assumption; perturbation is the identity."""

    def __init__(self, *args, **kwargs):
        self._val = 0.0
        self._bounds = (0.0, 0.0)
        self._fixed = True
        self._name = "noise"

    def name(self) -> str:
        return self._name

    def __call__(self, *args, **kwargs):
        return 0.0

    def append_lists(self, names, params, bounds) -> None:
        """Never on the optimization surface."""

    def perturb(self, Kin, **kwargs):
        return Kin

    def perturb_fn(self, fn: Callable) -> Callable:
        return fn
