"""Heteroscedastic (per-observation diagonal) noise.

Counterpart of :class:`muygpys_tpu.gp.noise.HeteroscedasticNoise`: a
:class:`~muygpys_torch.gp.hyperparameter.TensorParam` holding a
``(batch, nn)`` tensor of per-neighbor noise variances, never a free
parameter.
"""

from __future__ import annotations

from typing import Callable

import torch

from muygpys_torch.gp.hyperparameter import TensorParam
from muygpys_torch.gp.noise.noise_fn import NoiseFn
from muygpys_torch.ops.noise import heteroscedastic_perturb


class HeteroscedasticNoise(TensorParam, NoiseFn):
    """A ``(batch_count, nn_count)`` tensor of per-neighbor noise variances
    (always fixed)."""

    def __init__(self, val):
        super().__init__(val)
        if bool(torch.any(self._val < 0)):
            raise ValueError(
                "heteroscedastic noise values are not strictly non-negative"
            )

    def perturb(self, Kin: torch.Tensor, **kwargs) -> torch.Tensor:
        """``Kin[b] + diag(noise[b])``."""
        return heteroscedastic_perturb(Kin, self._val)

    def perturb_fn(self, fn: Callable) -> Callable:
        def perturbed_fn(Kin, *args, **kwargs):
            return fn(self.perturb(Kin), *args, **kwargs)

        return perturbed_fn
