"""Lensing-specific shear noise.

Counterpart of :class:`muygpys_tpu.gp.noise.ShearNoise33`: doubled tau^2 on
the convergence block of the flattened ``(b, 3, nn, 3, nn)`` covariance
(:func:`muygpys_torch.ops.noise.shear_perturb33`).
"""

from __future__ import annotations

from typing import Optional

import torch

from muygpys_torch.gp.noise.homoscedastic import HomoscedasticNoise
from muygpys_torch.ops.noise import shear_perturb33


class ShearNoise33(HomoscedasticNoise):
    """Homoscedastic noise with twice the variance on the convergence
    output."""

    def perturb(self, Kin: torch.Tensor, noise: Optional[float] = None,
                **kwargs) -> torch.Tensor:
        if noise is None:
            noise = self._val
        return shear_perturb33(Kin, noise)
