"""Lensing-specific shear noise.

Counterpart of :class:`muygpys_tpu.gp.noise.ShearNoise33`: doubled tau^2 on
the convergence block of the flattened ``(b, 3, nn, 3, nn)`` covariance.
"""

from __future__ import annotations

from typing import Optional

import torch

from muygpys_torch.gp.noise.homoscedastic import HomoscedasticNoise


def shear_perturb33(Kin: torch.Tensor, noise_variance) -> torch.Tensor:
    """``Kin (batch, 3, nn, 3, nn)`` with ``2 tau^2`` added to the diagonal
    of the first (convergence) block and ``tau^2`` to the two shear blocks'."""
    if Kin.ndim != 5 or Kin.shape[1] != 3 or Kin.shape[3] != 3:
        raise ValueError(
            "shear perturbation requires (b, 3, nn, 3, nn), got "
            f"{tuple(Kin.shape)}"
        )
    b, in_count, nn_count, _, _ = Kin.shape
    all_count = in_count * nn_count
    ones = torch.ones(nn_count, dtype=Kin.dtype, device=Kin.device)
    diag = torch.cat(
        [2.0 * noise_variance * ones, noise_variance * ones.repeat(2)]
    )
    flat = Kin.reshape(b, all_count, all_count) + torch.diag(diag)
    return flat.reshape(Kin.shape)


class ShearNoise33(HomoscedasticNoise):
    """Homoscedastic noise with twice the variance on the convergence
    output."""

    def perturb(self, Kin: torch.Tensor, noise: Optional[float] = None,
                **kwargs) -> torch.Tensor:
        if noise is None:
            noise = self._val
        return shear_perturb33(Kin, noise)
