"""Homoscedastic (shared tau^2 I) noise.

Counterpart of :class:`muygpys_tpu.gp.noise.HomoscedasticNoise`.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from muygpys_torch.gp.hyperparameter import Parameter


class HomoscedasticNoise(Parameter):
    """A shared noise prior variance tau^2."""

    def __init__(
        self,
        val: Union[str, float],
        bounds: Union[str, Tuple[float, float]] = "fixed",
    ):
        super().__init__(val, bounds)
        if not self.fixed() and min(self._bounds) < 0.0:
            raise ValueError(
                f"homoscedastic noise optimization bounds {self._bounds} "
                "are not strictly positive"
            )

    def perturb(self, Kin: torch.Tensor) -> torch.Tensor:
        """``Kin + tau^2 I`` for ``Kin (batch, nn, nn)``."""
        eye = torch.eye(Kin.shape[-1], dtype=Kin.dtype, device=Kin.device)
        return Kin + self._val * eye
