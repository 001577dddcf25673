"""Homoscedastic (shared tau^2 I) noise.

Counterpart of :class:`muygpys_tpu.gp.noise.HomoscedasticNoise`: the named
parameter ``noise``, with the ``noise=`` keyword of ``perturb`` through which
a proposed value reaches the covariance during optimization.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from muygpys_torch.gp.hyperparameter import NamedParameter, Parameter
from muygpys_torch.gp.noise.noise_fn import NoiseFn
from muygpys_torch.ops.noise import homoscedastic_perturb


class HomoscedasticNoise(NamedParameter, NoiseFn):
    """A shared noise prior variance tau^2, named ``"noise"``."""

    def __init__(
        self,
        val: Union[str, float],
        bounds: Union[str, Tuple[float, float]] = "fixed",
    ):
        super().__init__("noise", Parameter(val, bounds))
        if not self.fixed() and min(self._bounds) < 0.0:
            raise ValueError(
                f"homoscedastic noise optimization bounds {self._bounds} "
                "are not strictly positive"
            )

    def perturb(self, Kin: torch.Tensor, noise: Optional[float] = None,
                **kwargs) -> torch.Tensor:
        """``Kin + tau^2 I`` for ``Kin (batch, nn, nn)``, or over the
        flattened ``(in * nn, in * nn)`` blocks of the multi-output layout
        ``(batch, in, nn, in, nn)``."""
        if noise is None:
            noise = self._val
        return homoscedastic_perturb(Kin, noise)

    def perturb_fn(self, fn: Callable) -> Callable:
        def perturbed_fn(Kin, *args, noise=None, **kwargs):
            return fn(self.perturb(Kin, noise=noise), *args, **kwargs)

        return perturbed_fn
