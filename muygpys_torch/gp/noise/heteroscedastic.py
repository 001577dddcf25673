"""Heteroscedastic (per-observation diagonal) noise.

Counterpart of :class:`muygpys_tpu.gp.noise.HeteroscedasticNoise`: a
``(batch, nn)`` tensor of per-neighbor noise variances, never a free
parameter.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class HeteroscedasticNoise:
    """A ``(batch_count, nn_count)`` tensor of per-neighbor noise variances
    (always fixed)."""

    def __init__(self, val):
        if isinstance(val, str) or not isinstance(
            val, (np.ndarray, torch.Tensor)
        ):
            raise ValueError(
                f"non-array heteroscedastic noise type {type(val)} is not "
                "allowed"
            )
        if isinstance(val, np.ndarray):
            val = np.array(val)  # a writable copy of a read-only view
        val = torch.as_tensor(val)
        if bool(torch.any(val < 0)):
            raise ValueError(
                "heteroscedastic noise values are not strictly non-negative"
            )
        self._val = val

    def __call__(self) -> torch.Tensor:
        return self._val

    def fixed(self) -> bool:
        return True

    def append_lists(self, names, params, bounds) -> None:
        """Tensor parameters are never on the optimization surface."""

    def perturb(self, Kin: torch.Tensor, **kwargs) -> torch.Tensor:
        """``Kin[b] + diag(noise[b])``."""
        eye = torch.eye(Kin.shape[-1], dtype=Kin.dtype, device=Kin.device)
        noise = self._val.to(dtype=Kin.dtype, device=Kin.device)
        return Kin + noise[..., :, None] * eye

    def perturb_fn(self, fn: Callable) -> Callable:
        def perturbed_fn(Kin, *args, **kwargs):
            return fn(self.perturb(Kin), *args, **kwargs)

        return perturbed_fn
