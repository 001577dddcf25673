"""Offline coefficient precompute for the fast posterior mean.

Counterpart of :class:`muygpys_tpu.gp.fast_precompute.
FastPrecomputeCoefficients`: the backend solve wrapped by the model's noise
perturbation.
"""

from __future__ import annotations

from typing import Callable

from muygpys_torch.gp.noise import NoiseFn
from muygpys_torch.ops.solve import fast_posterior_mean_precompute


class FastPrecomputeCoefficients:
    def __init__(
        self,
        noise: NoiseFn,
        _backend_fn: Callable = fast_posterior_mean_precompute,
        **kwargs,
    ):
        self._fn = noise.perturb_fn(_backend_fn)

    def __call__(self, Kin, train_nn_targets_fast, **kwargs):
        return self._fn(Kin, train_nn_targets_fast, **kwargs)

    def get_opt_fn(self) -> Callable:
        return self._fn
