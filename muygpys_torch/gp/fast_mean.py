"""Fast posterior mean functor (the serve side: no solve at predict time).

Counterpart of :class:`muygpys_tpu.gp.fast_mean.FastPosteriorMean`.
"""

from __future__ import annotations

from typing import Callable

from muygpys_torch.ops.solve import fast_posterior_mean


class FastPosteriorMean:
    def __init__(self, _backend_fn: Callable = fast_posterior_mean, **kwargs):
        self._fn = _backend_fn

    def __call__(self, Kcross, coeffs_tensor, **kwargs):
        return self._fn(Kcross, coeffs_tensor, **kwargs)

    def get_opt_fn(self) -> Callable:
        return self._fn
