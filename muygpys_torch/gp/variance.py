"""Posterior variance functor.

Counterpart of :class:`muygpys_tpu.gp.variance.PosteriorVariance`: the
public call applies the sigma^2 scale; ``get_opt_fn`` exposes the *unscaled*
variant the LOO objectives use (they estimate the scale per evaluation).
"""

from __future__ import annotations

from typing import Callable

from muygpys_torch.ops.solve import diagonal_variance


class PosteriorVariance:
    """Noise-perturbed, Kout-curried, scale-multiplied variance."""

    def __init__(self, Kout, noise, scale):
        fn = noise.perturb_fn(diagonal_variance)

        def fixed_Kout_fn(Kin, Kcross, *args, **kwargs):
            return fn(Kin, Kcross, Kout, *args, **kwargs)

        self._opt_fn = fixed_Kout_fn
        self._fn = scale.scale_fn(fixed_Kout_fn)

    def __call__(self, Kin, Kcross, **kwargs):
        return self._fn(Kin, Kcross, **kwargs)

    def get_opt_fn(self) -> Callable:
        return self._opt_fn
