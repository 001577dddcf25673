"""Posterior mean functor.

Counterpart of :class:`muygpys_tpu.gp.mean.PosteriorMean`: the batched solve
composed with the model's noise perturbation (through which a proposed
``noise=`` reaches the solve during optimization).
"""

from __future__ import annotations

from typing import Callable

from muygpys_torch.ops.solve import posterior_mean


class PosteriorMean:
    """Composes the backend mean solve with the model's noise
    perturbation."""

    def __init__(self, noise):
        self._fn = noise.perturb_fn(posterior_mean)

    def __call__(self, Kin, Kcross, batch_nn_targets, **kwargs):
        return self._fn(Kin, Kcross, batch_nn_targets, **kwargs)

    def get_opt_fn(self) -> Callable:
        return self._fn
