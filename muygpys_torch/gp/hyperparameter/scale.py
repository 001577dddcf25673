"""Variance scale (sigma^2) hyperparameters.

Counterpart of :mod:`muygpys_tpu.gp.hyperparameter.scale` (``ScaleFn``,
``FixedScale``, ``AnalyticScale``).  ``AnalyticScale`` optimizes sigma^2 in
closed form through :mod:`muygpys_torch.ops.scale`, with the optional
fixed-point refinement; ``DownSampleScale`` is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from muygpys_torch.ops.scale import analytic_scale_optim


class ScaleFn:
    """Base sigma^2 functor: holds a value and wires it into variance fns."""

    def __init__(self, val: float = 1.0, **kwargs):
        if isinstance(val, str):
            raise ValueError(f"string scale value {val!r} is not supported")
        if np.any(np.asarray(val) < 0.0):
            raise ValueError(f"scale must be positive, got {val}")
        self.val = val
        self._trained = False

    def __call__(self, **kwargs):
        return self.val

    def __str__(self):
        return f"{type(self).__name__}({self.val})"

    @property
    def trained(self) -> bool:
        return self._trained

    def _set(self, val) -> None:
        self.val = val
        self._trained = True

    def scale_fn(self, fn: Callable) -> Callable:
        """Wrap ``fn`` so its output is multiplied by the (overridable)
        scale."""

        def scaled_fn(*args, scale=None, **kwargs):
            if scale is None:
                scale = self()
            return scale * fn(*args, **kwargs)

        return scaled_fn

    def get_opt_fn(self, muygps) -> Callable:
        def noop_scale_opt_fn(Kin, nn_targets, *args, **kwargs):
            return muygps.scale()

        return noop_scale_opt_fn


class FixedScale(ScaleFn):
    """A scale parameter insensitive to optimization."""


class AnalyticScale(ScaleFn):
    """Scale with the closed-form analytic optimum
    ``sigma^2 = mean_i Y_i^T (Kin_i + eps)^{-1} Y_i / nn_count``, refined by
    fixed-point iteration when ``iteration_count > 1``."""

    def __init__(self, iteration_count: int = 1, **kwargs):
        super().__init__(**kwargs)
        if not isinstance(iteration_count, int) or iteration_count < 0:
            raise ValueError(
                "iteration count must be a positive integer, got "
                f"{iteration_count}"
            )
        self.iteration_count = iteration_count

    def get_opt_fn(self, muygps) -> Callable:
        def analytic_scale_opt_fn(Kin, nn_targets, *args, **kwargs):
            scale = analytic_scale_optim(muygps.noise.perturb(Kin), nn_targets)
            for _ in range(1, self.iteration_count):
                scale = 0.5 * (
                    scale
                    + analytic_scale_optim(
                        scale * muygps.noise.perturb(Kin), nn_targets
                    )
                )
            return scale

        return analytic_scale_opt_fn
