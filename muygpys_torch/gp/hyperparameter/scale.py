"""Variance scale (sigma^2) hyperparameters.

Counterpart of :mod:`muygpys_tpu.gp.hyperparameter.scale`.  A served model
carries a trained scale value; the analytic optimizer waits for the training
slice.
"""

from __future__ import annotations

import numpy as np


class ScaleFn:
    """Base sigma^2 functor: holds a (possibly trained) value."""

    def __init__(self, val: float = 1.0, **kwargs):
        if isinstance(val, str):
            raise ValueError(f"string scale value {val!r} is not supported")
        if np.any(np.asarray(val) < 0.0):
            raise ValueError(f"scale must be positive, got {val}")
        self.val = val
        self._trained = False

    def __call__(self):
        return self.val

    def __str__(self):
        return f"{type(self).__name__}({self.val})"

    @property
    def trained(self) -> bool:
        return self._trained

    def _set(self, val) -> None:
        self.val = val
        self._trained = True


class FixedScale(ScaleFn):
    """A scale parameter insensitive to optimization."""


class AnalyticScale(ScaleFn):
    """Scale with the closed-form analytic optimum; here it carries a value
    trained elsewhere (``_set``).  Optimizing it is not ported yet."""

    def __init__(self, iteration_count: int = 1, **kwargs):
        super().__init__(**kwargs)
        if not isinstance(iteration_count, int) or iteration_count < 0:
            raise ValueError(
                "iteration count must be a positive integer, got "
                f"{iteration_count}"
            )
        self.iteration_count = iteration_count

    def get_opt_fn(self, muygps):
        raise NotImplementedError(
            "analytic scale optimization is not ported yet"
        )
