"""Variance scale (sigma^2) hyperparameters.

Counterpart of :mod:`muygpys_tpu.gp.hyperparameter.scale` (``ScaleFn``,
``FixedScale``, ``AnalyticScale``, ``DownSampleScale``).  ``AnalyticScale``
optimizes sigma^2 in closed form through :mod:`muygpys_torch.ops.scale`,
with the optional fixed-point refinement; ``DownSampleScale`` takes the
median over random sub-neighborhoods, drawn on the host with the caller's
``numpy.random.Generator`` in the JAX package's order, so one seed gives
the same sigma^2 in both packages.  The state the checkpoint format reads
and writes (``val``, ``trained``, ``_set``, ``iteration_count``,
``_down_count``, ``_iteration_count``) keeps the JAX names.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from muygpys_torch.ops.scale import (
    analytic_scale_optim,
    analytic_scale_optim_unnormalized,
)


def _median(values: torch.Tensor) -> torch.Tensor:
    """Median over the leading axis, the mean of the two middle values for
    an even count (``jnp.median``'s; ``torch.median`` returns the lower
    one)."""
    s = torch.sort(values, dim=0).values
    count = s.shape[0]
    if count % 2:
        return s[count // 2]
    return (s[count // 2 - 1] + s[count // 2]) * 0.5


class ScaleFn:
    """Base sigma^2 functor: holds a value and wires it into variance fns."""

    def __init__(self, val: float = 1.0, **kwargs):
        if isinstance(val, str):
            raise ValueError(f"string scale value {val!r} is not supported")
        self._check_positive(val, "scale")
        self.val = val
        self._trained = False

    @staticmethod
    def _check_positive(val, name: str):
        if np.any(np.asarray(val) < 0.0):
            raise ValueError(f"{name} must be positive, got {val}")
        return val

    @staticmethod
    def _check_positive_integer(val, name: str) -> int:
        if not isinstance(val, int) or val < 0:
            raise ValueError(
                f"{name} count must be a positive integer, got {val}"
            )
        return val

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

    def __init__(
        self,
        iteration_count: int = 1,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.iteration_count = self._check_positive_integer(
            iteration_count, "iteration"
        )

    def get_opt_fn(self, muygps) -> Callable:
        def analytic_scale_opt_fn(Kin, nn_targets, *args, **kwargs):
            scale = analytic_scale_optim(
                muygps.noise.perturb(Kin), nn_targets, **kwargs
            )
            if np.asarray(self.val).size != 1:
                return scale
            for _ in range(1, self.iteration_count):
                scale = 0.5 * (
                    scale
                    + analytic_scale_optim(
                        scale * muygps.noise.perturb(Kin), nn_targets,
                        **kwargs,
                    )
                )
            return scale

        return analytic_scale_opt_fn


class DownSampleScale(ScaleFn):
    """Analytic scale estimated as the median over ``iteration_count``
    random sub-neighborhoods of ``down_count`` points each: robust to
    occasional ill-conditioned neighborhoods."""

    def __init__(
        self,
        down_count: int = 10,
        iteration_count: int = 10,
        _backend_fn: Callable = analytic_scale_optim_unnormalized,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self._down_count = self._check_positive_integer(
            down_count, "down sample"
        )
        self._iteration_count = self._check_positive_integer(
            iteration_count, "down sample iteration"
        )
        self._fn = _backend_fn

    def get_opt_fn(self, muygps) -> Callable:
        def downsample_scale_opt_fn(
            Kin, nn_targets, *args, rng=None, **kwargs
        ):
            batch_count, nn_count, _ = Kin.shape
            if nn_count <= self._down_count:
                raise ValueError(
                    f"bad attempt to downsample {self._down_count} elements "
                    f"from a set of only {nn_count} options"
                )
            host_rng = rng if rng is not None else np.random.default_rng()
            pK = muygps.noise.perturb(Kin)
            scales = []
            for _ in range(self._iteration_count):
                idx = torch.as_tensor(
                    np.sort(host_rng.choice(
                        nn_count, size=self._down_count, replace=False
                    )),
                    device=Kin.device,
                )
                pK_down = pK[:, idx][:, :, idx]
                y_down = nn_targets[:, idx]
                scales.append(self._fn(pK_down, y_down))
            return _median(torch.stack(scales)) / (
                self._down_count * batch_count
            )

        return downsample_scale_opt_fn
