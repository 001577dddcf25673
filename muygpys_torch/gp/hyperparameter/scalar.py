"""Scalar hyperparameters.

Counterpart of :mod:`muygpys_tpu.gp.hyperparameter.scalar`.  The serving
slice carries trained values; the kwarg-threading surface the optimizers use
(``NamedParameter.apply_fn`` and friends) waits for the training slice.
"""

from __future__ import annotations

from numbers import Number
from typing import Tuple, Union

import numpy as np


class Parameter:
    """A scalar hyperparameter with optimization bounds.

    ``bounds`` is ``"fixed"`` or an increasing ``(lower, upper)`` pair.
    ``val`` is a number within bounds, or ``"sample"`` / ``"log_sample"`` to
    draw uniformly (in linear / log space) from the bounds.
    """

    def __init__(
        self,
        val: Union[str, float],
        bounds: Union[str, Tuple[float, float]] = "fixed",
        _rng: Union[np.random.Generator, None] = None,
    ):
        self._set_bounds(bounds)
        self._set_val(val, _rng)

    def _set_bounds(self, bounds) -> None:
        if isinstance(bounds, str):
            if bounds != "fixed":
                raise ValueError(f"unknown bound option {bounds!r}")
            self._bounds = (0.0, 0.0)
            self._fixed = True
            return
        if not hasattr(bounds, "__iter__"):
            raise ValueError(f"bounds {bounds!r} is not iterable or 'fixed'")
        bounds = tuple(bounds)
        if len(bounds) != 2:
            raise ValueError(f"bounds must have length 2, got {len(bounds)}")
        for b in bounds:
            if not isinstance(b, Number):
                raise ValueError(f"non-numeric bound {b!r}")
        lo, hi = float(bounds[0]), float(bounds[1])
        if lo > hi:
            raise ValueError(f"lower bound {lo} exceeds upper bound {hi}")
        self._bounds = (lo, hi)
        self._fixed = False

    def _sample_val(self, val: str, rng=None) -> float:
        if self._fixed:
            raise ValueError(
                f"fixed bounds do not support string value ({val!r}) prompts"
            )
        rng = rng if rng is not None else np.random.default_rng()
        lo, hi = self._bounds
        if val == "sample":
            return float(rng.uniform(lo, hi))
        elif val == "log_sample":
            return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        raise ValueError(f"unsupported string hyperparameter value {val!r}")

    def _set_val(self, val, rng=None) -> None:
        if isinstance(val, str):
            val = self._sample_val(val, rng)
        if hasattr(val, "__len__"):
            raise ValueError(f"nonscalar hyperparameter value {val!r}")
        val = float(val)
        if not self._fixed:
            lo, hi = self._bounds
            if val < lo - 1e-5:
                raise ValueError(
                    f"value {val} is lesser than the lower bound {lo}"
                )
            if val > hi + 1e-5:
                raise ValueError(
                    f"value {val} is greater than the upper bound {hi}"
                )
        self._val = val

    def __call__(self) -> float:
        return self._val

    def __str__(self):
        bstring = "fixed" if self._fixed else self._bounds
        return f"{type(self).__name__}({self._val}, {bstring})"

    def get_bounds(self) -> Tuple[float, float]:
        return self._bounds

    def fixed(self) -> bool:
        return self._fixed


class VectorParameter:
    """A vector of individually configured scalar ``Parameter``s (e.g.
    anisotropic per-feature length scales); counterpart of
    :class:`muygpys_tpu.gp.hyperparameter.VectorParameter`."""

    def __init__(self, *args: Parameter):
        self._params = list(args)

    def __len__(self) -> int:
        return len(self._params)

    def __getitem__(self, i: int) -> Parameter:
        return self._params[i]

    def __call__(self) -> np.ndarray:
        return np.array([p() for p in self._params])

    def fixed(self) -> bool:
        return all(p.fixed() for p in self._params)
