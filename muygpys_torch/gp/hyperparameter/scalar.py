"""Scalar and vector hyperparameters and their named optimization surface.

Counterpart of :mod:`muygpys_tpu.gp.hyperparameter.scalar` and
:mod:`muygpys_tpu.gp.hyperparameter.vector`.  A named parameter is the unit
of the optimization surface: optimizers pass proposed values as keyword
arguments under its name (``length_scale``, ``length_scale0``, ...,
``noise``), and the kwarg-threading wrappers (``apply_fn``,
``apply_embedding_fn``) put the stored value in where a name is absent.  A
proposed value may be a tensor that requires grad, so ``torch.autograd``
differentiates an objective assembled from these wrappers.
"""

from __future__ import annotations

from numbers import Number
from typing import Callable, Dict, List, Tuple, Union

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

    def _set(self, rhs: "Parameter") -> None:
        self._val = rhs._val
        self._bounds = rhs._bounds
        self._fixed = rhs._fixed

    def __call__(self, **kwargs) -> float:
        return self._val

    def __str__(self):
        bstring = "fixed" if self._fixed else self._bounds
        return f"{type(self).__name__}({self._val}, {bstring})"

    def get_bounds(self) -> Tuple[float, float]:
        return self._bounds

    def fixed(self) -> bool:
        return self._fixed


ScalarParam = Parameter


class NamedParameter(Parameter):
    """A ``Parameter`` with a name: the key under which optimizers pass a
    proposed value."""

    def __init__(self, name: str, param: Parameter):
        self._set(param)
        self._name = name

    def name(self) -> str:
        return self._name

    def __call__(self, **kwargs):
        return kwargs.get(self._name, self._val)

    def apply_fn(self, fn: Callable) -> Callable:
        def applied_fn(*args, **kwargs):
            kwargs.setdefault(self._name, self._val)
            return fn(*args, **kwargs)

        return applied_fn

    def filter_kwargs(self, **kwargs) -> Tuple[Dict, Dict]:
        params = {k: v for k, v in kwargs.items() if k == self._name}
        rest = {k: v for k, v in kwargs.items() if k != self._name}
        params.setdefault(self._name, self._val)
        return params, rest

    def apply_embedding_fn(
        self, fn: Callable, deformation_fn: Callable
    ) -> Callable:
        def embedded_fn(dists, *args, **kwargs):
            params, kwargs = self.filter_kwargs(**kwargs)
            return fn(deformation_fn(dists, **params), *args, **kwargs)

        return embedded_fn

    def append_lists(
        self,
        names: List[str],
        params: List[float],
        bounds: List[Tuple[float, float]],
    ) -> None:
        if not self.fixed():
            names.append(self._name)
            params.append(self._val)
            bounds.append(self.get_bounds())

    def populate(self, hyperparameters: Dict) -> None:
        hyperparameters[self._name] = self


class VectorParameter:
    """A vector of individually configured scalar ``Parameter``s (e.g.
    anisotropic per-feature length scales)."""

    def __init__(self, *args: Parameter):
        self._params = list(args)

    def __len__(self) -> int:
        return len(self._params)

    def __getitem__(self, i: int) -> Parameter:
        return self._params[i]

    def __call__(self, **kwargs) -> np.ndarray:
        return np.array([p() for p in self._params])

    def fixed(self) -> bool:
        return all(p.fixed() for p in self._params)


class NamedVectorParameter(VectorParameter):
    """Vector parameter whose elements are named ``<name>0..<name>{d-1}``,
    so each is a separate knob on the optimization surface."""

    def __init__(self, name: str, param: VectorParameter):
        self._params = [
            NamedParameter(name + str(i), p)
            for i, p in enumerate(param._params)
        ]
        self._name = name

    def name(self) -> str:
        return self._name

    def set_defaults(self, **params) -> Dict:
        """``params`` with each element's stored value filled in where its
        name is absent."""
        for p in self._params:
            params.setdefault(p.name(), p())
        return params

    def values(self, **kwargs) -> list:
        """Element values in order, proposed kwargs taking precedence (a
        list, so tensors that require grad stay in their graph)."""
        return [p(**kwargs) for p in self._params]

    def filter_kwargs(self, **kwargs) -> Tuple[Dict, Dict]:
        mine = {p.name() for p in self._params}
        params = {k: v for k, v in kwargs.items() if k in mine}
        rest = {k: v for k, v in kwargs.items() if k not in mine}
        return self.set_defaults(**params), rest

    def apply_fn(self, fn: Callable) -> Callable:
        def applied_fn(*args, **kwargs):
            params, kwargs = self.filter_kwargs(**kwargs)
            return fn(*args, **params, **kwargs)

        return applied_fn

    def apply_embedding_fn(
        self, fn: Callable, deformation_fn: Callable
    ) -> Callable:
        def embedded_fn(dists, *args, **kwargs):
            params, kwargs = self.filter_kwargs(**kwargs)
            return fn(deformation_fn(dists, **params), *args, **kwargs)

        return embedded_fn

    def append_lists(
        self,
        names: List[str],
        params: List[float],
        bounds: List[Tuple[float, float]],
    ) -> None:
        for p in self._params:
            p.append_lists(names, params, bounds)

    def populate(self, hyperparameters: Dict) -> None:
        for p in self._params:
            hyperparameters[p.name()] = p
