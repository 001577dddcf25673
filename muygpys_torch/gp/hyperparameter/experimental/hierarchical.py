"""Hierarchical nonstationary hyperparameters: a GP over a hyperparameter.

Counterpart of :mod:`muygpys_tpu.gp.hyperparameter.experimental.hierarchical`.
The parameter's value at each batch point is the higher-level GP's
posterior mean over knot values, ``ls(x) = Kcross(x, knots) (K_knots +
eps I)^{-1} v``, floored by a sharp softplus as in JAX (the interpolant can
overshoot below zero between knots).  The knot values are scalar free
parameters named ``<name>0``, ``<name>1``, ... on the optimization surface,
so ``torch.autograd`` differentiates an objective through the field.

The knots' covariance ``K_knots`` is built once, in float64 on the CPU,
and LU-factored there once with the nugget (the factorization JAX's
``jnp.linalg.solve`` makes at every call).  The factors and the knots move
to the batch features' device and dtype at the first call there and are
kept, so a call makes no host transfer and no factorization: the device
chassis captures it in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from muygpys_torch.gp.hyperparameter.scalar import (
    NamedVectorParameter,
    VectorParameter,
)

#: sharpness of the softplus floor on the interpolated field
SOFTPLUS_BETA = 20.0


class HierarchicalParameter:
    """Knot-based nonstationary hyperparameter driven by a higher-level GP
    (``kernel`` over ``knot_features``, nugget ``noise``, default 1e-5)."""

    def __init__(self, knot_features, knot_params: VectorParameter, kernel,
                 noise=None):
        from muygpys_torch.gp.noise import HomoscedasticNoise

        self._knot_count = len(knot_params)
        if self._knot_count != len(knot_features):
            raise ValueError(
                "knot_features and knot_values must have the same length"
            )
        if torch.is_tensor(knot_features):
            knot_features = knot_features.detach().cpu().numpy()
        self._knot_features = torch.as_tensor(
            np.asarray(knot_features, dtype=np.float64)
        )
        self._knot_params = knot_params
        self._kernel = kernel
        pairwise = kernel.deformation.pairwise_tensor(
            self._knot_features, torch.arange(self._knot_count)
        )
        if pairwise.ndim == 2:
            # a knot's distance to itself is 0, where the Gram identity
            # leaves ~eps |x|^2 (and an l2 metric its square root)
            pairwise.fill_diagonal_(0.0)
        self._Kin_higher = kernel(pairwise)
        self._noise = noise if noise is not None else HomoscedasticNoise(1e-5)

    def __call__(self, batch_features, **kwargs):
        raise NotImplementedError(
            "__call__ not implemented for base HierarchicalParameter"
        )

    def fixed(self) -> bool:
        return self._knot_params.fixed()

    def get_bounds(self) -> Tuple[float, float]:
        raise NotImplementedError(
            "HierarchicalParameter does not support direct optimization "
            "bounds; set bounds on individual knot values instead"
        )


HierarchicalParam = HierarchicalParameter


class NamedHierarchicalParameter(HierarchicalParameter):
    """A hierarchical parameter with a name; its knot values are named
    ``<name>0``, ``<name>1``, ..."""

    def __init__(self, name: str, rhs: HierarchicalParameter):
        self._knot_count = rhs._knot_count
        self._knot_features = rhs._knot_features
        self._knot_params = rhs._knot_params
        self._params = NamedVectorParameter(name, rhs._knot_params)
        self._Kin_higher = rhs._Kin_higher
        self._kernel = rhs._kernel
        self._noise = rhs._noise
        self._name = name
        A = self._Kin_higher + self._noise() * torch.eye(
            self._knot_count, dtype=self._Kin_higher.dtype
        )
        P, L, U = torch.linalg.lu(A)
        # A = P L U: the solve is b[perm] through L, then U
        self._lu = (P.argmax(dim=0), L, U)
        self._placed = {}

    def _factors(self, device, dtype):
        """(perm, L, U, knots) on ``device`` in ``dtype``, moved once."""
        key = (str(device), dtype)
        if key not in self._placed:
            perm, L, U = self._lu
            self._placed[key] = (
                perm.to(device), L.to(device=device, dtype=dtype),
                U.to(device=device, dtype=dtype),
                self._knot_features.to(device=device, dtype=dtype),
            )
        return self._placed[key]

    def name(self) -> str:
        return self._name

    def knot_values(self) -> torch.Tensor:
        """The stored knot values, float64."""
        return torch.as_tensor(
            [float(v) for v in self._params.values()], dtype=torch.float64
        )

    def __call__(self, batch_features, **kwargs) -> torch.Tensor:
        """The field at each row of ``batch_features`` ``(batch, feat)``:
        ``(batch,)`` in the features' dtype on their device; proposed knot
        values (tensors that require grad included) by name in
        ``kwargs``."""
        params, _ = self._params.filter_kwargs(**kwargs)
        bf = torch.as_tensor(batch_features)
        dev, dtype = bf.device, bf.dtype
        # a stored value is filled on the device (no host transfer)
        values = torch.stack([
            v.to(device=dev, dtype=dtype) if torch.is_tensor(v)
            else torch.full((), float(v), dtype=dtype, device=dev)
            for v in self._params.values(**params)
        ])
        perm, L, U, knots = self._factors(dev, dtype)
        solve = torch.linalg.solve_triangular(
            U, torch.linalg.solve_triangular(
                L, values[perm][:, None], upper=False, unitriangular=True
            ), upper=True,
        )[:, 0]
        lower_Kcross = self._kernel(self._kernel.deformation.crosswise_tensor(
            bf, knots, torch.arange(bf.shape[0], device=dev),
            torch.arange(self._knot_count, device=dev),
        ))
        raw = torch.squeeze(lower_Kcross @ solve)
        # jax.nn.softplus is logaddexp(x, 0): torch's softplus returns x
        # itself above its threshold, 2e-9 off at x = 20
        beta = SOFTPLUS_BETA
        return 1e-6 + torch.logaddexp(beta * raw, torch.zeros_like(raw)) / beta

    def filter_kwargs(self, **kwargs) -> Tuple[Dict, Dict]:
        """``({name: field at kwargs["batch_features"]}, the other
        kwargs)``; the knot values are taken out of ``kwargs``."""
        params, kwargs = self._params.filter_kwargs(**kwargs)
        if "batch_features" not in kwargs:
            raise ValueError(
                f"the hierarchical parameter {self._name!r} needs "
                "batch_features= (the batch points' features)"
            )
        lower = {self._name: self(kwargs["batch_features"], **params)}
        return lower, kwargs

    def apply_fn(self, fn: Callable) -> Callable:
        def applied_fn(*args, **kwargs):
            lower, kwargs = self.filter_kwargs(**kwargs)
            return fn(*args, **lower, **kwargs)

        return applied_fn

    def apply_embedding_fn(
        self, fn: Callable, deformation_fn: Callable
    ) -> Callable:
        def embedded_fn(dists, *args, **kwargs):
            lower, kwargs = self.filter_kwargs(**kwargs)
            return fn(deformation_fn(dists, **lower), *args, **kwargs)

        return embedded_fn

    def append_lists(
        self,
        names: List[str],
        params: List[float],
        bounds: List[Tuple[float, float]],
    ) -> None:
        self._params.append_lists(names, params, bounds)

    def populate(self, hyperparameters: Dict) -> None:
        self._params.populate(hyperparameters)


class NamedHierarchicalVectorParameter(NamedVectorParameter):
    """A vector of named hierarchical parameters ``<name>0``, ``<name>1``,
    ..., each evaluated at ``batch_features`` when it is given."""

    def __init__(self, name: str, param: VectorParameter):
        self._params = [
            NamedHierarchicalParameter(name + str(i), p)
            for i, p in enumerate(param._params)
        ]
        self._name = name

    def filter_kwargs(self, **kwargs) -> Tuple[Dict, Dict]:
        params = {
            k: v for k, v in kwargs.items() if k.startswith(self._name)
        }
        kwargs = {
            k: v for k, v in kwargs.items() if not k.startswith(self._name)
        }
        if "batch_features" in kwargs:
            for p in self._params:
                params.setdefault(
                    p.name(), p(kwargs["batch_features"], **params)
                )
        return params, kwargs


def sample_knots(feature_count: int, knot_count: int) -> torch.Tensor:
    """Latin hypercube sample of knot locations in the unit cube (float64,
    on the CPU; the same points as JAX's)."""
    from scipy.stats.qmc import LatinHypercube

    return torch.as_tensor(
        LatinHypercube(feature_count, scramble=False).random(knot_count)
    )
