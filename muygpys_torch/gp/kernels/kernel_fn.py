"""Kernel functor base class.

Counterpart of :class:`muygpys_tpu.gp.kernels.KernelFn`: a kernel owns a
deformation and a dict of its named hyperparameters, and composes
``(diffs, **free_params) -> K`` by threading the named values through the
deformation and the kernel body, so an objective assembled from it is
differentiable by ``torch.autograd`` in every free parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple


class KernelFn:
    """Base kernel functor: hyperparameter dict + call mechanism."""

    def __init__(self, deformation):
        self._hyperparameters: Dict = dict()
        self.deformation = deformation

    def _make_base(self):
        self.deformation.length_scale.populate(self._hyperparameters)

    def _make(self):
        raise NotImplementedError("_make is not implemented for base KernelFn")

    def set_params(self, **kwargs) -> None:
        """Replace named hyperparameters' values and bounds in place:
        ``set_params(length_scale=Parameter(0.3, (0.1, 1.0)))``."""
        for name in kwargs:
            self._hyperparameters[name]._set(kwargs[name])

    def __call__(self, diffs, **kwargs):
        """Evaluate the kernel on a (pairwise or crosswise) distance or
        difference tensor, as dictated by the deformation; free parameters
        may be passed by name."""
        return self._fn(diffs, **kwargs)

    def of_scaled_dists(self, dists):
        """The kernel of distances the deformation has already scaled, at
        the stored hyperparameters."""
        raise NotImplementedError(
            "of_scaled_dists is not implemented for base KernelFn"
        )

    def get_opt_fn(self) -> Callable:
        return self._fn

    def Kout(self, **kwargs) -> float:
        """Prior variance of an observable: 1."""
        return 1.0

    def get_opt_params(
        self,
    ) -> Tuple[List[str], List[float], List[Tuple[float, float]]]:
        names: List[str] = []
        params: List[float] = []
        bounds: List[Tuple[float, float]] = []
        self.deformation.length_scale.append_lists(names, params, bounds)
        return names, params, bounds

    def __str__(self) -> str:
        return "\n".join(
            f"{name} : {param()} - {param.get_bounds()}"
            for name, param in self._hyperparameters.items()
        )
