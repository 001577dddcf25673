"""The Matern kernel functor.

Counterpart of :class:`muygpys_tpu.gp.kernels.Matern`: a fixed
``nu in {1/2, 3/2, 5/2, inf}`` uses its closed form; any other fixed ``nu``
and every free ``nu`` goes through the exact Bessel path
(:func:`muygpys_torch.ops.kernels.matern_gen_fn`), which is differentiable
in the smoothness, so gradient-based optimizers can train it.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

from muygpys_torch.gp.deformation import Isotropy, l2
from muygpys_torch.gp.hyperparameter import NamedParameter, Parameter
from muygpys_torch.gp.kernels.kernel_fn import KernelFn
from muygpys_torch.ops import kernels as _k

CLOSED_FORMS = {
    0.5: _k.matern_05_fn,
    1.5: _k.matern_15_fn,
    2.5: _k.matern_25_fn,
    math.inf: _k.matern_inf_fn,
}


def _set_matern_fn(smoothness: Parameter) -> Callable:
    """``(dists, **kwargs) -> K``: the closed form of a fixed closed-form
    smoothness, else the general form reading ``smoothness`` from the
    keyword arguments."""
    if smoothness.fixed() and smoothness() in CLOSED_FORMS:
        closed = CLOSED_FORMS[smoothness()]
        return lambda dists, **kwargs: closed(dists)

    def gen_fn(dists, smoothness, **kwargs):
        return _k.matern_gen_fn(dists, smoothness)

    return gen_fn


class Matern(KernelFn):
    """Matern kernel over a deformation, with trainable smoothness."""

    def __init__(self, smoothness: Parameter = None, deformation=None):
        if smoothness is None:
            smoothness = Parameter(0.5)
        if deformation is None:
            deformation = Isotropy(l2, length_scale=Parameter(1.0))
        super().__init__(deformation=deformation)
        self.smoothness = NamedParameter("smoothness", smoothness)
        self._make()

    def _make(self):
        self._make_base()
        self.smoothness.populate(self._hyperparameters)
        self._kernel_fn = _set_matern_fn(self.smoothness)
        # the stored smoothness where the caller names none
        self._predef_fn = self.smoothness.apply_fn(self._kernel_fn)
        self._fn = self.deformation.length_scale.apply_embedding_fn(
            self._predef_fn, self.deformation
        )

    def of_scaled_dists(self, dists):
        # closed form or exact Bessel path, the stored smoothness filled in
        return self._predef_fn(dists)

    def get_opt_params(
        self,
    ) -> Tuple[List[str], List[float], List[Tuple[float, float]]]:
        names, params, bounds = super().get_opt_params()
        self.smoothness.append_lists(names, params, bounds)
        return names, params, bounds
