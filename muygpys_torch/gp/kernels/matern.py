"""The Matern kernel functor, closed-form smoothness only.

Counterpart of :class:`muygpys_tpu.gp.kernels.Matern` for
``nu in {1/2, 3/2, 5/2, inf}``.  General smoothness (the Bessel path and the
``matern_nu`` surrogate) is not ported yet and raises.
"""

from __future__ import annotations

import math

from muygpys_torch.gp.deformation import Isotropy, l2
from muygpys_torch.gp.hyperparameter import Parameter
from muygpys_torch.gp.kernels.kernel_fn import KernelFn
from muygpys_torch.ops import kernels as _k

_CLOSED_FORMS = {
    0.5: _k.matern_05_fn,
    1.5: _k.matern_15_fn,
    2.5: _k.matern_25_fn,
    math.inf: _k.matern_inf_fn,
}


class Matern(KernelFn):
    """Matern kernel over a deformation."""

    def __init__(self, smoothness: Parameter = None, deformation=None):
        if smoothness is None:
            smoothness = Parameter(0.5)
        if deformation is None:
            deformation = Isotropy(l2, length_scale=Parameter(1.0))
        super().__init__(deformation=deformation)
        nu = smoothness()
        if nu not in _CLOSED_FORMS:
            raise ValueError(
                f"Matern smoothness {nu}: general smoothness is not ported "
                "yet (closed forms 0.5, 1.5, 2.5, inf only)"
            )
        self.smoothness = smoothness
        self._kernel_fn = _CLOSED_FORMS[nu]
