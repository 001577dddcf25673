"""The RBF kernel functor.

Counterpart of :class:`muygpys_tpu.gp.kernels.RBF`: the default deformation
is ``Isotropy(F2)``, which folds the ``1/l^2`` scaling, so the kernel body is
``exp(-d2/2)``.
"""

from __future__ import annotations

from muygpys_torch.gp.deformation import F2, Isotropy
from muygpys_torch.gp.hyperparameter import Parameter
from muygpys_torch.gp.kernels.kernel_fn import KernelFn
from muygpys_torch.ops import kernels as _k


class RBF(KernelFn):
    """Radial basis function (squared-exponential) kernel."""

    def __init__(self, deformation=None):
        if deformation is None:
            deformation = Isotropy(F2, length_scale=Parameter(1.0))
        super().__init__(deformation=deformation)
        self._kernel_fn = _k.rbf_fn
