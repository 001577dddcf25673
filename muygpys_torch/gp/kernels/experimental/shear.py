"""Lensing shear kernel functors.

Counterpart of :mod:`muygpys_tpu.gp.kernels.experimental.shear`:
``ShearKernel`` (three observed components in, three out) and
``ShearKernel2in3out`` (the two shear components observed, convergence and
both shears predicted).  Both take difference tensors from a
:class:`~muygpys_torch.gp.deformation.DifferenceIsotropy` and return the
block layouts of :mod:`muygpys_torch.ops.shear`; a ``length_scale=`` keyword
overrides the stored value, so an objective built on them is differentiable
in it by ``torch.autograd``.
"""

from __future__ import annotations

from typing import Callable

import torch

from muygpys_torch.gp.deformation import DifferenceIsotropy, F2
from muygpys_torch.gp.hyperparameter import Parameter
from muygpys_torch.gp.kernels.kernel_fn import KernelFn
from muygpys_torch.ops import shear as _shear


def _check_deformation(deformation):
    if deformation is None:
        return DifferenceIsotropy(F2, length_scale=Parameter(1.0))
    if not isinstance(deformation, DifferenceIsotropy):
        raise ValueError(
            "ShearKernel only supports the specialized difference "
            f"isotropic deformations, not {type(deformation)}"
        )
    return deformation


def _zero_diffs() -> torch.Tensor:
    # f64 whatever the configured float width: the prior is a handful of
    # numbers, cast down where it meets a covariance tensor
    return torch.zeros((1, 1, 2), dtype=torch.float64)


class _ShearBase(KernelFn):
    """What the two shear functors share: the deformation check and the
    ``length_scale=`` override."""

    def __init__(self, deformation: DifferenceIsotropy = None):
        super().__init__(deformation=_check_deformation(deformation))
        self._make()

    def _with_ls(self, fn: Callable) -> Callable:
        def embedded_fn(diffs, *args, length_scale=None, **kwargs):
            if length_scale is None:
                length_scale = self.deformation.length_scale()
            return fn(diffs, *args, length_scale=length_scale, **kwargs)

        return embedded_fn

    def get_opt_fn(self) -> Callable:
        return self.__call__


class ShearKernel(_ShearBase):
    """3-in/3-out lensing covariance (kappa, gamma1, gamma2)."""

    def _make(self):
        self._make_base()
        self._fn = self._with_ls(_shear.shear_33_fn)

    def __call__(self, diffs, adjust: bool = True, **kwargs):
        if adjust and diffs.shape[-2] != diffs.shape[-3]:
            # crosswise difference tensor: insert a unitary prediction dim
            diffs = diffs[..., None, :]
        return self._fn(diffs, **kwargs)

    def Kout(self, **kwargs) -> torch.Tensor:
        """``(3, 3)`` prior covariance at zero differences (f64, CPU)."""
        return self(_zero_diffs())


class ShearKernel2in3out(_ShearBase):
    """Observe the two shear components, predict (kappa, gamma1, gamma2)."""

    def _make(self):
        self._make_base()
        self._Kin_fn = self._with_ls(_shear.shear_Kin23_fn)
        self._Kcross_fn = self._with_ls(_shear.shear_Kcross23_fn)
        self._Kout_fn = self._with_ls(_shear.shear_33_fn)

    def __call__(
        self, diffs, adjust: bool = True, force_Kcross: bool = False, **kwargs
    ):
        if force_Kcross:
            return self._Kcross_fn(diffs, **kwargs)
        if adjust and diffs.shape[-2] != diffs.shape[-3]:
            return self._Kcross_fn(diffs[..., None, :], **kwargs)
        return self._Kin_fn(diffs, **kwargs)

    def Kout(self, **kwargs) -> torch.Tensor:
        """``(3, 3)`` prior covariance at zero differences (f64, CPU)."""
        return self._Kout_fn(_zero_diffs())
