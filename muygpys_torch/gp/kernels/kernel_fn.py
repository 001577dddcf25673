"""Kernel functor base class.

Counterpart of :class:`muygpys_tpu.gp.kernels.KernelFn`: a kernel owns a
deformation and evaluates ``k(deformation(tensor))``.
"""

from __future__ import annotations


class KernelFn:
    """Base kernel functor: a deformation plus a scalar kernel function."""

    def __init__(self, deformation):
        self.deformation = deformation

    def _kernel_fn(self, dists):
        raise NotImplementedError

    def __call__(self, diffs):
        """Evaluate the kernel on a (pairwise or crosswise) distance or
        difference tensor, as dictated by the deformation."""
        return self._kernel_fn(self.deformation(diffs))

    def Kout(self) -> float:
        """Prior variance of an observable: 1."""
        return 1.0
