"""Deformation base class.

Counterpart of :class:`muygpys_tpu.gp.deformation.DeformationFn`.
"""

from __future__ import annotations


class DeformationFn:
    """Base class bundling a metric with length-scale hyperparameters.

    Subclasses implement ``__call__`` (apply length scales to an assembled
    tensor), ``pairwise_tensor`` and ``crosswise_tensor`` (assemble the
    tensor format the deformation consumes: distances for :class:`Isotropy`,
    feature-wise differences for :class:`Anisotropy` and
    :class:`DifferenceIsotropy`).
    """

    def __call__(self, dists, **kwargs):
        raise NotImplementedError

    def pairwise_tensor(self, data, nn_indices, **kwargs):
        raise NotImplementedError

    def crosswise_tensor(
        self, data, nn_data, data_indices, nn_indices, **kwargs
    ):
        raise NotImplementedError

    def __str__(self):
        attrs = ", ".join(
            f"{k}={v}" for k, v in vars(self).items() if not k.startswith("_")
        )
        return f"{type(self).__name__}({attrs})"
