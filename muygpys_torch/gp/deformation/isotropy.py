"""Isotropic deformation: one length scale over a distance tensor.

Counterpart of :class:`muygpys_tpu.gp.deformation.Isotropy`: the tensors are
*distances*, assembled from indices through the metric's Gram-identity path.
"""

from __future__ import annotations

from muygpys_torch.gp.deformation.metric import MetricFn
from muygpys_torch.gp.hyperparameter import Parameter


class Isotropy:
    """Scalar-length-scale deformation over a distance tensor."""

    def __init__(self, metric: MetricFn, length_scale: Parameter):
        if not isinstance(length_scale, Parameter):
            raise ValueError(
                "expected Parameter type for length_scale, not "
                f"{type(length_scale)}"
            )
        self.metric = metric
        self.length_scale = length_scale

    def __call__(self, dists, length_scale=None):
        if length_scale is None:
            length_scale = self.length_scale()
        return self.metric.apply_length_scale(dists, length_scale)

    def pairwise_tensor(self, data, nn_indices):
        """Distances ``(batch, nn, nn)`` among each neighborhood."""
        return self.metric.pairwise_distances(data, nn_indices)

    def crosswise_tensor(self, data, nn_data, data_indices, nn_indices):
        """Distances ``(batch, nn)`` between batch points and neighbors."""
        return self.metric.crosswise_distances(
            data, nn_data, data_indices, nn_indices
        )
