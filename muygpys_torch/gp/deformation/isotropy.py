"""Isotropic deformations: one length scale over a distance or a difference
tensor.

Counterpart of :mod:`muygpys_tpu.gp.deformation.isotropy`.  ``Isotropy``'s
tensors are *distances*, assembled from indices through the metric's
Gram-identity path; ``DifferenceIsotropy``'s are the feature-wise
*differences* the shear kernels need.  The length scale is the named
parameter ``length_scale``, or a hierarchical (nonstationary) one
(:class:`muygpys_torch.gp.hyperparameter.experimental.HierarchicalParameter`),
whose knot values are the named parameters ``length_scale0``, ... and whose
per-point values need ``batch_features=`` at every kernel evaluation.
"""

from __future__ import annotations

import torch

from muygpys_torch.gp.deformation.deformation_fn import DeformationFn
from muygpys_torch.gp.deformation.metric import MetricFn
from muygpys_torch.gp.hyperparameter import NamedParameter, Parameter


class Isotropy(DeformationFn):
    """Scalar-length-scale deformation over a distance tensor."""

    def __init__(self, metric: MetricFn, length_scale: Parameter):
        from muygpys_torch.gp.hyperparameter.experimental import (
            HierarchicalParameter,
            NamedHierarchicalParameter,
        )

        if isinstance(length_scale, Parameter):
            self.length_scale = NamedParameter("length_scale", length_scale)
        elif isinstance(length_scale, HierarchicalParameter):
            self.length_scale = NamedHierarchicalParameter(
                "length_scale", length_scale
            )
        else:
            raise ValueError(
                "expected Parameter type for length_scale, not "
                f"{type(length_scale)}"
            )
        self.metric = metric

    def __call__(self, dists, length_scale=None, **kwargs):
        if length_scale is None:
            length_scale = self.length_scale(**kwargs)
        # a hierarchical length scale is one value per batch element
        if torch.is_tensor(length_scale) and length_scale.ndim > 0:
            length_scale = length_scale.reshape(
                (-1,) + (1,) * (dists.ndim - 1)
            )
        return self.metric.apply_length_scale(dists, length_scale)

    def pairwise_tensor(self, data, nn_indices):
        """Distances ``(batch, nn, nn)`` among each neighborhood."""
        return self.metric.pairwise_distances(data, nn_indices)

    def crosswise_tensor(self, data, nn_data, data_indices, nn_indices):
        """Distances ``(batch, nn)`` between batch points and neighbors."""
        return self.metric.crosswise_distances(
            data, nn_data, data_indices, nn_indices
        )


class DifferenceIsotropy(Isotropy):
    """Isotropy over feature-wise *differences* (required by the shear
    kernels, which need the raw differences before the metric collapse)."""

    def __call__(self, dists, length_scale=None, **kwargs):
        if length_scale is None:
            length_scale = self.length_scale()
        return self.metric(dists / length_scale)

    def pairwise_tensor(self, data, nn_indices):
        """Differences ``(batch, nn, nn, feat)`` among each neighborhood."""
        return self.metric.pairwise_differences(data, nn_indices)

    def crosswise_tensor(self, data, nn_data, data_indices, nn_indices):
        """Differences ``(batch, nn, feat)``."""
        return self.metric.crosswise_differences(
            data, nn_data, data_indices, nn_indices
        )
