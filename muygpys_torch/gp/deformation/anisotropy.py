"""Anisotropic deformation: per-feature length scales.

Counterpart of :class:`muygpys_tpu.gp.deformation.Anisotropy`: the tensors
are feature *differences*, scaled per feature before the metric collapse.
The length scales are the named parameters ``length_scale0``,
``length_scale1``, ...
"""

from __future__ import annotations

import torch

from muygpys_torch.gp.deformation.deformation_fn import DeformationFn
from muygpys_torch.gp.deformation.metric import MetricFn
from muygpys_torch.gp.hyperparameter import (
    NamedVectorParameter,
    VectorParameter,
)


class Anisotropy(DeformationFn):
    """Vector-length-scale deformation over feature-difference tensors."""

    def __init__(self, metric: MetricFn, length_scale: VectorParameter):
        if not isinstance(length_scale, VectorParameter):
            raise ValueError(
                "expected VectorParameter type for length_scale, not "
                f"{type(length_scale)}"
            )
        self.metric = metric
        self.length_scale = NamedVectorParameter("length_scale", length_scale)

    def __call__(self, diffs, **length_scales):
        if diffs.shape[-1] != len(self.length_scale):
            raise ValueError(
                f"difference tensor of shape {tuple(diffs.shape)} must have "
                f"final dimension size of {len(self.length_scale)}"
            )
        ls = torch.stack([
            torch.as_tensor(v, dtype=diffs.dtype, device=diffs.device)
            for v in self.length_scale.values(**length_scales)
        ])
        return self.metric(diffs / ls)

    def pairwise_tensor(self, data, nn_indices):
        """Differences ``(batch, nn, nn, feat)``."""
        return self.metric.pairwise_differences(data, nn_indices)

    def crosswise_tensor(self, data, nn_data, data_indices, nn_indices):
        """Differences ``(batch, nn, feat)``."""
        return self.metric.crosswise_differences(
            data, nn_data, data_indices, nn_indices
        )
