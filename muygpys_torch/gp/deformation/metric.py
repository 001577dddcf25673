"""Metric functors bundling difference collapse with length-scale
application and the fused Gram-identity distance assembly.

Counterpart of :mod:`muygpys_tpu.gp.deformation.metric` (``l2``, ``F2``).
"""

from __future__ import annotations

from typing import Callable

from muygpys_torch.ops import tensors as _t


class MetricFn:
    """Bundles feature-difference collapse + length-scale application."""

    def __init__(
        self,
        differences_metric_fn: Callable,
        apply_length_scale_fn: Callable,
        pairwise_from_indices_fn: Callable,
        crosswise_from_indices_fn: Callable,
        name: str,
    ):
        self.name = name
        self._differences_metric_fn = differences_metric_fn
        self._apply_length_scale_fn = apply_length_scale_fn
        self._pairwise_from_indices_fn = pairwise_from_indices_fn
        self._crosswise_from_indices_fn = crosswise_from_indices_fn

    def __call__(self, diffs):
        """Collapse a feature-difference tensor to distances."""
        return self._differences_metric_fn(diffs)

    def crosswise_distances(self, data, nn_data, data_indices, nn_indices):
        """Distances ``(batch, nn)`` assembled straight from indices."""
        return self._crosswise_from_indices_fn(
            data, nn_data, data_indices, nn_indices
        )

    def pairwise_distances(self, data, nn_indices):
        """Distances ``(batch, nn, nn)`` assembled straight from indices."""
        return self._pairwise_from_indices_fn(data, nn_indices)

    def crosswise_differences(self, data, nn_data, data_indices, nn_indices):
        return _t.crosswise_diffs(data, nn_data, data_indices, nn_indices)

    def pairwise_differences(self, data, nn_indices):
        return _t.pairwise_diffs(data, nn_indices)

    def apply_length_scale(self, dists, length_scale):
        return self._apply_length_scale_fn(dists, length_scale)


l2 = MetricFn(
    differences_metric_fn=_t.l2,
    apply_length_scale_fn=lambda dists, ls: dists / ls,
    pairwise_from_indices_fn=lambda data, nn_indices: _t.safe_sqrt(
        _t.pairwise_F2(data, nn_indices)
    ),
    crosswise_from_indices_fn=lambda d, nd, di, ni: _t.safe_sqrt(
        _t.crosswise_F2(d, nd, di, ni)
    ),
    name="l2",
)
"""Euclidean distance metric; ``apply_length_scale = d / ls``."""

F2 = MetricFn(
    differences_metric_fn=_t.F2,
    apply_length_scale_fn=lambda dists, ls: dists / (ls**2),
    pairwise_from_indices_fn=_t.pairwise_F2,
    crosswise_from_indices_fn=_t.crosswise_F2,
    name="F2",
)
"""Squared-Euclidean metric; ``apply_length_scale = d / ls^2``."""
