"""Null deformation: pass-through for pre-deformed inputs.

Counterpart of :class:`muygpys_tpu.gp.deformation.NullDeformation`.
"""

from __future__ import annotations

from muygpys_torch.gp.deformation.deformation_fn import DeformationFn


class NullDeformation(DeformationFn):
    """Identity deformation with no hyperparameters."""

    def __init__(self):
        self.length_scale = None

    def __call__(self, dists, **kwargs):
        return dists

    def pairwise_tensor(self, data, nn_indices, **kwargs):
        raise NotImplementedError(
            "NullDeformation does not support tensor assembly"
        )

    def crosswise_tensor(
        self, data, nn_data, data_indices, nn_indices, **kwargs
    ):
        raise NotImplementedError(
            "NullDeformation does not support tensor assembly"
        )
