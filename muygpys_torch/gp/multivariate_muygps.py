"""Multivariate MuyGPS: one kernel per response dimension.

Counterpart of :class:`muygpys_tpu.gp.MultivariateMuyGPS` (deprecated there
in favour of the flattened multi-output kernels, and here too): a list of
per-response :class:`MuyGPS` models over one shared tensor format, with
per-response posterior means and variances, fast-mean coefficients
``(train, nn, response)`` and their serve-time contraction.
"""

from __future__ import annotations

from typing import Tuple
from warnings import warn

import torch

from muygpys_torch.gp.muygps import MuyGPS
from muygpys_torch.ops.solve import mmuygps_fast_posterior_mean


class MultivariateMuyGPS:
    """A list of per-response-dimension MuyGPS models with a joint
    surface.  Each positional argument is a dict of :class:`MuyGPS`
    constructor arguments (``kernel``, ``noise``, ``scale``, ...)."""

    def __init__(self, *model_args):
        warn(
            f"{self.__class__.__name__} is deprecated and will be removed.",
            DeprecationWarning,
            stacklevel=2,
        )
        self.models = [MuyGPS(**args) for args in model_args]

    def fixed(self) -> bool:
        return all(model.fixed() for model in self.models)

    def posterior_mean(
        self, pairwise_diffs, crosswise_diffs, batch_nn_targets
    ) -> torch.Tensor:
        """``(batch_count, response_count)`` posterior means, one model per
        response column."""
        cols = []
        for i, model in enumerate(self.models):
            Kin = model.kernel(pairwise_diffs)
            Kcross = model.kernel(crosswise_diffs)
            cols.append(
                model.posterior_mean(
                    Kin, Kcross, batch_nn_targets[:, :, i:i + 1]
                ).reshape(-1)
            )
        return torch.stack(cols, dim=1)

    def posterior_variance(
        self, pairwise_diffs, crosswise_diffs
    ) -> torch.Tensor:
        """``(batch_count, response_count)`` scaled posterior variances."""
        cols = []
        for model in self.models:
            Kin = model.kernel(pairwise_diffs)
            Kcross = model.kernel(crosswise_diffs)
            cols.append(model.posterior_variance(Kin, Kcross).reshape(-1))
        return torch.stack(cols, dim=1)

    def fast_coefficients(
        self, pairwise_diffs_fast, train_nn_targets_fast
    ) -> torch.Tensor:
        """``(train_count, nn_count, response_count)`` precomputed
        solves."""
        cols = []
        for i, model in enumerate(self.models):
            Kin = model.kernel(pairwise_diffs_fast)
            cols.append(
                model.fast_coefficients(
                    Kin, train_nn_targets_fast[:, :, i:i + 1]
                )
            )
        return torch.stack(cols, dim=-1)

    def fast_posterior_mean(self, crosswise_diffs, coeffs_tensor):
        """Serve-time means with one Kcross per response:
        ``(batch, response)``."""
        Kcross = torch.stack(
            [model.kernel(crosswise_diffs) for model in self.models], dim=-1
        )
        return mmuygps_fast_posterior_mean(Kcross, coeffs_tensor)

    def optimize_scale(self, pairwise_diffs, nn_targets):
        """Optimize each model's sigma^2 on its response column."""
        for i, model in enumerate(self.models):
            model.optimize_scale(pairwise_diffs, nn_targets[:, :, i:i + 1])
        return self

    def make_predict_tensors(
        self,
        batch_indices,
        batch_nn_indices,
        test_features,
        train_features,
        train_targets,
        **kwargs,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Delegates to the first model (every model shares the
        deformation's tensor format)."""
        return self.models[0].make_predict_tensors(
            batch_indices,
            batch_nn_indices,
            test_features,
            train_features,
            train_targets,
            **kwargs,
        )

    def make_train_tensors(
        self,
        batch_indices,
        batch_nn_indices,
        train_features,
        train_targets,
        **kwargs,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.models[0].make_train_tensors(
            batch_indices,
            batch_nn_indices,
            train_features,
            train_targets,
            **kwargs,
        )
