"""The MuyGPS model: local kriging GP via nearest-neighbor conditioning.

Counterpart of :class:`muygpys_tpu.gp.muygps.MuyGPS` for serving: tensor
factory, posterior mean, variance and the fused mean + variance.  The
optimization surface (``get_opt_params``, ``optimize_scale``, the fast-mean
coefficients) waits for the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from muygpys_torch.gp.hyperparameter import FixedScale, ScaleFn
from muygpys_torch.gp.kernels import KernelFn
from muygpys_torch.gp.noise import HomoscedasticNoise
from muygpys_torch.ops import solve as _solve


class MuyGPS:
    """Local kriging GP model conditioning on nearest neighborhoods.

    Per batch element i with neighborhood N_i:
    ``mu_i = Kcross_i (Kin_i + eps)^{-1} Y_{N_i}`` and
    ``sigma_i = sigma^2 (Kout - Kcross_i (Kin_i + eps)^{-1} Kcross_i^T)``.
    """

    def __init__(
        self,
        kernel: KernelFn,
        noise=None,
        scale: Optional[ScaleFn] = None,
    ):
        self.kernel = kernel
        self.noise = noise if noise is not None else HomoscedasticNoise(0.0)
        self.scale = scale if scale is not None else FixedScale()

    def posterior_mean(self, Kin, Kcross, batch_nn_targets) -> torch.Tensor:
        return _solve.posterior_mean(
            self.noise.perturb(Kin), Kcross, batch_nn_targets
        )

    def posterior_variance(self, Kin, Kcross) -> torch.Tensor:
        return self.scale() * _solve.diagonal_variance(
            self.noise.perturb(Kin), Kcross, self.kernel.Kout()
        )

    def posterior_mean_and_variance(
        self, Kin, Kcross, batch_nn_targets
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused mean + scaled variance from ONE batched solve."""
        mean, var = _solve.serve_mean_and_variance(
            self.noise.perturb(Kin),
            Kcross,
            self.kernel.Kout(),
            batch_nn_targets,
        )
        return mean, self.scale() * var

    def make_predict_tensors(
        self,
        batch_indices,
        batch_nn_indices,
        test_features,
        train_features,
        train_targets,
    ):
        """(crosswise, pairwise, batch_nn_targets) for out-of-sample
        prediction."""
        if test_features is None:
            test_features = train_features
        deformation = self.kernel.deformation
        crosswise = deformation.crosswise_tensor(
            test_features, train_features, batch_indices, batch_nn_indices
        )
        pairwise = deformation.pairwise_tensor(
            train_features, batch_nn_indices
        )
        return crosswise, pairwise, train_targets[batch_nn_indices]
