"""The MuyGPS model: local kriging GP via nearest-neighbor conditioning.

Counterpart of :class:`muygpys_tpu.gp.muygps.MuyGPS`: tensor factories,
posterior mean, variance and the fused mean + variance, the fast posterior
mean (``fast_coefficients`` offline, ``fast_posterior_mean`` at serve time),
the optimization surface (``fixed``, ``get_opt_params``, ``get_opt_mean_fn``
/ ``get_opt_var_fn``, ``optimize_scale``) and ``__eq__``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from muygpys_torch.gp.fast_mean import FastPosteriorMean
from muygpys_torch.gp.fast_precompute import FastPrecomputeCoefficients
from muygpys_torch.gp.hyperparameter import FixedScale, ScaleFn
from muygpys_torch.gp.kernels import KernelFn
from muygpys_torch.gp.mean import PosteriorMean
from muygpys_torch.gp.noise import HomoscedasticNoise, NoiseFn
from muygpys_torch.gp.variance import PosteriorVariance
from muygpys_torch.ops import solve as _solve
from muygpys_torch.ops.lanes_solver import multiout_serve_mean_and_variance


class MuyGPS:
    """Local kriging GP model conditioning on nearest neighborhoods.

    Per batch element i with neighborhood N_i:
    ``mu_i = Kcross_i (Kin_i + eps)^{-1} Y_{N_i}`` and
    ``sigma_i = sigma^2 (Kout - Kcross_i (Kin_i + eps)^{-1} Kcross_i^T)``.
    """

    def __init__(
        self,
        kernel: KernelFn,
        noise: Optional[NoiseFn] = None,
        scale: Optional[ScaleFn] = None,
        _backend_fast_mean_fn: Callable = _solve.fast_posterior_mean,
        _backend_fast_precompute_fn: Callable = (
            _solve.fast_posterior_mean_precompute
        ),
    ):
        self.kernel = kernel
        self.noise = noise if noise is not None else HomoscedasticNoise(0.0)
        self.scale = scale if scale is not None else FixedScale()
        self._backend_fast_mean_fn = _backend_fast_mean_fn
        self._backend_fast_precompute_fn = _backend_fast_precompute_fn
        self._make()

    def _make(self) -> None:
        """Re-bake the composed closures after a parameter update."""
        self.kernel._make()
        self._mean_fn = PosteriorMean(self.noise)
        self._var_fn = PosteriorVariance(
            self.kernel.Kout(), self.noise, self.scale
        )
        self._fast_posterior_mean_fn = FastPosteriorMean(
            _backend_fn=self._backend_fast_mean_fn
        )
        self._fast_precompute_fn = FastPrecomputeCoefficients(
            self.noise, _backend_fn=self._backend_fast_precompute_fn
        )

    def fixed(self) -> bool:
        """True iff no parameter requires optimization."""
        for p in self.kernel._hyperparameters.values():
            if not p.fixed():
                return False
        return self.noise.fixed()

    def get_opt_params(
        self,
    ) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """Free hyperparameter names, values and bounds."""
        names, params, bounds = self.kernel.get_opt_params()
        self.noise.append_lists(names, params, bounds)
        return (
            names,
            np.asarray(params, float),
            np.asarray(bounds, float).reshape(-1, 2),
        )

    # --- prediction ---

    def posterior_mean(self, Kin, Kcross, batch_nn_targets, **kwargs):
        return self._mean_fn(Kin, Kcross, batch_nn_targets, **kwargs)

    def posterior_variance(self, Kin, Kcross, **kwargs):
        return self._var_fn(Kin, Kcross, **kwargs)

    def posterior_mean_and_variance(
        self, Kin, Kcross, batch_nn_targets
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused mean + scaled variance from ONE batched solve.  A
        multi-output block layout (``Kin`` 5-D, the lensing shear family)
        goes through the batch-last floored Cholesky of
        :mod:`muygpys_torch.ops.lanes_solver` and returns the full
        ``(o, o)`` covariance per query."""
        perturbed = self.noise.perturb(Kin)
        if Kin.ndim == 5:
            mean, var = multiout_serve_mean_and_variance(
                perturbed, Kcross, self.kernel.Kout(), batch_nn_targets
            )
        else:
            mean, var = _solve.serve_mean_and_variance(
                perturbed, Kcross, self.kernel.Kout(), batch_nn_targets
            )
        return mean, self.scale() * var

    def fast_coefficients(self, Kin, train_nn_targets_fast, **kwargs):
        """Offline ``C = (Kin + eps)^{-1} Y`` over self-inclusive
        neighborhoods (:func:`muygpys_torch.ops.tensors.fast_nn_update`);
        a neighborhood whose factorization fails gets NaN."""
        return self._fast_precompute_fn(Kin, train_nn_targets_fast, **kwargs)

    def fast_posterior_mean(self, Kcross, coeffs_tensor):
        """Serve-time mean: one contraction against the precomputed
        coefficients of each query's nearest training point."""
        return self._fast_posterior_mean_fn(Kcross, coeffs_tensor)

    # --- optimization surface ---

    def get_opt_mean_fn(self) -> Callable:
        return self._mean_fn.get_opt_fn()

    def get_opt_var_fn(self) -> Callable:
        return self._var_fn.get_opt_fn()

    def optimize_scale(self, pairwise_diffs, nn_targets, **kwargs) -> "MuyGPS":
        """Set sigma^2 by the scale functor's optimization method (a
        scalar sigma^2 is stored as a Python float); ``kwargs`` go to the
        kernel evaluation, as in the JAX package."""
        Kin = self.kernel(pairwise_diffs, **kwargs)
        opt_fn = self.scale.get_opt_fn(self)
        val = opt_fn(Kin, nn_targets)
        if torch.is_tensor(val) and val.numel() == 1:
            val = float(val)
        self.scale._set(val)
        self._make()
        return self

    # --- tensor factories (the deformation decides distances or
    # differences) ---

    def make_predict_tensors(
        self,
        batch_indices,
        batch_nn_indices,
        test_features,
        train_features,
        train_targets,
        **kwargs,
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

    def make_train_tensors(
        self,
        batch_indices,
        batch_nn_indices,
        train_features,
        train_targets,
        **kwargs,
    ):
        """(crosswise, pairwise, batch_targets, batch_nn_targets) for LOO
        training.  Index arrays may be numpy (as ``sample_batch`` returns
        them); they move to the features' device."""
        train_features = torch.as_tensor(train_features)
        dev = train_features.device
        batch_indices = torch.as_tensor(batch_indices, device=dev)
        batch_nn_indices = torch.as_tensor(batch_nn_indices, device=dev)
        train_targets = torch.as_tensor(train_targets, device=dev)
        deformation = self.kernel.deformation
        crosswise = deformation.crosswise_tensor(
            train_features, train_features, batch_indices, batch_nn_indices
        )
        pairwise = deformation.pairwise_tensor(
            train_features, batch_nn_indices
        )
        return (
            crosswise,
            pairwise,
            train_targets[batch_indices],
            train_targets[batch_nn_indices],
        )

    def __eq__(self, rhs) -> bool:
        """Equal type and equal kernel hyperparameter, noise and scale
        values, compared as the JAX package compares them: a multi-element
        value (heteroscedastic noise, a vector scale) raises ``ValueError``
        (the truth value of an array is ambiguous)."""
        if not isinstance(rhs, self.__class__):
            return False
        hyper = self.kernel._hyperparameters
        return all(
            (
                all(
                    _value(hyper[h]())
                    == _value(rhs.kernel._hyperparameters[h]())
                    for h in hyper
                ),
                _value(self.noise()) == _value(rhs.noise()),
                _value(self.scale()) == _value(rhs.scale()),
            )
        )


def _value(x):
    """A parameter value as numpy, so that comparing two multi-element
    values gives an array whose truth value raises ``ValueError``."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
