"""MuyGPs as a ``torch.nn.Module`` layer for deep kernel learning.

Counterpart of :mod:`muygpys_tpu.nn.muygps_layer` (a flax module there): a
layer whose trainable parameters are the GP hyperparameters, stored as logs
for positivity (``log_length_scale``, ``log_noise`` and, with
``train_smoothness``, ``log_smoothness``), and whose ``forward`` maps
embedded features to (posterior mean, variance) over fixed batch
neighbourhoods.  Matern over an Isotropy with a scalar length scale only;
a closed-form smoothness (1/2, 3/2, 5/2, infinity) evaluates its closed
form, any other (or a trained one) the general Matern through the
differentiable Bessel function :func:`muygpys_torch.ops.bessel.kve`.

The GP solve is :func:`muygpys_torch.ops.solve.posterior_mean_and_variance`
(one Cholesky factorization) under autograd, as the JAX layer uses its
library solve: no kernel of the package computes the layer.  Parameters are
made in :func:`muygpys_torch.config.ftype` on the CPU; move the module, or
apply parameters with :func:`torch.func.functional_call`, to run elsewhere.
"""

from __future__ import annotations

import math

import torch

from muygpys_torch import config
from muygpys_torch.gp.deformation.isotropy import Isotropy
from muygpys_torch.ops import kernels as _k
from muygpys_torch.ops import noise as _noise
from muygpys_torch.ops import solve as _solve

_CLOSED_FORMS = {
    0.5: _k.matern_05_fn,
    1.5: _k.matern_15_fn,
    2.5: _k.matern_25_fn,
    math.inf: _k.matern_inf_fn,
}


def _matern_fn_for(smoothness: float):
    closed = _CLOSED_FORMS.get(smoothness)
    if closed is None:
        return _k.matern_gen_fn
    return lambda d, _s: closed(d)


class MuyGPsLayer(torch.nn.Module):
    """Final GP layer: embedded features -> (mean, variance).

    Args:
        muygps_model: the MuyGPS spec giving the initial hyperparameters
            (length scale, noise, smoothness); its deformation must be an
            :class:`Isotropy` (``NotImplementedError`` otherwise).
        train_smoothness: also train the smoothness (``log_smoothness``).
    """

    def __init__(self, muygps_model, train_smoothness: bool = False):
        super().__init__()
        deformation = muygps_model.kernel.deformation
        if not isinstance(deformation, Isotropy):
            raise NotImplementedError(
                "MuyGPsLayer does not support "
                f"{type(deformation)} deformations"
            )
        self.muygps_model = muygps_model
        self.train_smoothness = train_smoothness
        self._nu0 = float(muygps_model.kernel.smoothness())
        for name, value in self.initial_values().items():
            self.register_parameter(name, torch.nn.Parameter(value))

    def initial_values(self) -> dict:
        """The parameters the spec fixes, name -> 0-d tensor in
        ``config.ftype()`` on the CPU."""
        model = self.muygps_model
        values = {
            "log_length_scale": math.log(
                float(model.kernel.deformation.length_scale())
            ),
            "log_noise": math.log(max(float(model.noise()), 1e-12)),
        }
        if self.train_smoothness:
            values["log_smoothness"] = math.log(self._nu0)
        return {
            n: torch.tensor(v, dtype=config.ftype()) for n, v in values.items()
        }

    def forward(self, x, batch_indices, batch_nn_indices, batch_nn_targets):
        """``x``: the embedded features of every point the indices
        address; returns mean ``(batch, 1)`` and variance ``(batch,)``,
        floored at 1e-10 (f64) or 1e-6 (f32): embedded points can collapse
        onto each other, and a zero or negative variance would make a
        likelihood loss NaN."""
        length_scale = torch.exp(self.log_length_scale)
        noise = torch.exp(self.log_noise)
        if self.train_smoothness:
            smoothness = torch.exp(self.log_smoothness)
            matern = _k.matern_gen_fn
        else:
            smoothness = self._nu0
            matern = _matern_fn_for(self._nu0)

        deformation = self.muygps_model.kernel.deformation
        metric = deformation.metric
        crosswise = deformation.crosswise_tensor(
            x, x, batch_indices, batch_nn_indices
        )
        pairwise = deformation.pairwise_tensor(x, batch_nn_indices)
        Kcross = matern(
            metric.apply_length_scale(crosswise, length_scale), smoothness
        )
        Kin = _noise.homoscedastic_perturb(
            matern(metric.apply_length_scale(pairwise, length_scale),
                   smoothness),
            noise,
        )
        Kout = torch.ones((), dtype=Kin.dtype, device=Kin.device)
        mean, var = _solve.posterior_mean_and_variance(
            Kin, Kcross, Kout, batch_nn_targets
        )
        eps = 1e-10 if var.dtype == torch.float64 else 1e-6
        return mean, torch.clamp_min(var, eps)


class MultivariateMuyGPsLayer(torch.nn.Module):
    """One :class:`MuyGPsLayer` per response over a shared embedding
    (sub-layers ``response_0``, ``response_1``, ...); returns means and
    variances ``(batch, responses)``."""

    def __init__(self, muygps_model, train_smoothness: bool = False):
        super().__init__()
        self.muygps_model = muygps_model
        self.train_smoothness = train_smoothness
        for i, model in enumerate(muygps_model.models):
            self.add_module(
                f"response_{i}", MuyGPsLayer(model, train_smoothness)
            )

    def forward(self, x, batch_indices, batch_nn_indices, batch_nn_targets):
        means, variances = [], []
        for i in range(len(self.muygps_model.models)):
            mean_i, var_i = getattr(self, f"response_{i}")(
                x, batch_indices, batch_nn_indices,
                batch_nn_targets[:, :, i:i + 1],
            )
            means.append(mean_i.reshape(-1))
            variances.append(var_i.reshape(-1))
        return torch.stack(means, dim=1), torch.stack(variances, dim=1)


class DeepKernelMuyGPs(torch.nn.Module):
    """An embedding network feeding a :class:`MuyGPsLayer` (``embedding``
    and ``gp_layer``, the parameter names' prefixes)."""

    def __init__(self, embedding: torch.nn.Module, muygps_model,
                 train_smoothness: bool = False):
        super().__init__()
        self.embedding = embedding
        self.muygps_model = muygps_model
        self.train_smoothness = train_smoothness
        self.gp_layer = MuyGPsLayer(muygps_model, train_smoothness)

    def embed(self, features: torch.Tensor) -> torch.Tensor:
        return self.embedding(features)

    def forward(self, train_features, batch_indices, batch_nn_indices,
                batch_nn_targets):
        return self.gp_layer(
            self.embedding(train_features), batch_indices, batch_nn_indices,
            batch_nn_targets,
        )
