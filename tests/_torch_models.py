"""Paired models for the port's tests: one trained model built in
:mod:`muygpys_tpu` and carried across to :mod:`muygpys_torch` through
``convert.muygps_from_arrays`` and the JAX model's own getters."""

import numpy as np

from muygpys_torch.convert import muygps_from_arrays


def jax_model(kernel="matern", nu=1.5, ls=0.5, noise=1e-3, scale=2.0,
              metric="l2", hetero=None):
    """A trained JAX MuyGPS.  ``ls`` scalar -> Isotropy, sequence ->
    Anisotropy; ``hetero`` an array -> HeteroscedasticNoise."""
    from muygpys_tpu.gp import MuyGPS
    from muygpys_tpu.gp.deformation import F2, Anisotropy, Isotropy, l2
    from muygpys_tpu.gp.hyperparameter import (
        FixedScale,
        Parameter,
        VectorParameter,
    )
    from muygpys_tpu.gp.kernels import RBF, Matern
    from muygpys_tpu.gp.noise import HeteroscedasticNoise, HomoscedasticNoise

    m = {"l2": l2, "F2": F2}[metric]
    if np.ndim(ls) == 0:
        deformation = Isotropy(m, length_scale=Parameter(ls))
    else:
        deformation = Anisotropy(
            m, length_scale=VectorParameter(*(Parameter(v) for v in ls))
        )
    if kernel == "rbf":
        kern = RBF(deformation=deformation)
    else:
        kern = Matern(smoothness=Parameter(nu), deformation=deformation)
    sc = FixedScale()
    sc._set(scale)
    noise_fn = (
        HomoscedasticNoise(noise) if hetero is None
        else HeteroscedasticNoise(np.asarray(hetero))
    )
    return MuyGPS(kernel=kern, noise=noise_fn, scale=sc)


def carried(jm):
    """The port's MuyGPS with the JAX model's trained values."""
    from muygpys_tpu.gp.kernels import RBF
    from muygpys_tpu.gp.noise import HeteroscedasticNoise

    deformation = jm.kernel.deformation
    is_rbf = isinstance(jm.kernel, RBF)
    hetero = isinstance(jm.noise, HeteroscedasticNoise)
    return muygps_from_arrays(
        length_scale=np.asarray(deformation.length_scale()),
        noise=None if hetero else np.asarray(jm.noise()),
        scale=np.asarray(jm.scale()),
        smoothness=None if is_rbf else np.asarray(jm.kernel.smoothness()),
        kernel="rbf" if is_rbf else "matern",
        metric=deformation.metric.name,
        measurement_noise=np.asarray(jm.noise()) if hetero else None,
    )
