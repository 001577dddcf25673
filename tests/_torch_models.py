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


def jax_shear_model(family="33", ls=0.15, ls_bounds="fixed", noise=1e-4,
                    noise_bounds="fixed", scale=None):
    """A JAX shear model: ``family`` "33" is ShearKernel with ShearNoise33,
    "23" ShearKernel2in3out with HomoscedasticNoise; ``scale`` a number for
    a trained FixedScale, "analytic" for an AnalyticScale."""
    from muygpys_tpu.gp import MuyGPS
    from muygpys_tpu.gp.deformation import DifferenceIsotropy, F2
    from muygpys_tpu.gp.hyperparameter import (
        AnalyticScale,
        FixedScale,
        Parameter,
    )
    from muygpys_tpu.gp.kernels.experimental import (
        ShearKernel,
        ShearKernel2in3out,
    )
    from muygpys_tpu.gp.noise import HomoscedasticNoise, ShearNoise33

    deformation = DifferenceIsotropy(F2, length_scale=Parameter(ls, ls_bounds))
    if scale == "analytic":
        sc = AnalyticScale()
    else:
        sc = FixedScale()
        if scale is not None:
            sc._set(scale)
    if family == "33":
        return MuyGPS(kernel=ShearKernel(deformation=deformation),
                      noise=ShearNoise33(noise, noise_bounds), scale=sc)
    return MuyGPS(kernel=ShearKernel2in3out(deformation=deformation),
                  noise=HomoscedasticNoise(noise, noise_bounds), scale=sc)


def carried_shear(jm):
    """The port's shear MuyGPS with the JAX model's values and bounds."""
    from muygpys_tpu.gp.hyperparameter import AnalyticScale
    from muygpys_tpu.gp.kernels.experimental import ShearKernel
    from muygpys_tpu.gp.noise import ShearNoise33

    def bounds(p):
        return "fixed" if p.fixed() else tuple(p.get_bounds())

    length_scale = jm.kernel.deformation.length_scale
    return muygps_from_arrays(
        length_scale=np.asarray(length_scale()),
        length_scale_bounds=bounds(length_scale),
        noise=np.asarray(jm.noise()), noise_bounds=bounds(jm.noise),
        scale=("analytic" if isinstance(jm.scale, AnalyticScale)
               else np.asarray(jm.scale())),
        kernel="shear" if isinstance(jm.kernel, ShearKernel) else "shear_2in3out",
        noise_model=("shear33" if isinstance(jm.noise, ShearNoise33)
                     else "homoscedastic"),
    )


def shear_train_tensors(model, pts, targets, bi, bni, family, asarray):
    """(batch_targets, batch_nn_targets, crosswise, pairwise) of a shear
    model of either package (``asarray`` = ``jnp.asarray`` or
    ``torch.as_tensor``): predictions are always 3-output, observations the
    last two components under "23"."""
    obs = targets if family == "33" else targets[:, 1:]
    deformation = model.kernel.deformation
    pw = deformation.pairwise_tensor(asarray(pts), asarray(bni))
    cw = deformation.crosswise_tensor(
        asarray(pts), asarray(pts), asarray(bi), asarray(bni)
    )
    return (asarray(targets), asarray(obs[bni].swapaxes(-2, -1).copy()),
            cw, pw)


def shear_problem(rng, n=48, nn=8):
    """Points, 3-component targets, batch indices and exact neighbours, as
    tests/test_shear_objective.py builds them."""
    pts = rng.uniform(size=(n, 2))
    targets = rng.normal(size=(n, 3))
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    bni = np.argsort(d, axis=1)[:, 1:nn + 1]
    return pts, targets, np.arange(n), bni
