"""Carry a trained model across from plain arrays.

A model trained elsewhere (for example by :mod:`muygpys_tpu`, read through
its own getters ``deformation.length_scale()``, ``kernel.smoothness()``,
``noise()``, ``scale()``) is rebuilt here from numpy arrays and strings, so
no object of the other package crosses over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from muygpys_torch.gp.deformation import Anisotropy, F2, Isotropy, l2
from muygpys_torch.gp.hyperparameter import (
    FixedScale,
    Parameter,
    VectorParameter,
)
from muygpys_torch.gp.kernels import Matern, RBF
from muygpys_torch.gp.muygps import MuyGPS
from muygpys_torch.gp.noise import HeteroscedasticNoise, HomoscedasticNoise

_METRICS = {"l2": l2, "F2": F2}


def muygps_from_arrays(
    length_scale,
    noise=None,
    scale=1.0,
    smoothness=None,
    kernel: str = "matern",
    metric: str = "l2",
    measurement_noise: Optional[np.ndarray] = None,
) -> MuyGPS:
    """Build a :class:`MuyGPS` from trained values.

    Args:
        length_scale: scalar (isotropic) or one value per feature
            (anisotropic).
        noise: homoscedastic nugget; ignored when ``measurement_noise`` is
            given.
        scale: trained variance scale sigma^2.
        smoothness: Matern nu (closed forms only); unused for RBF.
        kernel: ``"matern"`` or ``"rbf"``.
        metric: ``"l2"`` or ``"F2"``.
        measurement_noise: heteroscedastic per-neighbor noise tensor; makes
            the model heteroscedastic.
    """
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r} (l2, F2)")
    ls = np.asarray(length_scale, dtype=float)
    if ls.ndim == 0:
        deformation = Isotropy(
            _METRICS[metric], length_scale=Parameter(float(ls))
        )
    else:
        deformation = Anisotropy(
            _METRICS[metric],
            length_scale=VectorParameter(*(Parameter(float(v)) for v in ls)),
        )
    if kernel == "matern":
        kern = Matern(
            smoothness=Parameter(float(np.asarray(smoothness))),
            deformation=deformation,
        )
    elif kernel == "rbf":
        kern = RBF(deformation=deformation)
    else:
        raise ValueError(f"unknown kernel {kernel!r} (matern, rbf)")
    if measurement_noise is not None:
        noise_fn = HeteroscedasticNoise(np.asarray(measurement_noise))
    else:
        noise_fn = HomoscedasticNoise(float(np.asarray(noise)))
    scale_fn = FixedScale()
    scale_fn._set(float(np.asarray(scale).reshape(-1)[0]))
    return MuyGPS(kernel=kern, noise=noise_fn, scale=scale_fn)
