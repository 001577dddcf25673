"""Carry a model across from plain arrays, and its values back out.

A model built or trained elsewhere (for example by :mod:`muygpys_tpu`, read
through its own getters ``deformation.length_scale()``, ``get_bounds()``,
``kernel.smoothness()``, ``noise()``, ``scale()``) is rebuilt here from
numpy numbers and strings, so no object of the other package crosses over:
a trained model with fixed values, or a model still to be trained with its
free parameters' bounds and an analytic or down-sampled scale.
:func:`arrays_from_muygps` returns a model's values as numpy numbers.
:func:`mmuygps_from_arrays` and :func:`arrays_from_mmuygps` do the same for
a :class:`MultivariateMuyGPS`, one spec per response.
:func:`deep_kernel_params_from_flax` carries a deep-kernel model's flax
parameter tree (as numpy arrays) over to the port's parameter dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from muygpys_torch import config

from muygpys_torch.gp.deformation import (
    Anisotropy,
    DifferenceIsotropy,
    F2,
    Isotropy,
    l2,
)
from muygpys_torch.gp.hyperparameter import (
    AnalyticScale,
    DownSampleScale,
    FixedScale,
    Parameter,
    VectorParameter,
)
from muygpys_torch.gp.kernels import Matern, RBF
from muygpys_torch.gp.kernels.experimental import (
    ShearKernel,
    ShearKernel2in3out,
)
from muygpys_torch.gp.multivariate_muygps import MultivariateMuyGPS
from muygpys_torch.gp.muygps import MuyGPS
from muygpys_torch.gp.noise import (
    HeteroscedasticNoise,
    HomoscedasticNoise,
    NullNoise,
    ShearNoise33,
)

_METRICS = {"l2": l2, "F2": F2}
_SHEAR_KERNELS = {"shear": ShearKernel, "shear_2in3out": ShearKernel2in3out}
_NOISE_MODELS = {
    "homoscedastic": HomoscedasticNoise,
    "shear33": ShearNoise33,
    "null": NullNoise,
}
_SCALE_MODELS = {"analytic": AnalyticScale, "downsample": DownSampleScale}


def _bounds(b):
    # a string goes through as it is: Parameter takes "fixed" and raises
    # on any other
    return b if isinstance(b, str) else tuple(float(v) for v in b)


def muygps_from_arrays(
    length_scale,
    noise=None,
    scale=1.0,
    smoothness=None,
    kernel: str = "matern",
    metric: str = "l2",
    measurement_noise: Optional[np.ndarray] = None,
    length_scale_bounds="fixed",
    noise_bounds="fixed",
    smoothness_bounds="fixed",
    noise_model: str = "homoscedastic",
    scale_kwargs: Optional[Dict] = None,
) -> MuyGPS:
    """Build a :class:`MuyGPS` from numbers.

    Args:
        length_scale: scalar (isotropic) or one value per feature
            (anisotropic).
        noise: homoscedastic nugget; ignored when ``measurement_noise`` is
            given.
        scale: a trained variance scale sigma^2 (a ``FixedScale`` carrying
            it), or ``"analytic"`` / ``"downsample"`` for an
            ``AnalyticScale`` / ``DownSampleScale`` to be optimized.
        smoothness: Matern nu, any positive order (0.5, 1.5, 2.5 and inf
            use their closed forms when fixed); unused for RBF.
        kernel: ``"matern"``, ``"rbf"``, or a lensing shear kernel,
            ``"shear"`` (:class:`ShearKernel`) or ``"shear_2in3out"``
            (:class:`ShearKernel2in3out`): these sit on a
            ``DifferenceIsotropy(F2, ...)`` whatever ``metric`` says, and
            ``length_scale`` is a scalar (the squared RBF length scale).
        metric: ``"l2"`` or ``"F2"``.
        measurement_noise: heteroscedastic per-neighbor noise tensor; makes
            the model heteroscedastic.
        length_scale_bounds: ``"fixed"`` or ``(lower, upper)``; anisotropic
            models take one such entry per feature or one shared by all.
        noise_bounds: ``"fixed"`` or ``(lower, upper)``.
        smoothness_bounds: ``"fixed"`` or ``(lower, upper)``: a free Matern
            smoothness, trained with the other free parameters.
        noise_model: ``"homoscedastic"``, ``"shear33"``
            (:class:`ShearNoise33`, twice the nugget on the convergence
            block of a ``"shear"`` model) or ``"null"`` (:class:`NullNoise`,
            no nugget; ``noise`` is ignored).
        scale_kwargs: constructor arguments of the ``"analytic"`` or
            ``"downsample"`` scale (``iteration_count``, ``down_count``).
    """
    if noise_model not in _NOISE_MODELS:
        raise ValueError(
            f"unknown noise model {noise_model!r} (homoscedastic, shear33, "
            "null)"
        )
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r} (l2, F2)")
    ls = np.asarray(length_scale, dtype=float)
    if kernel in _SHEAR_KERNELS:
        if ls.ndim != 0:
            raise ValueError("a shear kernel takes a scalar length scale")
        deformation = DifferenceIsotropy(
            F2, length_scale=Parameter(float(ls), _bounds(length_scale_bounds))
        )
    elif ls.ndim == 0:
        deformation = Isotropy(
            _METRICS[metric],
            length_scale=Parameter(float(ls), _bounds(length_scale_bounds)),
        )
    else:
        per = length_scale_bounds
        if isinstance(per, str) or all(
            isinstance(v, (int, float)) for v in per
        ):
            per = [per] * len(ls)  # one entry shared by every feature
        deformation = Anisotropy(
            _METRICS[metric],
            length_scale=VectorParameter(*(
                Parameter(float(v), _bounds(b)) for v, b in zip(ls, per)
            )),
        )
    if kernel == "matern":
        kern = Matern(
            smoothness=Parameter(
                float(np.asarray(smoothness)), _bounds(smoothness_bounds)
            ),
            deformation=deformation,
        )
    elif kernel == "rbf":
        kern = RBF(deformation=deformation)
    elif kernel in _SHEAR_KERNELS:
        kern = _SHEAR_KERNELS[kernel](deformation=deformation)
    else:
        raise ValueError(
            f"unknown kernel {kernel!r} (matern, rbf, shear, shear_2in3out)"
        )
    if measurement_noise is not None:
        noise_fn = HeteroscedasticNoise(np.asarray(measurement_noise))
    elif noise_model == "null":
        noise_fn = NullNoise()
    else:
        noise_fn = _NOISE_MODELS[noise_model](
            float(np.asarray(noise)), _bounds(noise_bounds)
        )
    if isinstance(scale, str):
        if scale not in _SCALE_MODELS:
            raise ValueError(
                f"unknown scale {scale!r} (a number, 'analytic', "
                "'downsample')"
            )
        scale_fn = _SCALE_MODELS[scale](**(scale_kwargs or {}))
    else:
        scale_fn = FixedScale()
        scale_fn._set(float(np.asarray(scale).reshape(-1)[0]))
    return MuyGPS(kernel=kern, noise=noise_fn, scale=scale_fn)


def arrays_from_muygps(muygps: MuyGPS) -> Dict[str, object]:
    """The model's values as numpy numbers: ``length_scale`` (a float, or
    an array under anisotropy), ``noise`` (a float, or the heteroscedastic
    array), ``scale`` and, for Matern, ``smoothness``; and the strings
    ``kernel`` and ``noise_model`` as :func:`muygps_from_arrays` takes
    them (``"heteroscedastic"`` for a model built from
    ``measurement_noise``, ``"null"`` for :class:`NullNoise`)."""
    kernel = muygps.kernel
    ls = np.asarray(kernel.deformation.length_scale(), dtype=float)
    noise = muygps.noise()
    out = {
        "length_scale": float(ls) if ls.ndim == 0 else ls,
        "noise": (
            noise.cpu().numpy() if isinstance(muygps.noise, HeteroscedasticNoise)
            else float(noise)
        ),
        "scale": float(np.asarray(muygps.scale()).reshape(-1)[0]),
    }
    if isinstance(kernel, Matern):
        out["smoothness"] = float(kernel.smoothness())
    out["kernel"] = (
        "shear" if isinstance(kernel, ShearKernel)
        else "shear_2in3out" if isinstance(kernel, ShearKernel2in3out)
        else "rbf" if isinstance(kernel, RBF) else "matern"
    )
    out["noise_model"] = (
        "shear33" if isinstance(muygps.noise, ShearNoise33)
        else "heteroscedastic"
        if isinstance(muygps.noise, HeteroscedasticNoise)
        else "null" if isinstance(muygps.noise, NullNoise)
        else "homoscedastic"
    )
    return out


def mmuygps_from_arrays(specs: Sequence[Dict]) -> MultivariateMuyGPS:
    """A :class:`MultivariateMuyGPS` with one model per response, each
    built by :func:`muygps_from_arrays` from one dict of its arguments."""
    models = [muygps_from_arrays(**spec) for spec in specs]
    return MultivariateMuyGPS(*(
        {"kernel": m.kernel, "noise": m.noise, "scale": m.scale}
        for m in models
    ))


def arrays_from_mmuygps(mmuygps: MultivariateMuyGPS) -> List[Dict]:
    """Each response model's values, as :func:`arrays_from_muygps` gives
    them."""
    return [arrays_from_muygps(m) for m in mmuygps.models]


def _gp_layer_params(prefix: str, layer, tree: Dict) -> Dict:
    names = set(layer.initial_values())
    if set(tree) != names:
        raise ValueError(
            f"{prefix or 'the layer'}: flax parameters {sorted(tree)} are "
            f"not the layer's {sorted(names)}"
        )
    out = {}
    for name in names:
        value = np.asarray(tree[name], dtype=np.float64)
        if value.shape != ():
            raise ValueError(f"{prefix}{name}: shape {value.shape}, not ()")
        out[prefix + name] = torch.tensor(value, dtype=config.ftype())
    return out


def _dense_params(prefix: str, embedding, tree: Dict) -> Dict:
    """flax's ``Dense_0``, ``Dense_1``, ... onto the embedding's
    ``torch.nn.Linear`` modules in their registration order; a flax kernel
    is ``(in, out)`` and a torch weight ``(out, in)``."""
    linears = [(n, m) for n, m in embedding.named_modules()
               if isinstance(m, torch.nn.Linear)]
    keys = [f"Dense_{i}" for i in range(len(tree))]
    if sorted(tree) != sorted(keys) or len(keys) != len(linears):
        raise ValueError(
            f"{prefix}: flax layers {sorted(tree)} do not map onto the "
            f"module's {len(linears)} torch.nn.Linear layers"
        )
    mapped = {f"{n}.weight" if n else "weight" for n, _ in linears} | {
        f"{n}.bias" if n else "bias" for n, m in linears if m.bias is not None
    }
    unmapped = [n for n, _ in embedding.named_parameters()
                if n not in mapped]
    if unmapped:
        raise ValueError(f"{prefix}: no flax parameters for {unmapped}")
    out = {}
    for key, (name, linear) in zip(keys, linears):
        dot = f"{prefix}{name}." if name else prefix
        kernel = np.asarray(tree[key]["kernel"], dtype=np.float64).T
        if kernel.shape != tuple(linear.weight.shape):
            raise ValueError(
                f"{prefix}{key}: kernel (in, out) = {kernel.T.shape} against "
                f"the torch weight (out, in) = {tuple(linear.weight.shape)}"
            )
        out[dot + "weight"] = torch.tensor(kernel, dtype=config.ftype())
        has_bias = "bias" in tree[key]
        if has_bias != (linear.bias is not None):
            raise ValueError(f"{prefix}{key}: bias in one model only")
        if has_bias:
            bias = np.asarray(tree[key]["bias"], dtype=np.float64)
            if bias.shape != tuple(linear.bias.shape):
                raise ValueError(
                    f"{prefix}{key}: bias {bias.shape} against "
                    f"{tuple(linear.bias.shape)}"
                )
            out[dot + "bias"] = torch.tensor(bias, dtype=config.ftype())
    return out


def deep_kernel_params_from_flax(flax_params: Dict, model) -> Dict:
    """The port's parameter dict (name -> tensor in ``config.ftype()`` on
    the CPU) for ``model`` from the JAX package's flax parameter tree of
    the same model, its leaves as numpy arrays:
    ``{"params": {"embedding": {"Dense_i": {"kernel", "bias"}},
    "gp_layer": {"log_length_scale", "log_noise"[, "log_smoothness"]}}}``
    for a :class:`~muygpys_torch.nn.DeepKernelMuyGPs`, ``{"params":
    {"response_i": {...}}}`` for a
    :class:`~muygpys_torch.nn.MultivariateMuyGPsLayer`, the layer's own
    names for a :class:`~muygpys_torch.nn.MuyGPsLayer`.  Raises
    ``ValueError`` when a count or shape does not match."""
    from muygpys_torch.nn import (
        DeepKernelMuyGPs,
        MultivariateMuyGPsLayer,
        MuyGPsLayer,
    )

    tree = flax_params.get("params", flax_params)
    if isinstance(model, DeepKernelMuyGPs):
        if set(tree) != {"embedding", "gp_layer"}:
            raise ValueError(
                f"flax tree {sorted(tree)}: expected embedding, gp_layer"
            )
        return {
            **_dense_params("embedding.", model.embedding, tree["embedding"]),
            **_gp_layer_params("gp_layer.", model.gp_layer, tree["gp_layer"]),
        }
    if isinstance(model, MultivariateMuyGPsLayer):
        keys = [f"response_{i}" for i in range(len(model.muygps_model.models))]
        if sorted(tree) != sorted(keys):
            raise ValueError(f"flax tree {sorted(tree)}: expected {keys}")
        out = {}
        for key in keys:
            out.update(_gp_layer_params(f"{key}.", getattr(model, key),
                                        tree[key]))
        return out
    if isinstance(model, MuyGPsLayer):
        return _gp_layer_params("", model, tree)
    raise ValueError(f"no flax parameter layout for {type(model).__name__}")
