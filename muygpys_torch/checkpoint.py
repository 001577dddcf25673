"""Model checkpoints: save and restore hyperparameters and serve state.

Counterpart of :mod:`muygpys_tpu.checkpoint`, in the same file format key
for key, so a file written by either package loads in the other: a JSON
spec of the model's structure and hyperparameters (``"inf"`` for an
infinite value), and, where the model holds arrays (heteroscedastic noise),
a ``<path>.npz`` beside it under the keys ``het_noise_<k>``.
``save_fast_state`` / ``load_fast_state`` keep the fast posterior mean's
serve state (``coeffs``, ``nn_indices``) in one ``.npz``, so a serving
process skips the offline solve.

Loading places array state on ``device`` (the card unless the caller
passes ``device="cpu"``).
"""

from __future__ import annotations

import json
import math
import os
import warnings
from typing import Dict, Tuple, Union

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gp import MultivariateMuyGPS, MuyGPS
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
from muygpys_torch.gp.noise import (
    HeteroscedasticNoise,
    HomoscedasticNoise,
    NullNoise,
    ShearNoise33,
)

_METRICS = {"l2": l2, "F2": F2}


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _param_spec(p) -> Dict:
    val = p()
    if isinstance(val, float) and math.isinf(val):
        val = "inf"
    return {
        "val": val,
        "bounds": "fixed" if p.fixed() else list(p.get_bounds()),
    }


def _param_from(spec: Dict) -> Parameter:
    val = spec["val"]
    if val == "inf":
        val = math.inf
    bounds = spec["bounds"]
    return Parameter(val, "fixed" if bounds == "fixed" else tuple(bounds))


def _metric_name(metric) -> str:
    # by declared name, not identity: a deep copy of a model clones the
    # l2/F2 metric objects
    name = getattr(metric, "name", None)
    if name in _METRICS:
        return name
    raise ValueError("unknown metric function; cannot serialize")


def _deformation_spec(d) -> Dict:
    if isinstance(d, Anisotropy):
        return {
            "type": "Anisotropy",
            "metric": _metric_name(d.metric),
            "length_scales": [
                _param_spec(p) for p in d.length_scale._params
            ],
        }
    kind = (
        "DifferenceIsotropy"
        if isinstance(d, DifferenceIsotropy)
        else "Isotropy"
    )
    return {
        "type": kind,
        "metric": _metric_name(d.metric),
        "length_scale": _param_spec(d.length_scale),
    }


def _deformation_from(spec: Dict):
    metric = _METRICS[spec["metric"]]
    if spec["type"] == "Anisotropy":
        return Anisotropy(
            metric,
            VectorParameter(
                *(_param_from(s) for s in spec["length_scales"])
            ),
        )
    cls = (
        DifferenceIsotropy
        if spec["type"] == "DifferenceIsotropy"
        else Isotropy
    )
    return cls(metric, length_scale=_param_from(spec["length_scale"]))


def _kernel_spec(k) -> Dict:
    if isinstance(k, Matern):
        return {
            "type": "Matern",
            "smoothness": _param_spec(k.smoothness),
            "deformation": _deformation_spec(k.deformation),
        }
    if isinstance(k, RBF):
        return {"type": "RBF", "deformation": _deformation_spec(k.deformation)}
    if isinstance(k, ShearKernel2in3out):
        return {
            "type": "ShearKernel2in3out",
            "deformation": _deformation_spec(k.deformation),
        }
    if isinstance(k, ShearKernel):
        return {
            "type": "ShearKernel",
            "deformation": _deformation_spec(k.deformation),
        }
    raise ValueError(f"cannot serialize kernel type {type(k)}")


def _kernel_from(spec: Dict):
    deformation = _deformation_from(spec["deformation"])
    if spec["type"] == "Matern":
        return Matern(
            smoothness=_param_from(spec["smoothness"]),
            deformation=deformation,
        )
    if spec["type"] == "RBF":
        return RBF(deformation=deformation)
    if spec["type"] == "ShearKernel":
        return ShearKernel(deformation=deformation)
    if spec["type"] == "ShearKernel2in3out":
        return ShearKernel2in3out(deformation=deformation)
    raise ValueError(f"unknown kernel type {spec['type']}")


def _noise_spec(n, arrays: Dict) -> Dict:
    if isinstance(n, ShearNoise33):
        return {"type": "ShearNoise33", **_param_spec(n)}
    if isinstance(n, HeteroscedasticNoise):
        key = f"het_noise_{len(arrays)}"
        arrays[key] = _numpy(n())
        return {"type": "HeteroscedasticNoise", "array": key}
    if isinstance(n, NullNoise):
        return {"type": "NullNoise"}
    if isinstance(n, HomoscedasticNoise):
        return {"type": "HomoscedasticNoise", **_param_spec(n)}
    raise ValueError(f"cannot serialize noise type {type(n)}")


def _noise_from(spec: Dict, arrays, device):
    if spec["type"] == "NullNoise":
        return NullNoise()
    if spec["type"] == "HeteroscedasticNoise":
        return HeteroscedasticNoise(
            torch.as_tensor(np.asarray(arrays[spec["array"]]), device=device)
        )
    bounds = spec["bounds"]
    bounds = "fixed" if bounds == "fixed" else tuple(bounds)
    cls = (
        ShearNoise33 if spec["type"] == "ShearNoise33" else HomoscedasticNoise
    )
    return cls(spec["val"], bounds)


def _scale_spec(s) -> Dict:
    out = {"val": float(_numpy(s.val)), "trained": s.trained}
    if isinstance(s, DownSampleScale):
        out["type"] = "DownSampleScale"
        out["down_count"] = s._down_count
        out["iteration_count"] = s._iteration_count
    elif isinstance(s, AnalyticScale):
        out["type"] = "AnalyticScale"
        out["iteration_count"] = s.iteration_count
    else:
        out["type"] = "FixedScale"
    return out


def _scale_from(spec: Dict):
    if spec["type"] == "DownSampleScale":
        s = DownSampleScale(
            down_count=spec["down_count"],
            iteration_count=spec["iteration_count"],
        )
    elif spec["type"] == "AnalyticScale":
        s = AnalyticScale(iteration_count=spec["iteration_count"])
    else:
        s = FixedScale()
    if spec["trained"]:
        s._set(spec["val"])
    else:
        s.val = spec["val"]
    return s


def _model_spec(m: MuyGPS, arrays: Dict) -> Dict:
    return {
        "kernel": _kernel_spec(m.kernel),
        "noise": _noise_spec(m.noise, arrays),
        "scale": _scale_spec(m.scale),
    }


def _model_args(spec: Dict, arrays, device) -> Dict:
    return {
        "kernel": _kernel_from(spec["kernel"]),
        "noise": _noise_from(spec["noise"], arrays, device),
        "scale": _scale_from(spec["scale"]),
    }


def save_model(path: str, model: Union[MuyGPS, MultivariateMuyGPS]) -> None:
    """Write a model to ``path`` (JSON), and ``path + ".npz"`` if it holds
    arrays."""
    arrays: Dict = {}
    if isinstance(model, MultivariateMuyGPS):
        spec = {
            "type": "MultivariateMuyGPS",
            "models": [_model_spec(m, arrays) for m in model.models],
        }
    else:
        spec = {"type": "MuyGPS", **_model_spec(model, arrays)}
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)
    if arrays:
        np.savez(path + ".npz", **arrays)


def load_model(path: str, device=None) -> Union[MuyGPS, MultivariateMuyGPS]:
    """Read a model written by :func:`save_model` (or by
    :func:`muygpys_tpu.checkpoint.save_model`); array state goes on
    ``device`` (default ``"cuda"``)."""
    dev = config.device(device)
    with open(path) as f:
        spec = json.load(f)
    arrays = {}
    if os.path.exists(path + ".npz"):
        arrays = dict(np.load(path + ".npz"))
    if spec["type"] == "MultivariateMuyGPS":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return MultivariateMuyGPS(
                *(_model_args(s, arrays, dev) for s in spec["models"])
            )
    return MuyGPS(**_model_args(spec, arrays, dev))


def save_fast_state(path: str, coeffs, nn_indices) -> None:
    """Persist the fast posterior mean's serve state."""
    np.savez(path, coeffs=_numpy(coeffs), nn_indices=_numpy(nn_indices))


def load_fast_state(path: str, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(coeffs, nn_indices)`` as written by :func:`save_fast_state` (or
    by the JAX package's), as tensors on ``device`` (default ``"cuda"``)
    holding the file's bits and dtypes."""
    dev = config.device(device)
    data = np.load(path)
    return (
        torch.as_tensor(data["coeffs"], device=dev),
        torch.as_tensor(data["nn_indices"], device=dev),
    )
