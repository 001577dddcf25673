"""muygpys_torch.convert.muygps_from_arrays: a trained JAX model carried
across through its own getters builds the same model."""

import math

import numpy as np
import pytest

from _torch_models import carried, jax_model

from muygpys_torch.convert import arrays_from_muygps, muygps_from_arrays
from muygpys_torch.gp.deformation import Anisotropy, Isotropy
from muygpys_torch.gp.kernels import Matern, RBF
from muygpys_torch.gp.noise import HeteroscedasticNoise, HomoscedasticNoise


@pytest.mark.parametrize(
    "spec",
    [dict(nu=0.5), dict(nu=math.inf, ls=(0.2, 0.3, 0.4)),
     dict(kernel="rbf", metric="F2"), dict(nu=1.2), dict(nu=4.8, ls=(0.2, 0.3)),
     dict(nu=2.5, hetero=np.full((3, 4), 0.01), scale=0.3)],
)
def test_carried_model_matches(spec):
    jm = jax_model(**spec)
    tm = carried(jm)
    jd, td = jm.kernel.deformation, tm.kernel.deformation
    assert td.metric.name == jd.metric.name
    np.testing.assert_array_equal(
        np.asarray(td.length_scale()), np.asarray(jd.length_scale())
    )
    assert isinstance(td, Anisotropy if np.ndim(jd.length_scale()) else Isotropy)
    assert isinstance(tm.kernel, RBF if spec.get("kernel") == "rbf" else Matern)
    if isinstance(tm.kernel, Matern):
        assert tm.kernel.smoothness() == float(jm.kernel.smoothness())
    assert tm.scale() == float(np.asarray(jm.scale()))
    if "hetero" in spec:
        assert isinstance(tm.noise, HeteroscedasticNoise)
        np.testing.assert_array_equal(tm.noise().numpy(), np.asarray(jm.noise()))
    else:
        assert isinstance(tm.noise, HomoscedasticNoise)
        assert tm.noise() == float(jm.noise())


@pytest.mark.parametrize(
    "family,analytic", [("33", False), ("23", False), ("33", True)]
)
def test_carried_shear_model_matches(family, analytic):
    """A JAX shear model crosses over as numbers and strings, with its free
    parameters' bounds, and reads back out."""
    from _torch_models import carried_shear, jax_shear_model

    from muygpys_torch.gp.deformation import DifferenceIsotropy
    from muygpys_torch.gp.hyperparameter import AnalyticScale, FixedScale
    from muygpys_torch.gp.kernels.experimental import (
        ShearKernel,
        ShearKernel2in3out,
    )
    from muygpys_torch.gp.noise import ShearNoise33

    jm = jax_shear_model(
        family, ls=0.05, ls_bounds=(0.005, 0.5), noise=320.0,
        scale="analytic" if analytic else 1.7,
    )
    tm = carried_shear(jm)
    assert isinstance(tm.kernel.deformation, DifferenceIsotropy)
    assert tm.kernel.deformation.metric.name == "F2"
    assert isinstance(
        tm.kernel, ShearKernel if family == "33" else ShearKernel2in3out
    )
    assert isinstance(tm.noise, ShearNoise33) == (family == "33")
    assert isinstance(tm.noise, HomoscedasticNoise)
    assert isinstance(tm.scale, AnalyticScale if analytic else FixedScale)
    j_names, j_vals, j_bounds = jm.get_opt_params()
    t_names, t_vals, t_bounds = tm.get_opt_params()
    assert t_names == list(j_names) == ["length_scale"]
    np.testing.assert_array_equal(t_vals, np.asarray(j_vals))
    np.testing.assert_array_equal(t_bounds, np.asarray(j_bounds).reshape(-1, 2))
    np.testing.assert_allclose(
        tm.kernel.Kout().numpy(), np.asarray(jm.kernel.Kout()), rtol=1e-14
    )
    vals = arrays_from_muygps(tm)
    assert vals == {
        "length_scale": 0.05, "noise": 320.0,
        "scale": 1.0 if analytic else 1.7,
        "kernel": "shear" if family == "33" else "shear_2in3out",
        "noise_model": "shear33" if family == "33" else "homoscedastic",
    }
    # and the strings rebuild the same model
    again = muygps_from_arrays(**vals)
    assert type(again.kernel) is type(tm.kernel)
    assert type(again.noise) is type(tm.noise)
    assert arrays_from_muygps(again) == vals
    assert arrays_from_muygps(carried(jax_model()))["kernel"] == "matern"
    assert arrays_from_muygps(
        carried(jax_model(kernel="rbf", metric="F2"))
    )["kernel"] == "rbf"


def test_convert_errors():
    with pytest.raises(ValueError, match="unknown noise model"):
        muygps_from_arrays(0.5, noise=1e-3, kernel="shear", noise_model="33")
    with pytest.raises(ValueError, match="scalar length scale"):
        muygps_from_arrays([0.5, 0.6], noise=1e-3, kernel="shear")
    with pytest.raises(ValueError, match="unknown metric"):
        muygps_from_arrays(0.5, noise=1e-3, smoothness=1.5, metric="l1")
    with pytest.raises(ValueError, match="unknown kernel"):
        muygps_from_arrays(0.5, noise=1e-3, kernel="cauchy")
    # a general smoothness builds; a value outside its bounds does not
    assert muygps_from_arrays(0.5, noise=1e-3, smoothness=0.7).kernel.smoothness() == 0.7
    with pytest.raises(ValueError, match="greater than the upper bound"):
        muygps_from_arrays(
            0.5, noise=1e-3, smoothness=7.0, smoothness_bounds=(0.1, 5.0)
        )
    with pytest.raises(ValueError, match="unknown bound option"):
        muygps_from_arrays(0.5, noise=1e-3, smoothness=0.7, smoothness_bounds="free")


def test_null_noise_and_downsample_scale_carry_across():
    """A JAX model with NullNoise and a DownSampleScale crosses over as
    numbers and strings (``noise_model="null"``, ``scale="downsample"``
    with its counts) and reads back out."""
    from muygpys_tpu.gp import MuyGPS as JaxMuyGPS
    from muygpys_tpu.gp.deformation import Isotropy as JIso, l2 as jl2
    from muygpys_tpu.gp.hyperparameter import (
        DownSampleScale as JDS,
        Parameter as JP,
    )
    from muygpys_tpu.gp.kernels import Matern as JMatern
    from muygpys_tpu.gp.noise import NullNoise as JNull

    from muygpys_torch.gp.hyperparameter import DownSampleScale
    from muygpys_torch.gp.noise import NullNoise

    jm = JaxMuyGPS(
        kernel=JMatern(smoothness=JP(2.5), deformation=JIso(
            jl2, length_scale=JP(0.3))),
        noise=JNull(), scale=JDS(down_count=6, iteration_count=4),
    )
    tm = muygps_from_arrays(
        length_scale=np.asarray(jm.kernel.deformation.length_scale()),
        smoothness=np.asarray(jm.kernel.smoothness()), noise_model="null",
        scale="downsample",
        scale_kwargs=dict(down_count=jm.scale._down_count,
                          iteration_count=jm.scale._iteration_count),
    )
    assert isinstance(tm.noise, NullNoise) and tm.noise() == jm.noise() == 0
    assert isinstance(tm.scale, DownSampleScale) and not tm.scale.trained
    assert (tm.scale._down_count, tm.scale._iteration_count) == (6, 4)
    vals = arrays_from_muygps(tm)
    assert vals["noise_model"] == "null" and vals["noise"] == 0.0
    assert vals["smoothness"] == 2.5 and vals["scale"] == 1.0
    with pytest.raises(ValueError, match="unknown scale"):
        muygps_from_arrays(0.3, noise=1e-3, smoothness=1.5, scale="median")


def jax_model_to_train(kernel="matern", nu=1.5, ls=0.4, ls_bounds=(0.01, 5.0),
                       noise=1e-3, noise_bounds=(1e-6, 1e-1), metric="l2",
                       hetero=None, nu_bounds="fixed"):
    """A JAX MuyGPS still to be trained, with an AnalyticScale.  ``ls``
    scalar -> Isotropy, sequence -> Anisotropy (``ls_bounds`` shared);
    ``noise_bounds="fixed"`` fixes the noise; ``hetero`` an array ->
    HeteroscedasticNoise; ``nu_bounds`` a pair -> free smoothness."""
    from muygpys_tpu.gp import MuyGPS
    from muygpys_tpu.gp.deformation import F2, Anisotropy, Isotropy, l2
    from muygpys_tpu.gp.hyperparameter import (
        AnalyticScale,
        Parameter,
        VectorParameter,
    )
    from muygpys_tpu.gp.kernels import RBF, Matern
    from muygpys_tpu.gp.noise import HeteroscedasticNoise, HomoscedasticNoise

    m = {"l2": l2, "F2": F2}[metric]
    if np.ndim(ls) == 0:
        deformation = Isotropy(m, length_scale=Parameter(ls, ls_bounds))
    else:
        deformation = Anisotropy(m, VectorParameter(
            *(Parameter(v, ls_bounds) for v in ls)
        ))
    kern = (RBF(deformation=deformation) if kernel == "rbf"
            else Matern(smoothness=Parameter(nu, nu_bounds),
                        deformation=deformation))
    noise_fn = (HomoscedasticNoise(noise, noise_bounds) if hetero is None
                else HeteroscedasticNoise(np.asarray(hetero)))
    return MuyGPS(kernel=kern, noise=noise_fn, scale=AnalyticScale())


def carried_for_training(jm):
    """The port's MuyGPS to be trained, built from the JAX model's getters
    (values and bounds as numpy numbers)."""
    from muygpys_tpu.gp.hyperparameter import AnalyticScale as JaxAnalytic
    from muygpys_tpu.gp.kernels import RBF as JaxRBF
    from muygpys_tpu.gp.noise import HeteroscedasticNoise as JaxHetero

    d = jm.kernel.deformation
    ls = np.asarray(d.length_scale())
    if ls.ndim == 0:
        ls_bounds = d.length_scale.get_bounds()
    else:
        ls_bounds = [d.length_scale[i].get_bounds() for i in range(ls.size)]
    is_rbf = isinstance(jm.kernel, JaxRBF)
    hetero = isinstance(jm.noise, JaxHetero)
    return muygps_from_arrays(
        length_scale=ls,
        length_scale_bounds=ls_bounds,
        noise=None if hetero else np.asarray(jm.noise()),
        noise_bounds="fixed" if hetero or jm.noise.fixed()
        else jm.noise.get_bounds(),
        scale="analytic" if isinstance(jm.scale, JaxAnalytic)
        else np.asarray(jm.scale()),
        smoothness=None if is_rbf else np.asarray(jm.kernel.smoothness()),
        kernel="rbf" if is_rbf else "matern",
        metric=d.metric.name,
        measurement_noise=np.asarray(jm.noise()) if hetero else None,
        smoothness_bounds="fixed" if is_rbf or jm.kernel.smoothness.fixed()
        else jm.kernel.smoothness.get_bounds(),
    )


@pytest.mark.parametrize(
    "spec",
    [dict(), dict(ls=(0.3, 0.7), noise_bounds="fixed"),
     dict(nu=1.2, nu_bounds=(0.31, 5.0)), dict(nu=1.37),
     dict(nu=2.0, nu_bounds=(0.2, 3.0), ls=(0.3, 0.7), noise_bounds="fixed"),
     dict(kernel="rbf", metric="F2", ls_bounds=(0.1, 2.0)),
     dict(nu=2.5, hetero=np.full((3, 4), 0.01))],
)
def test_model_to_train_carried_across(spec):
    from muygpys_torch.gp.hyperparameter import AnalyticScale

    jm = jax_model_to_train(**spec)
    tm = carried_for_training(jm)
    j_names, j_vals, j_bounds = jm.get_opt_params()
    t_names, t_vals, t_bounds = tm.get_opt_params()
    assert t_names == list(j_names)
    np.testing.assert_array_equal(t_vals, np.asarray(j_vals))
    np.testing.assert_array_equal(t_bounds, np.asarray(j_bounds).reshape(-1, 2))
    assert isinstance(tm.scale, AnalyticScale) and tm.fixed() == jm.fixed()

    # values come back out as numpy numbers
    vals = arrays_from_muygps(tm)
    np.testing.assert_array_equal(
        vals["length_scale"], np.asarray(jm.kernel.deformation.length_scale())
    )
    np.testing.assert_array_equal(vals["noise"], np.asarray(jm.noise()))
    assert vals["scale"] == 1.0
    assert ("smoothness" in vals) == (spec.get("kernel") != "rbf")


def test_model_with_free_smoothness_is_refused():
    """A free smoothness is no longer refused: it is the last name of the
    optimization surface, and comes back out as a number.  What is refused
    is a scale the port does not know."""
    from muygpys_torch.gp.hyperparameter import Parameter

    kern = Matern(smoothness=Parameter(1.5, (0.5, 2.5)))
    assert kern.get_opt_params() == (["smoothness"], [1.5], [(0.5, 2.5)])
    tm = muygps_from_arrays(
        0.5, noise=1e-3, smoothness=1.2, smoothness_bounds=(0.31, 5.0),
        length_scale_bounds=(0.01, 5.0), scale="analytic",
    )
    assert tm.get_opt_params()[0] == ["length_scale", "smoothness"]
    assert arrays_from_muygps(tm)["smoothness"] == 1.2
    with pytest.raises(ValueError, match="unknown scale"):
        muygps_from_arrays(0.5, noise=1e-3, smoothness=1.5, scale="median")
