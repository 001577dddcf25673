"""muygpys_torch.convert.muygps_from_arrays: a trained JAX model carried
across through its own getters builds the same model."""

import math

import numpy as np
import pytest

from _torch_models import carried, jax_model

from muygpys_torch.convert import muygps_from_arrays
from muygpys_torch.gp.deformation import Anisotropy, Isotropy
from muygpys_torch.gp.kernels import Matern, RBF
from muygpys_torch.gp.noise import HeteroscedasticNoise, HomoscedasticNoise


@pytest.mark.parametrize(
    "spec",
    [dict(nu=0.5), dict(nu=math.inf, ls=(0.2, 0.3, 0.4)),
     dict(kernel="rbf", metric="F2"),
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


def test_convert_errors():
    with pytest.raises(ValueError, match="unknown metric"):
        muygps_from_arrays(0.5, noise=1e-3, smoothness=1.5, metric="l1")
    with pytest.raises(ValueError, match="unknown kernel"):
        muygps_from_arrays(0.5, noise=1e-3, kernel="cauchy")
    with pytest.raises(ValueError, match="general smoothness"):
        muygps_from_arrays(0.5, noise=1e-3, smoothness=0.7)
