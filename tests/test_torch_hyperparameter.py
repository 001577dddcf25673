"""muygpys_torch.gp.hyperparameter: Parameter, VectorParameter and the scale
functors, against the JAX package's behaviour."""

import numpy as np
import pytest

from muygpys_tpu.gp import hyperparameter as jh
from muygpys_torch.gp.hyperparameter import (
    AnalyticScale,
    FixedScale,
    Parameter,
    VectorParameter,
)


@pytest.mark.parametrize(
    "val,bounds", [(1.5, "fixed"), (0.3, (0.1, 1.0)), (2.0, (1e-3, 1e3))]
)
def test_parameter_matches_jax(val, bounds):
    t, j = Parameter(val, bounds), jh.Parameter(val, bounds)
    assert t() == j() and t.fixed() == j.fixed()
    assert t.get_bounds() == j.get_bounds()


def test_parameter_sampling_in_bounds():
    rng = np.random.default_rng(0)
    for how in ("sample", "log_sample"):
        p = Parameter(how, (0.1, 10.0), _rng=rng)
        assert 0.1 <= p() <= 10.0


@pytest.mark.parametrize(
    "args,match",
    [
        ((5.0, (0.1, 1.0)), "greater than the upper bound"),
        ((0.01, (0.1, 1.0)), "lesser than the lower bound"),
        ((0.5, (1.0, 0.1)), "exceeds upper bound"),
        ((0.5, "free"), "unknown bound option"),
        (("sample", "fixed"), "fixed bounds"),
        (([1.0, 2.0], "fixed"), "nonscalar"),
        ((0.5, (0.1,)), "length 2"),
    ],
)
def test_parameter_errors(args, match):
    with pytest.raises(ValueError, match=match):
        Parameter(*args)
    with pytest.raises(ValueError, match=match):
        jh.Parameter(*args)


def test_vector_parameter():
    v = VectorParameter(Parameter(0.4), Parameter(0.7, (0.1, 1.0)))
    assert len(v) == 2 and v[1]() == 0.7 and not v.fixed()
    np.testing.assert_array_equal(v(), [0.4, 0.7])


def test_scales_carry_trained_values():
    s = FixedScale()
    assert s() == 1.0 and not s.trained
    s._set(2.5)
    assert s() == 2.5 and s.trained
    a = AnalyticScale()
    a._set(0.8)
    assert a() == 0.8
    with pytest.raises(NotImplementedError, match="not ported yet"):
        a.get_opt_fn(None)
    with pytest.raises(ValueError, match="positive"):
        FixedScale(val=-1.0)
    with pytest.raises(ValueError, match="iteration"):
        AnalyticScale(iteration_count=-2)
