"""muygpys_torch.gp.hyperparameter: Parameter, VectorParameter and the scale
functors, against the JAX package's behaviour."""

import numpy as np
import pytest

from muygpys_tpu.gp import hyperparameter as jh
from muygpys_torch.gp.hyperparameter import (
    AnalyticScale,
    FixedScale,
    NamedParameter,
    NamedVectorParameter,
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
    assert a() == 0.8 and a.trained
    # a trained value is replaced by the next optimization (test_torch_scale)
    assert callable(a.get_opt_fn(None))
    with pytest.raises(ValueError, match="positive"):
        FixedScale(val=-1.0)
    with pytest.raises(ValueError, match="iteration"):
        AnalyticScale(iteration_count=-2)


def test_named_parameters_match_jax():
    """Names, the free-parameter lists and kwarg threading, as the JAX
    package's NamedParameter / NamedVectorParameter."""
    t = NamedParameter("noise", Parameter(1e-3, (1e-6, 1e-1)))
    j = jh.NamedParameter("noise", jh.Parameter(1e-3, (1e-6, 1e-1)))
    lists_t, lists_j = ([], [], []), ([], [], [])
    t.append_lists(*lists_t)
    j.append_lists(*lists_j)
    assert lists_t == lists_j == (["noise"], [1e-3], [(1e-6, 1e-1)])
    assert t.apply_fn(lambda **kw: kw)() == {"noise": 1e-3}
    assert t.apply_fn(lambda **kw: kw)(noise=0.5) == {"noise": 0.5}
    assert t.filter_kwargs(noise=2.0, ls=1.0) == j.filter_kwargs(
        noise=2.0, ls=1.0
    )
    fixed = NamedParameter("smoothness", Parameter(1.5))
    fixed.append_lists(*lists_t)
    assert lists_t[0] == ["noise"]  # a fixed parameter is not listed

    vt = NamedVectorParameter(
        "length_scale", VectorParameter(Parameter(0.4, (0.1, 1.0)),
                                        Parameter(0.7))
    )
    vj = jh.NamedVectorParameter(
        "length_scale", jh.VectorParameter(jh.Parameter(0.4, (0.1, 1.0)),
                                           jh.Parameter(0.7))
    )
    lists_t, lists_j = ([], [], []), ([], [], [])
    vt.append_lists(*lists_t)
    vj.append_lists(*lists_j)
    assert lists_t == lists_j == (["length_scale0"], [0.4], [(0.1, 1.0)])
    assert vt.values(length_scale1=0.9) == [0.4, 0.9]
    assert vt.filter_kwargs(length_scale0=0.2, noise=1.0) == (
        {"length_scale0": 0.2, "length_scale1": 0.7}, {"noise": 1.0}
    )
    hyper = {}
    vt.populate(hyper)
    assert sorted(hyper) == ["length_scale0", "length_scale1"]
