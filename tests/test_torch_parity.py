"""The small parity gaps of muygpys_torch against muygpys_tpu (f64):
TensorParam, NullNoise, NullDeformation, ops.noise, DownSampleScale (one
numpy generator seeded alike in each package), mse_fn_unnormalized and the
per-row weights of every loss, posterior_mean_variance_scale, the analytic
scale's row weights and global count, MuyGPS.__eq__, KernelFn.set_params /
__str__, config.itype / parse_flags.

Tolerance: rtol 1e-10 (values of one expression in both packages are held
at 1e-12 where the arithmetic is the same).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import carried, jax_model

from muygpys_tpu.ops import loss as jl
from muygpys_tpu.ops import noise as jn
from muygpys_tpu.ops import scale as jscale
from muygpys_tpu.ops import solve as jsolve
from muygpys_torch import config
from muygpys_torch.gp import MuyGPS
from muygpys_torch.gp.deformation import (
    DeformationFn,
    Isotropy,
    NullDeformation,
    l2,
)
from muygpys_torch.gp.hyperparameter import (
    DownSampleScale,
    FixedScale,
    Parameter,
    ScalarParam,
    TensorParam,
)
from muygpys_torch.gp.kernels import Matern
from muygpys_torch.gp.noise import (
    HeteroscedasticNoise,
    HomoscedasticNoise,
    NoiseFn,
    NullNoise,
    ShearNoise33,
)
from muygpys_torch.ops import loss as tl
from muygpys_torch.ops import noise as tn
from muygpys_torch.ops import scale as tscale
from muygpys_torch.ops import solve as tsolve

CLOSE = dict(rtol=1e-10, atol=1e-12)


def _spd(rng, shape_b, n):
    A = rng.standard_normal(shape_b + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


# --- TensorParam, NullNoise, NullDeformation ---


def test_tensor_param_matches_jax():
    from muygpys_tpu.gp.hyperparameter import TensorParam as JaxTensorParam

    val = np.arange(6.0).reshape(2, 3)
    for cls in (TensorParam, JaxTensorParam):
        p = cls(val)
        np.testing.assert_array_equal(np.asarray(p()), val)
        assert p.fixed()
        names, params, bounds = [], [], []
        p.append_lists(names, params, bounds)
        assert names == params == bounds == []
        with pytest.raises(NotImplementedError, match="bounds"):
            p.get_bounds()
        with pytest.raises(ValueError, match="strings"):
            cls("sample")
        with pytest.raises(ValueError, match="non-array"):
            cls(0.5)
        p._set(2 * val)
        np.testing.assert_array_equal(np.asarray(p()), 2 * val)
        p._set(None)
        np.testing.assert_array_equal(np.asarray(p()), 2 * val)
    assert torch.is_tensor(TensorParam(torch.ones(2))())
    assert isinstance(HeteroscedasticNoise(val), TensorParam)
    assert isinstance(HeteroscedasticNoise(val), NoiseFn)


def test_null_noise_matches_jax(rng):
    from muygpys_tpu.gp.noise import NullNoise as JaxNullNoise

    K = rng.standard_normal((3, 4, 4))
    for cls, asarray in ((NullNoise, torch.as_tensor),
                         (JaxNullNoise, jnp.asarray)):
        n = cls(1.0, "fixed")
        assert n() == 0.0 and n.fixed() and n.name() == "noise"
        assert n.get_bounds() == (0.0, 0.0)
        Kt = asarray(K)
        assert n.perturb(Kt) is Kt
        fn = jsolve.posterior_mean if cls is JaxNullNoise else (
            tsolve.posterior_mean)
        assert n.perturb_fn(fn) is fn
    assert isinstance(NullNoise(), (Parameter, NoiseFn))


def test_null_noise_is_off_the_optimization_surface():
    """The port's NullNoise adds nothing to ``get_opt_params``; the JAX
    package's has no ``append_lists``, so there ``get_opt_params`` raises
    (ROADMAP §3)."""
    from muygpys_tpu.gp import MuyGPS as JaxMuyGPS
    from muygpys_tpu.gp.deformation import Isotropy as JIso, l2 as jl2
    from muygpys_tpu.gp.hyperparameter import Parameter as JP
    from muygpys_tpu.gp.kernels import Matern as JMatern
    from muygpys_tpu.gp.noise import NullNoise as JaxNullNoise

    tm = MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=Parameter(0.3, (0.1, 1.0)))),
        noise=NullNoise(),
    )
    names, vals, bounds = tm.get_opt_params()
    assert names == ["length_scale"]
    np.testing.assert_array_equal(vals, [0.3])
    np.testing.assert_array_equal(bounds, [[0.1, 1.0]])
    jm = JaxMuyGPS(
        kernel=JMatern(smoothness=JP(1.5), deformation=JIso(
            jl2, length_scale=JP(0.3, (0.1, 1.0)))),
        noise=JaxNullNoise(),
    )
    with pytest.raises(AttributeError, match="append_lists"):
        jm.get_opt_params()


def test_null_deformation_matches_jax(rng):
    from muygpys_tpu.gp.deformation import NullDeformation as JaxNull

    d = rng.standard_normal((3, 4))
    for cls, asarray in ((NullDeformation, torch.as_tensor),
                         (JaxNull, jnp.asarray)):
        nd = cls()
        assert nd.length_scale is None
        x = asarray(d)
        assert nd(x, length_scale=2.0) is x
        with pytest.raises(NotImplementedError, match="tensor assembly"):
            nd.pairwise_tensor(x, None)
        with pytest.raises(NotImplementedError, match="tensor assembly"):
            nd.crosswise_tensor(x, x, None, None)
    assert str(NullDeformation()) == str(JaxNull()) == (
        "NullDeformation(length_scale=None)"
    )
    assert isinstance(Isotropy(l2, Parameter(0.3)), DeformationFn)
    with pytest.raises(NotImplementedError):
        DeformationFn()(d)


# --- ops.noise ---


@pytest.mark.parametrize("layout", ["3d", "5d", "shear", "hetero"])
def test_noise_ops_match_jax(rng, layout):
    if layout == "3d":
        K, args = rng.standard_normal((4, 5, 5)), (0.3,)
        t_fn, j_fn = tn.homoscedastic_perturb, jn.homoscedastic_perturb
    elif layout in ("5d", "shear"):
        K, args = rng.standard_normal((2, 3, 4, 3, 4)), (0.3,)
        t_fn, j_fn = (
            (tn.homoscedastic_perturb, jn.homoscedastic_perturb)
            if layout == "5d"
            else (tn.shear_perturb33, jn.shear_perturb33)
        )
    else:
        K = rng.standard_normal((4, 5, 5))
        args = (rng.uniform(size=(4, 5)),)
        t_fn, j_fn = tn.heteroscedastic_perturb, jn.heteroscedastic_perturb
    got = t_fn(torch.as_tensor(K), *(
        torch.as_tensor(a) if np.ndim(a) else a for a in args))
    want = j_fn(jnp.asarray(K), *(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_noise_ops_refuse_shapes():
    for fn in (tn.homoscedastic_perturb, jn.homoscedastic_perturb):
        with pytest.raises(ValueError, match="not implemented"):
            fn(np.zeros((2, 3)) if fn is jn.homoscedastic_perturb
               else torch.zeros((2, 3)), 0.1)
    with pytest.raises(ValueError, match=r"\(b, 3, nn, 3, nn\)"):
        tn.shear_perturb33(torch.zeros((2, 2, 4, 2, 4)), 0.1)
    with pytest.raises(ValueError, match=r"\(b, in, nn, in, nn\)"):
        tn.homoscedastic_perturb(torch.zeros((2, 3, 4, 2, 4)), 0.1)


def test_noise_models_call_the_ops(rng, monkeypatch):
    """The noise classes reach the covariance through the ops of
    ``muygpys_torch.ops.noise``, with a proposed ``noise=`` that keeps its
    autograd graph."""
    import muygpys_torch.gp.noise.heteroscedastic as het_mod
    import muygpys_torch.gp.noise.homoscedastic as homo_mod
    import muygpys_torch.gp.noise.shear as shear_mod

    K = torch.as_tensor(rng.standard_normal((2, 4, 4)))
    noise = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    out = HomoscedasticNoise(0.1).perturb(K, noise=noise)
    torch.sum(out).backward()
    assert float(noise.grad) == 8.0
    calls = []

    def spy(name):
        def fn(K, v):
            calls.append((name, v))
            return K
        return fn

    monkeypatch.setattr(homo_mod, "homoscedastic_perturb", spy("homo"))
    monkeypatch.setattr(het_mod, "heteroscedastic_perturb", spy("het"))
    monkeypatch.setattr(shear_mod, "shear_perturb33", spy("shear"))
    het_val = torch.full((2, 4), 0.3, dtype=torch.float64)
    HomoscedasticNoise(0.1).perturb(K)
    ShearNoise33(0.2).perturb(K)
    HeteroscedasticNoise(het_val).perturb(K)
    assert [c[0] for c in calls] == ["homo", "shear", "het"]
    assert calls[0][1] == 0.1 and calls[1][1] == 0.2
    assert torch.equal(calls[2][1], het_val)


# --- DownSampleScale ---


@pytest.fixture(scope="module")
def downsample_data(rng):
    n, nn = 60, 16
    x = rng.uniform(size=(n, 2))
    y = np.sin(5 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    d = np.linalg.norm(x[:, None] - x[None], axis=-1)
    bnn = np.argsort(d, axis=1)[:, 1:nn + 1]
    jm = jax_model(nu=1.5, ls=0.2, noise=1e-3)
    Kin = np.array(jm.kernel(jm.kernel.deformation.pairwise_tensor(
        jnp.asarray(x), bnn)))
    return Kin, y[bnn]


def _downsample_models(down, iters):
    from muygpys_tpu.gp.hyperparameter import DownSampleScale as JDS

    jm = jax_model(nu=1.5, ls=0.2, noise=1e-3)
    jm.scale = JDS(down_count=down, iteration_count=iters)
    tm = carried(jm)
    tm.scale = DownSampleScale(down_count=down, iteration_count=iters)
    return jm, tm


@pytest.mark.parametrize("down,iters", [(10, 10), (5, 7), (8, 1)])
def test_downsample_scale_matches_jax_with_one_seed(downsample_data, down,
                                                    iters):
    Kin, nnt = downsample_data
    jm, tm = _downsample_models(down, iters)
    got = tm.scale.get_opt_fn(tm)(
        torch.as_tensor(Kin), torch.as_tensor(nnt),
        rng=np.random.default_rng(7),
    )
    want = jm.scale.get_opt_fn(jm)(
        jnp.asarray(Kin), jnp.asarray(nnt), rng=np.random.default_rng(7)
    )
    np.testing.assert_allclose(float(got), float(want), **CLOSE)


def test_downsample_median_of_an_even_count(downsample_data):
    """Ten scales: the median is the mean of the two middle values (as
    ``jnp.median``), not the lower one (``torch.median``)."""
    Kin, nnt = downsample_data
    _, tm = _downsample_models(10, 10)
    rng = np.random.default_rng(11)
    pK = tm.noise.perturb(torch.as_tensor(Kin))
    scales = []
    for _ in range(10):
        idx = torch.as_tensor(np.sort(rng.choice(16, 10, replace=False)))
        scales.append(float(tscale.analytic_scale_optim_unnormalized(
            pK[:, idx][:, :, idx], torch.as_tensor(nnt)[:, idx])))
    s = np.sort(scales)
    norm = 10 * Kin.shape[0]
    got = float(tm.scale.get_opt_fn(tm)(
        torch.as_tensor(Kin), torch.as_tensor(nnt),
        rng=np.random.default_rng(11),
    ))
    np.testing.assert_allclose(got, 0.5 * (s[4] + s[5]) / norm, **CLOSE)
    assert not math.isclose(got, s[4] / norm, rel_tol=1e-6)


def test_downsample_optimize_scale_and_errors(downsample_data):
    Kin, nnt = downsample_data
    _, tm = _downsample_models(10, 4)
    assert not tm.scale.trained
    pw = tm.kernel.deformation.pairwise_tensor(
        torch.rand(60, 2, dtype=torch.float64),
        torch.as_tensor(np.tile(np.arange(16), (60, 1))),
    )
    tm.optimize_scale(pw, torch.as_tensor(nnt))
    assert tm.scale.trained and isinstance(tm.scale(), float)
    _, tm = _downsample_models(16, 4)
    with pytest.raises(ValueError, match="downsample 16 elements"):
        tm.scale.get_opt_fn(tm)(torch.as_tensor(Kin), torch.as_tensor(nnt))
    with pytest.raises(ValueError, match="down sample count"):
        DownSampleScale(down_count=-1)
    with pytest.raises(ValueError, match="iteration count"):
        DownSampleScale(iteration_count=2.5)


# --- losses with row weights, mse_fn_unnormalized ---

LOSS_CASES = [
    ("mse_fn_unnormalized", False, False, {}),
    ("mse_fn", False, False, {}),
    ("pseudo_huber_fn", False, False, {"boundary_scale": 0.7}),
    ("cross_entropy_fn", False, False, {}),
    ("lool_fn", True, True, {}),
    ("lool_fn_unscaled", True, False, {}),
    ("looph_fn", True, True, {"boundary_scale": 2.0}),
    ("looph_fn_unscaled", True, False, {}),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,with_var,with_scale,kw", LOSS_CASES)
def test_losses_take_row_weights_as_jax(rng, name, with_var, with_scale, kw,
                                        weighted):
    pred = rng.standard_normal((30, 2))
    targ = rng.standard_normal((30, 2))
    if name == "cross_entropy_fn":
        targ = np.eye(2)[(targ[:, 0] > 0).astype(int)]
    var = rng.uniform(0.1, 2.0, size=30)
    w = (rng.uniform(size=30) > 0.3).astype(float) if weighted else None
    extra = ([var] if with_var else []) + ([0.7] if with_scale else [])
    got = getattr(tl, name)(
        torch.as_tensor(pred), torch.as_tensor(targ),
        *(torch.as_tensor(e) if np.ndim(e) else e for e in extra),
        row_weights=None if w is None else torch.as_tensor(w), **kw,
    )
    want = getattr(jl, name)(
        jnp.asarray(pred), jnp.asarray(targ),
        *(jnp.asarray(e) for e in extra), row_weights=w, **kw,
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_full_covariance_lool_takes_row_weights(rng):
    pred = rng.standard_normal((20, 3))
    targ = rng.standard_normal((20, 3))
    cov = _spd(rng, (20,), 3)
    w = rng.uniform(size=20)
    got = tl.lool_fn(torch.as_tensor(pred), torch.as_tensor(targ),
                     torch.as_tensor(cov), 1.3, row_weights=w)
    want = jl.lool_fn(jnp.asarray(pred), jnp.asarray(targ),
                      jnp.asarray(cov), 1.3, row_weights=w)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_mse_fn_unnormalized_is_the_sum(rng):
    pred, targ = rng.standard_normal((2, 10, 3))
    got = tl.mse_fn_unnormalized(torch.as_tensor(pred), torch.as_tensor(targ))
    np.testing.assert_allclose(float(got), np.sum((pred - targ) ** 2),
                               rtol=1e-14)
    np.testing.assert_allclose(
        float(tl.mse_fn(torch.as_tensor(pred), torch.as_tensor(targ))),
        float(got) / 30, rtol=1e-14,
    )


# --- posterior_mean_variance_scale, analytic scale options ---


@pytest.mark.parametrize("layout", ["b_n", "b_n_r", "blocks"])
@pytest.mark.parametrize("count", [None, 37.0])
def test_posterior_mean_variance_scale_matches_jax(rng, layout, count):
    if layout == "blocks":
        b, i, n, o = 6, 3, 4, 3
        Kin = _spd(rng, (b,), i * n).reshape(b, i, n, i, n)
        Kcross = rng.standard_normal((b, i, n, o))
        Kout = np.eye(o) * 5.0
        nnt = rng.standard_normal((b, i, n))
    else:
        b, n = 8, 6
        Kin = _spd(rng, (b,), n)
        Kcross = rng.standard_normal((b, n))
        Kout = 1.0
        nnt = rng.standard_normal((b, n) if layout == "b_n" else (b, n, 2))
    got = tsolve.posterior_mean_variance_scale(
        torch.as_tensor(Kin), torch.as_tensor(Kcross),
        torch.as_tensor(Kout) if np.ndim(Kout) else Kout,
        torch.as_tensor(nnt), batch_count_global=count,
    )
    want = jsolve.posterior_mean_variance_scale(
        jnp.asarray(Kin), jnp.asarray(Kcross), jnp.asarray(Kout),
        jnp.asarray(nnt), batch_count_global=count,
    )
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CLOSE)


@pytest.mark.parametrize("count", [None, 21.0])
def test_analytic_scale_row_weights_and_count_match_jax(rng, count):
    Kin = _spd(rng, (10,), 5)
    y = rng.standard_normal((10, 5))
    w = (rng.uniform(size=10) > 0.4).astype(float)
    for weights in (None, w):
        got = tscale.analytic_scale_optim(
            torch.as_tensor(Kin), torch.as_tensor(y),
            batch_count_global=count, row_weights=weights,
        )
        want = jscale.analytic_scale_optim(
            jnp.asarray(Kin), jnp.asarray(y), batch_count_global=count,
            row_weights=weights,
        )
        np.testing.assert_allclose(float(got), float(want), **CLOSE)


# --- MuyGPS.__eq__, KernelFn.set_params / __str__ ---


def test_eq_matches_jax():
    specs = [dict(), dict(ls=0.6), dict(noise=2e-3), dict(scale=3.0),
             dict(nu=2.5), dict(ls=(0.5, 0.4)), dict(kernel="rbf")]
    jms = [jax_model(**s) for s in specs]
    tms = [carried(jm) for jm in jms]
    for a in range(len(specs)):
        for b in range(len(specs)):
            try:
                want = jms[a] == jms[b]
            except KeyError:
                want = KeyError
            try:
                got = tms[a] == tms[b]
            except KeyError:
                got = KeyError
            assert got == want, (specs[a], specs[b])
    assert tms[0] == carried(jax_model())
    assert tms[0] != "a model"
    assert (jms[0] == "a model") is False


def test_eq_raises_on_arrays_as_jax():
    """A multi-element value (heteroscedastic noise, a vector scale) makes
    the comparison's truth value ambiguous: ``ValueError`` in both."""
    het = np.full((3, 4), 0.01)
    pairs = [(jax_model(hetero=het), jax_model(hetero=het))]
    pairs.append((carried(pairs[0][0]), carried(pairs[0][1])))
    for a, b in pairs:
        with pytest.raises(ValueError, match="ambiguous"):
            a == b  # noqa: B015
    jv, tv = jax_model(), carried(jax_model())
    for m, val in ((jv, jnp.array([1.0, 2.0])),
                   (tv, torch.tensor([1.0, 2.0]))):
        s = FixedScale()
        s._set(val)
        m.scale = s
    for m, twin in ((jv, jax_model()), (tv, carried(jax_model()))):
        twin.scale = m.scale
        with pytest.raises(ValueError, match="ambiguous"):
            m == twin  # noqa: B015


def test_set_params_and_str_match_jax(rng):
    from muygpys_tpu.gp.hyperparameter import Parameter as JP

    jm = jax_model(ls=(0.5, 0.4), nu=1.5)
    tm = carried(jm)
    assert str(tm.kernel) == str(jm.kernel)
    tm.kernel.set_params(length_scale1=Parameter(0.3, (0.1, 1.0)),
                         smoothness=Parameter(2.5))
    jm.kernel.set_params(length_scale1=JP(0.3, (0.1, 1.0)),
                         smoothness=JP(2.5))
    assert str(tm.kernel) == str(jm.kernel)
    assert "length_scale1 : 0.3 - (0.1, 1.0)" in str(tm.kernel)
    diffs = rng.standard_normal((4, 5, 5, 2))
    np.testing.assert_allclose(
        tm.kernel(torch.as_tensor(diffs)).numpy(),
        np.asarray(jm.kernel(jnp.asarray(diffs))), **CLOSE,
    )
    with pytest.raises(KeyError):
        tm.kernel.set_params(nonsense=Parameter(1.0))


# --- config ---


def test_itype_and_parse_flags_match_jax():
    from muygpys_tpu import config as jconfig

    assert config.itype() == torch.int32
    assert np.dtype(jconfig.itype()) == np.int32
    old = config.state.ftype
    try:
        for mod in (config, jconfig):
            assert mod.parse_flags(
                ["--muygpys_ftype=32", "positional", "--other=1"]
            ) == ["positional", "--other=1"]
            assert mod.state.ftype == 32
            mod.parse_flags(["--muygpys_ftype=64"])
            assert mod.state.ftype == 64
            with pytest.raises(ValueError, match="unknown flag "
                               "'--muygpys_backend'"):
                mod.parse_flags(["--muygpys_backend=torch"])
            with pytest.raises(ValueError, match="requires =32 or =64"):
                mod.parse_flags(["--muygpys_ftype"])
            with pytest.raises(ValueError, match="ftype must be 32 or 64"):
                mod.parse_flags(["--muygpys_ftype=16"])
        assert config.ftype() == torch.float64
    finally:
        config.update("ftype", old)
        jax.config.update("jax_enable_x64", True)


def test_named_vector_parameter_defaults_match_jax():
    from muygpys_tpu.gp.hyperparameter import (
        NamedVectorParameter as JNV,
        Parameter as JP,
        VectorParameter as JV,
    )
    from muygpys_torch.gp.hyperparameter import (
        NamedVectorParameter,
        VectorParameter,
    )

    t = NamedVectorParameter("ls", VectorParameter(Parameter(0.5),
                                                   Parameter(0.7)))
    j = JNV("ls", JV(JP(0.5), JP(0.7)))
    assert t.set_defaults(ls1=0.2, other=3) == j.set_defaults(
        ls1=0.2, other=3) == {"ls1": 0.2, "other": 3, "ls0": 0.5}
    assert t.filter_kwargs(ls0=0.9, x=2) == ({"ls0": 0.9, "ls1": 0.7},
                                             {"x": 2})


def test_scalar_param_and_vector_module():
    from muygpys_torch.gp.hyperparameter import vector

    assert ScalarParam is Parameter
    assert vector.VectorParameter.__name__ == "VectorParameter"
    assert vector.NamedVectorParameter.__name__ == "NamedVectorParameter"


# --- the public names of this slice exist with the JAX signatures ---

NAMES = [
    ("ops.tensors", "fast_nn_update"), ("ops.tensors", "batch_features_tensor"),
    ("ops.tensors", "make_fast_predict_tensors"),
    ("ops.tensors", "pairwise_differences"),
    ("ops.tensors", "crosswise_differences"),
    ("gp.tensors", "fast_nn_update"), ("gp.tensors", "batch_features_tensor"),
    ("gp.tensors", "make_fast_predict_tensors"),
    ("ops.noise", "homoscedastic_perturb"),
    ("ops.noise", "heteroscedastic_perturb"),
    ("ops.noise", "shear_perturb33"),
    ("ops.solve", "fast_posterior_mean"),
    ("ops.solve", "mmuygps_fast_posterior_mean"),
    ("ops.solve", "fast_posterior_mean_precompute"),
    ("ops.solve", "posterior_mean_variance_scale"),
    ("ops.loss", "mse_fn_unnormalized"), ("ops.loss", "_weights_like"),
    ("ops.loss", "cross_entropy_fn"), ("ops.loss", "mse_fn"),
    ("ops.loss", "lool_fn"), ("ops.loss", "lool_fn_unscaled"),
    ("ops.loss", "pseudo_huber_fn"), ("ops.loss", "looph_fn"),
    ("ops.loss", "looph_fn_unscaled"),
    ("ops.scale", "analytic_scale_optim"),
    ("ops.scale", "analytic_scale_optim_unnormalized"),
    ("gp.hyperparameter.scale", "analytic_scale_optim_unnormalized"),
    ("gp.hyperparameter.scale", "DownSampleScale"),
    ("gp.hyperparameter.scale", "AnalyticScale"),
    ("gp.hyperparameter", "ScalarParam"), ("gp.hyperparameter", "TensorParam"),
    ("gp.hyperparameter.tensor", "TensorParam"),
    ("gp.hyperparameter.vector", "VectorParameter"),
    ("gp.hyperparameter.vector", "NamedVectorParameter"),
    ("gp.noise", "NoiseFn"), ("gp.noise", "NullNoise"),
    ("gp.noise.noise_fn", "NoiseFn"), ("gp.noise.null", "NullNoise"),
    ("gp.noise", "HeteroscedasticNoise"), ("gp.noise", "HomoscedasticNoise"),
    ("gp.deformation", "DeformationFn"), ("gp.deformation", "NullDeformation"),
    ("gp.deformation.deformation_fn", "DeformationFn"),
    ("gp.deformation.null", "NullDeformation"),
    ("gp.kernels.kernel_fn", "KernelFn.set_params"),
    ("gp.fast_mean", "FastPosteriorMean"),
    ("gp.fast_precompute", "FastPrecomputeCoefficients"),
    ("gp.muygps", "MuyGPS"), ("gp.muygps", "MuyGPS.fast_coefficients"),
    ("gp.muygps", "MuyGPS.fast_posterior_mean"),
    ("gp.muygps", "MuyGPS.optimize_scale"),
    ("gp.multivariate_muygps", "MultivariateMuyGPS"),
    ("gp", "MultivariateMuyGPS"),
    ("checkpoint", "save_model"), ("checkpoint", "load_model"),
    ("checkpoint", "save_fast_state"), ("checkpoint", "load_fast_state"),
    ("config", "itype"), ("config", "parse_flags"),
    ("optimize", "Bayes_optimize"), ("optimize.chassis", "OptimizeFn"),
    ("optimize.chassis", "OptimizeFn.make_obj_fn"),
    ("optimize.objective", "make_loo_crossval_fn"),
    ("optimize.bayes", "BayesianOptimization"),
    ("optimize.bayes", "BayesianOptimization.maximize"),
    ("optimize.bayes", "BayesianOptimization.probe"),
    ("gp.hyperparameter.experimental", "HierarchicalParameter"),
    ("gp.hyperparameter.experimental", "NamedHierarchicalParameter"),
    ("gp.hyperparameter.experimental", "NamedHierarchicalVectorParameter"),
    ("gp.hyperparameter.experimental", "sample_knots"),
    ("gp.hyperparameter.vector", "NamedVectorParameter.apply_fn"),
    ("native", "HNSW"), ("native.hnsw", "HNSW.knn_query"),
    ("examples.from_indices", "tensors_from_indices"),
    ("examples.from_indices", "regress_from_indices"),
    ("examples.from_indices", "fast_posterior_mean_from_indices"),
    ("examples.regress", "make_regressor"),
    ("examples.regress", "make_multivariate_regressor"),
    ("examples.regress", "do_regress"), ("examples.regress", "regress_any"),
    ("examples.classify", "make_classifier"),
    ("examples.classify", "do_classify"),
    ("examples.classify", "classify_any"),
    ("examples.two_class_classify_uq", "do_classify_uq"),
    ("examples.two_class_classify_uq", "classify_two_class_uq"),
    ("examples.two_class_classify_uq", "make_masks"),
    ("examples.two_class_classify_uq", "do_uq"),
    ("examples.two_class_classify_uq", "train_two_class_interval"),
    ("gp.kernels", "RBF"), ("gp.kernels", "Matern"),
    ("gp.kernels.experimental", "ShearKernel"),
    ("gp.kernels.experimental", "ShearKernel2in3out"),
    ("optimize", "Fused_L_BFGS_B_optimize"),
    ("optimize", "Fused_Device_LBFGS_optimize"),
    ("neighbors", "NN_Wrapper"), ("serve", "FastServer"),
    ("examples.fast_posterior_mean", "fast_posterior_mean_any"),
    ("examples.fast_posterior_mean", "do_fast_posterior_mean"),
    ("_test.datasets", "heaton_style"), ("_test.datasets", "stargal_style"),
    *(("_test.oracle", n) for n in (
        "crosswise_diffs", "pairwise_diffs", "crosswise_l2", "pairwise_l2",
        "matern", "rbf", "posterior_mean", "diagonal_variance",
        "analytic_scale", "dense_gp_sample")),
    ("_test.sampler", "UnivariateSampler"),
    ("_test.sampler", "UnivariateSampler.features"),
    ("_test.sampler", "UnivariateSampler.sample"),
    ("_test.sampler", "UnivariateSampler2D"),
    ("_test.real_data", "data_dir"), ("_test.real_data", "load_heaton"),
    ("_test.real_data", "load_stargal_embedded"),
    ("performance.benchmark", "benchmark_fn"),
    ("performance.benchmark", "BenchmarkPipeline"),
    ("performance.benchmark", "BenchmarkPipeline.run"),
    *(("performance.headline", n) for n in (
        "make_inputs", "make_coords_inputs", "make_serve_inputs",
        "make_train_inputs", "make_shear_inputs", "make_serve_1m_inputs",
        "xla_loop", "pallas_loop", "pallas_coords_loop",
        "pallas_coords_gen_loop", "knn_loop", "end_to_end_loop",
        "fused_train_loop", "fused_train_loop_gen", "xla_train_loop",
        "xla_train_loop_gen", "shear_serve_loop", "compile_loops",
        "measure")),
    ("nn", "MuyGPsLayer"), ("nn", "MultivariateMuyGPsLayer"),
    ("nn", "DeepKernelMuyGPs"),
    ("nn.muygps_layer", "DeepKernelMuyGPs.embed"),
    *(("examples.deep_kernel", n) for n in (
        "train_deep_kernel_muygps", "update_nearest_neighbors",
        "predict_model", "predict_single_model", "predict_multiple_model")),
    *(("parallel", n) for n in (
        "batch_spec", "even_batch", "gather_global",
        "initialize_distributed", "local_chunk_slice", "make_hybrid_mesh",
        "make_mesh", "replicate", "shard", "sharded_knn", "shard_batch",
        "shard_batch_global", "shard_ragged_global", "shard_global",
        "shard_ragged")),
    ("parallel.mesh", "local_chunk_slice"),
    ("parallel.knn", "sharded_knn"),
    *(("performance.scaling", n) for n in (
        "measure_scaling", "measure_serve_scaling", "main")),
]


# JAX parameters the port leaves out: private backend-injection arguments
# with one value in use (each class calls its op directly; nothing in the
# JAX package sets the kernels' either)
LEFT_OUT = {
    "AnalyticScale": {"_backend_fn"},
    "HeteroscedasticNoise": {"_backend_fn"},
    "HomoscedasticNoise": {"_backend_fn"},
    "MuyGPS": {"_backend_mean_fn", "_backend_var_fn"},
    "RBF": {"_backend_fn"},
    "Matern": {"_backend_fns"},
    "ShearKernel": {"_backend_fn"},
    "ShearKernel2in3out": {"_backend_Kin_fn", "_backend_Kcross_fn",
                           "_backend_Kout_fn"},
    # flax's module-tree fields; a torch module registers its children
    "MuyGPsLayer": {"parent", "name"},
    "MultivariateMuyGPsLayer": {"parent", "name"},
    "DeepKernelMuyGPs": {"parent", "name"},
}

# parameters only the port has, after the JAX ones: ``device`` everywhere,
# and the features a hierarchical length scale reads (``batch_features``)
# and the run's counts (``info``) on the chassis
PORT_ONLY = {
    # the backend where ranks share one card (gloo); NCCL otherwise follows
    # the device
    "initialize_distributed": {"backend"},
    "measure_scaling": {"backend"},
    "measure_serve_scaling": {"backend"},
    "Fused_L_BFGS_B_optimize": {"batch_features"},
    "Fused_Device_LBFGS_optimize": {"batch_features", "info"},
}


def _named_params(obj, drop=()):
    """(the named parameters in order, whether it takes ``**kwargs``)."""
    import inspect

    params = [p for p in inspect.signature(obj).parameters.values()
              if p.name not in drop]
    return ([p.name for p in params if p.kind is not p.VAR_KEYWORD],
            any(p.kind is p.VAR_KEYWORD for p in params))


@pytest.mark.parametrize("module,name", NAMES, ids=lambda v: str(v))
def test_public_names_match_jax_signatures(module, name):
    """Each name exists in both packages, and the JAX parameters are the
    port's, in order, for the private backend arguments of ``LEFT_OUT``;
    after them the port adds ``device=`` and the ``PORT_ONLY`` names alone,
    and takes ``**kwargs`` exactly where JAX does."""
    import importlib

    def resolve(pkg):
        obj = importlib.import_module(f"{pkg}.{module}")
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    port, ref = resolve("muygpys_torch"), resolve("muygpys_tpu")
    if not callable(ref) or name in ("ScalarParam",):
        return
    j, j_kwargs = _named_params(ref, LEFT_OUT.get(name, ()))
    t, t_kwargs = _named_params(port)
    assert t[:len(j)] == j, (t, j)
    assert set(t[len(j):]) <= {"device"} | PORT_ONLY.get(name, set()), t
    assert t_kwargs == j_kwargs, (t_kwargs, j_kwargs)


# JAX names the port leaves out, each with its reason
LEFT_OUT_NAMES = {
    ("performance.headline", "enable_persistent_cache"): (
        "JAX's persistent compilation cache; the port's kernels are built "
        "once by nvcc into the git-ignored build directory"
    ),
    ("performance.headline", "CACHE_DIR"): "that cache's directory",
}


@pytest.mark.parametrize("module,name", sorted(LEFT_OUT_NAMES),
                         ids=lambda v: str(v))
def test_left_out_names_exist_only_in_jax(module, name):
    import importlib

    assert hasattr(importlib.import_module(f"muygpys_tpu.{module}"), name)
    assert not hasattr(importlib.import_module(f"muygpys_torch.{module}"),
                       name)


def test_parallel_exports_the_jax_names():
    import muygpys_torch.parallel as tp
    import muygpys_tpu.parallel as jp

    assert tp.__all__ == jp.__all__ and len(tp.__all__) == 15


def test_collective_bytes_counts_calls_not_hlo():
    """A difference kept on purpose: torch has no HLO module, so the port's
    ``collective_bytes`` takes a call (``fn, *args, **kwargs``) and returns
    the bytes its collectives moved, counted by the port's collective
    wrappers, where JAX's parses a compiled module's text.  The result's
    keys (``"all-reduce"``, ``"all-gather"``) and byte rules are JAX's
    (tests/test_torch_scaling.py)."""
    from muygpys_torch.parallel import comm
    from muygpys_torch.performance.scaling import collective_bytes as port
    from muygpys_tpu.performance.scaling import collective_bytes as ref

    assert _named_params(ref) == (["hlo_text"], False)
    assert _named_params(port) == (["fn", "args"], True)
    hlo = "  %ar = f32[] all-reduce(f32[] %x), replica_groups={}\n"
    assert ref(hlo) == port(
        comm._count, "all-reduce", torch.zeros((), dtype=torch.float32)
    ) == {"all-reduce": 4}
