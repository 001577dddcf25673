"""The LOO objectives of the training slice, in f64 on the CPU:

- the port's K2 objective (make_fused_train_objective: K2's plain version,
  the epilogue and the autograd.Function) against the JAX package's K2
  objective (fused_train_stats_bl in interpret mode and its epilogue) for
  lool, mse, looph and huber, value and gradient;
- K2's analytic gradient against torch.autograd through the port's lanes
  objective (make_fast_loo_objective), a second derivation that does not
  depend on JAX;
- free and general smoothness: the lanes objective (exact Bessel path) and
  the K2 objective (traced-nu surrogate, analytic d/dnu rows) against the JAX
  package's, value and every gradient;
- the batched layout (make_fast_loo_objective(layout="batched"), the device
  chassis' objective) against the JAX package's batched layout, value and
  every gradient, and its failed factorization: an error outside
  ``sync_free``, NaN inside it;
- the model classes both objectives refuse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_convert import carried_for_training, jax_model_to_train

from muygpys_tpu.optimize.fast_objective import (
    make_fast_loo_objective as jax_fast_objective,
)
from muygpys_tpu.pallas import fused_train as jft
from muygpys_torch.gp.deformation import F2, Isotropy, l2
from muygpys_torch.gp.hyperparameter import Parameter
from muygpys_torch.gp.kernels import KernelFn, Matern
from muygpys_torch.gp.muygps import MuyGPS
from muygpys_torch.gpu import _build
from muygpys_torch.ops import solve as tsolve
from muygpys_torch.optimize import (
    Fused_L_BFGS_B_optimize,
    make_fast_loo_objective,
)
from muygpys_torch.optimize.fused_objective import make_fused_train_objective

B, N = 64, 10
LOSSES = ["lool", "mse", "looph", "huber"]


def problem(seed, d_feat=0, r=1, metric="l2"):
    """Training tensors from numpy in the make_train_tensors layout:
    distances (B, n, n) / (B, n) isotropic (squared under F2), per-feature
    differences (B, n, n, d) / (B, n, d) anisotropic."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(B, N, 2))
    q = rng.uniform(size=(B, 2))
    pw = pts[:, :, None, :] - pts[:, None, :, :]
    cw = q[:, None, :] - pts
    if not d_feat:
        pw, cw = (pw**2).sum(-1), (cw**2).sum(-1)
        if metric == "l2":
            pw, cw = np.sqrt(pw), np.sqrt(cw)
    y = rng.standard_normal((B, N, r))
    t = rng.standard_normal((B, r))
    if r == 1:
        y, t = y[:, :, 0], t[:, 0]
    return t, y, cw, pw


@pytest.fixture(scope="module")
def iso():
    """Matern 3/2, free length scale and noise: the training headline's
    model class at the JAX test's size, with JAX's K2 rows at the proposed
    parameters computed once (the loss lives only in the epilogue)."""
    jm = jax_model_to_train()
    t, y, cw, pw = problem(0)
    params = {"length_scale": 0.33, "noise": 2e-3}
    stats = jft.fused_train_stats_bl(
        jnp.asarray(pw.transpose(1, 2, 0)), jnp.asarray(cw.T),
        jnp.asarray(y.T[:, None, :]),
        jnp.asarray([0.33, 2e-3, 1e-3]),  # [ls, noise, stored noise]
        smoothness=1.5, noise_free=True, batch_tile=B, interpret=True,
    )
    return jm, (t, y, cw, pw), params, stats


@pytest.mark.parametrize("loss", LOSSES)
def test_objective_matches_jax(iso, loss):
    jm, data, params, stats = iso
    t = data[0]
    v_ref, g_ref = jft._epilogue(
        stats, jnp.asarray(t[None, :]), loss, ("length_scale", "noise"), N
    )
    obj, names = make_fused_train_objective(
        carried_for_training(jm), *data, loss=loss, device="cpu"
    )
    assert names == ["length_scale", "noise"]
    _build.reset_launches()
    v, g = obj(params)
    assert _build.launches["fused_train_stats"] == 0  # plain version on CPU
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-8)
    for name in params:
        np.testing.assert_allclose(
            float(g[name]), float(g_ref[name]), rtol=1e-6, err_msg=name
        )
    # the same gradient through the autograd.Function's backward
    theta = torch.tensor([0.33, 2e-3], dtype=torch.float64, requires_grad=True)
    (2.0 * obj.value(theta)).backward()
    np.testing.assert_allclose(
        theta.grad.numpy(),
        [2.0 * float(g_ref["length_scale"]), 2.0 * float(g_ref["noise"])],
        rtol=1e-6,
    )


def test_whole_objective_matches_jax(iso):
    """JAX's make_fused_train_objective end to end (its own parameter
    assembly and stored-noise slot) against the port's."""
    jm, data, params, _ = iso
    jvag, jnames = jft.make_fused_train_objective(
        jm, *(jnp.asarray(a) for a in data), loss="lool", interpret=True
    )
    v_ref, g_ref = jvag(params)
    obj, names = make_fused_train_objective(
        carried_for_training(jm), *data, device="cpu"
    )
    v, g = obj(params)
    assert names == list(jnames)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-8)
    for name in params:
        np.testing.assert_allclose(
            float(g[name]), float(g_ref[name]), rtol=1e-6, err_msg=name
        )


# (model spec, problem spec, proposed parameters, loss)
AUTOGRAD_CASES = [
    (dict(), dict(), {"length_scale": 0.33, "noise": 2e-3}, "lool"),
    (dict(nu=0.5), dict(r=2), {"length_scale": 0.21, "noise": 5e-3}, "mse"),
    (dict(nu=2.5, noise_bounds="fixed"), dict(), {"length_scale": 0.5},
     "looph"),
    (dict(nu=np.inf), dict(r=2), {"length_scale": 0.27, "noise": 1e-2},
     "huber"),
    (dict(kernel="rbf", metric="F2"), dict(metric="F2"),
     {"length_scale": 0.4, "noise": 3e-3}, "looph"),
    (dict(ls=(0.5, 0.7)), dict(d_feat=2),
     {"length_scale0": 0.43, "length_scale1": 0.81, "noise": 2e-3}, "lool"),
    (dict(kernel="rbf", metric="F2", ls=(0.5, 0.7), noise_bounds="fixed"),
     dict(d_feat=2, r=2), {"length_scale0": 0.6, "length_scale1": 0.3},
     "mse"),
    (dict(hetero=np.random.default_rng(9).uniform(1e-3, 1e-2, (B, N))),
     dict(), {"length_scale": 0.33}, "lool"),
]


@pytest.mark.parametrize(
    "model,prob,params,loss", AUTOGRAD_CASES,
    ids=[f"{i}-{c[3]}" for i, c in enumerate(AUTOGRAD_CASES)],
)
def test_k2_gradient_matches_autograd(model, prob, params, loss):
    tm = carried_for_training(jax_model_to_train(**model))
    data = problem(AUTOGRAD_CASES.index((model, prob, params, loss)), **prob)
    obj, names = make_fused_train_objective(tm, *data, loss=loss, device="cpu")
    assert sorted(names) == sorted(params)
    v, g = obj(params)
    lanes, lnames = make_fast_loo_objective(
        tm, *data, loss=loss, device="cpu"
    )
    assert lnames == names
    theta = {
        k: torch.tensor(v0, dtype=torch.float64, requires_grad=True)
        for k, v0 in params.items()
    }
    v_ref = lanes(theta)
    v_ref.backward()
    v_ref = v_ref.detach()
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-8)
    for k in params:
        np.testing.assert_allclose(
            float(g[k]), float(theta[k].grad), rtol=1e-6, err_msg=k
        )


FREE_NU = {"length_scale": 0.33, "noise": 2e-3, "smoothness": 1.81}


@pytest.fixture(scope="module")
def free_nu():
    """Matern with free length scale, noise and smoothness (the JAX
    general-nu conformance test's model), with the JAX package's two
    objectives evaluated once at the proposed parameters: the exact-Bessel
    lanes objective under jax.value_and_grad, and the Pallas objective in
    interpret mode."""
    jm = jax_model_to_train(nu=1.37, nu_bounds=(0.3, 5.0))
    data = problem(0)
    jdata = tuple(jnp.asarray(a) for a in data)
    lanes, names = jax_fast_objective(jm, *jdata, loss="lool")
    assert list(names) == ["length_scale", "smoothness", "noise"]
    exact = jax.jit(jax.value_and_grad(lanes))(
        {k: jnp.asarray(v) for k, v in FREE_NU.items()}
    )
    fused = jft.make_fused_train_objective(
        jm, *jdata, loss="lool", interpret=True
    )[0](FREE_NU)
    return jm, data, exact, fused


def test_lanes_free_smoothness_matches_jax(free_nu):
    jm, data, (v_ref, g_ref), _ = free_nu
    obj, names = make_fast_loo_objective(
        carried_for_training(jm), *data, device="cpu"
    )
    assert names == ["length_scale", "smoothness", "noise"]
    theta = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in FREE_NU.items()}
    v = obj(theta)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-9)
    for k in FREE_NU:
        np.testing.assert_allclose(
            float(theta[k].grad), float(g_ref[k]), rtol=1e-8, atol=1e-10,
            err_msg=k,
        )


def test_fused_free_smoothness_matches_jax(free_nu):
    """K2's plain version with the port's own coefficient constructor: against
    JAX's Pallas objective (the same surrogate), and against JAX's
    exact-Bessel objective at the JAX conformance test's tolerances."""
    jm, data, (v_exact, g_exact), (v_ref, g_ref) = free_nu
    obj, names = make_fused_train_objective(
        carried_for_training(jm), *data, device="cpu"
    )
    assert names == ["length_scale", "smoothness", "noise"]
    _build.reset_launches()
    v, g = obj(FREE_NU)
    assert _build.launches["fused_train_stats"] == 0
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-9)
    np.testing.assert_allclose(float(v), float(v_exact), rtol=1e-7)
    for k in FREE_NU:
        np.testing.assert_allclose(float(g[k]), float(g_ref[k]), rtol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(g[k]), float(g_exact[k]), rtol=1e-5, err_msg=k)
    # the same gradient through the autograd.Function's backward
    theta = torch.tensor([FREE_NU[k] for k in names], dtype=torch.float64,
                         requires_grad=True)
    obj.value(theta).backward()
    np.testing.assert_allclose(
        theta.grad.numpy(), [float(g_ref[k]) for k in names], rtol=1e-7
    )


# (model spec, problem spec, proposed parameters, loss): general smoothness,
# fixed and free, through K2's plain version against autograd through the
# port's own exact-Bessel lanes objective
GEN_AUTOGRAD_CASES = [
    (dict(nu=1.37), dict(), {"length_scale": 0.33, "noise": 2e-3}, "lool"),
    (dict(nu=0.31, nu_bounds=(0.1, 2.0), noise_bounds="fixed"), dict(r=2),
     {"length_scale": 0.21, "smoothness": 0.4}, "mse"),
    (dict(nu=2.0, nu_bounds=(0.5, 5.0), ls=(0.5, 0.7)), dict(d_feat=2),
     {"length_scale0": 0.43, "length_scale1": 0.81, "noise": 2e-3,
      "smoothness": 2.001}, "looph"),
    (dict(nu=4.8, nu_bounds=(0.5, 9.0), noise_bounds="fixed",
          hetero=np.random.default_rng(9).uniform(1e-3, 1e-2, (B, N))),
     dict(), {"length_scale": 0.33, "smoothness": 4.1}, "huber"),
]


@pytest.mark.parametrize(
    "model,prob,params,loss", GEN_AUTOGRAD_CASES,
    ids=[f"{i}-{c[3]}" for i, c in enumerate(GEN_AUTOGRAD_CASES)],
)
def test_k2_general_smoothness_matches_autograd(model, prob, params, loss):
    tm = carried_for_training(jax_model_to_train(**model))
    data = problem(20 + GEN_AUTOGRAD_CASES.index((model, prob, params, loss)),
                   **prob)
    obj, names = make_fused_train_objective(tm, *data, loss=loss, device="cpu")
    assert sorted(names) == sorted(params)
    v, g = obj(params)
    lanes, lnames = make_fast_loo_objective(tm, *data, loss=loss, device="cpu")
    assert lnames == names
    theta = {k: torch.tensor(v0, dtype=torch.float64, requires_grad=True)
             for k, v0 in params.items()}
    v_ref = lanes(theta)
    v_ref.backward()
    # the surrogate against the exact chain: 1e-7 on the value, 1e-5 on the
    # gradients (tests/test_pallas_train.py)
    np.testing.assert_allclose(float(v.detach()), float(v_ref.detach()), rtol=1e-7)
    for k in params:
        np.testing.assert_allclose(
            float(g[k]), float(theta[k].grad), rtol=1e-5, err_msg=k
        )
    if params.get("smoothness") == 2.001:
        # AT the integer the clamp leaves mu = 1e-7: the value holds, and
        # the length-scale and noise gradients with it, but the summed d/dnu
        # is cancellation-limited (each element's tangent is within a few
        # percent, tests/test_torch_matern_nu.py; their sum over the batch
        # is not): finite and of the right sign, which is what an optimizer
        # started at an integer needs for its first step
        at = dict(params, smoothness=2.0)
        v2, g2 = obj(at)
        theta = {k: torch.tensor(v0, dtype=torch.float64, requires_grad=True)
                 for k, v0 in at.items()}
        v2_ref = lanes(theta)
        v2_ref.backward()
        np.testing.assert_allclose(float(v2), float(v2_ref.detach()), rtol=1e-7)
        for k in ("length_scale0", "length_scale1", "noise"):
            np.testing.assert_allclose(
                float(g2[k]), float(theta[k].grad), rtol=1e-5, err_msg=k
            )
        assert np.isfinite(float(g2["smoothness"]))
        assert float(g2["smoothness"]) * float(theta["smoothness"].grad) > 0


@pytest.mark.parametrize("free", [False, True], ids=["fixed", "free"])
def test_coefficients_built_where_the_data_lies(free, monkeypatch):
    """A fixed general smoothness builds its coefficient vector once, with
    the objective; a free one builds it at every evaluation.  Either way
    from a tensor on the objective's device in the data's dtype, never
    routed through another device."""
    from muygpys_torch.gpu import matern_nu
    from muygpys_torch.optimize import fused_objective

    built = []

    def counting(nu, need_dnu=False):
        built.append((nu.device.type, nu.dtype, need_dnu))
        return matern_nu.matern_nu_coeffs(nu, need_dnu=need_dnu)

    monkeypatch.setattr(fused_objective, "matern_nu_coeffs", counting)
    spec = dict(nu=1.37, nu_bounds=(0.3, 5.0)) if free else dict(nu=1.37)
    tm = carried_for_training(jax_model_to_train(**spec))
    data = tuple(
        torch.as_tensor(a, dtype=torch.float32) for a in problem(0)
    )
    obj, names = make_fused_train_objective(tm, *data, device="cpu")
    assert ("smoothness" in names) == free
    at_make = len(built)
    for ls in (0.3, 0.35):
        value, _ = obj({"length_scale": ls})
        assert value.dtype == torch.float32
    if free:
        assert at_make == 0 and len(built) == 2
    else:
        assert at_make == 1 and len(built) == 1
    assert set(built) == {("cpu", torch.float32, free)}


class _ShearLike(KernelFn):
    """Stands in for a kernel class the fast objectives do not train (they
    take Matern and RBF; the shear models have their own objective)."""

    def __init__(self):
        super().__init__(Isotropy(l2, length_scale=Parameter(0.4, (0.1, 1))))
        self._make()

    def _make(self):
        self._make_base()
        self._fn = lambda d, **kw: d


def test_unsupported_models_raise_before_any_launch(iso):
    jm, data, _, _ = iso
    tm = carried_for_training(jm)
    with pytest.raises(ValueError, match="unknown layout"):
        make_fast_loo_objective(tm, *data, layout="rows", device="cpu")
    with pytest.raises(ValueError, match="lool/mse/looph/huber"):
        make_fast_loo_objective(tm, *data, loss="cross_entropy", device="cpu")
    shear = MuyGPS(kernel=_ShearLike(), noise=tm.noise)
    _build.reset_launches()
    for build in (make_fast_loo_objective, make_fused_train_objective):
        with pytest.raises(ValueError, match="make_shear_loo_objective"):
            build(shear, *data, device="cpu")
    with pytest.raises(ValueError, match="make_shear_loo_objective"):
        Fused_L_BFGS_B_optimize(shear, *data, device="cpu")
    # general smoothness outside what the traced-nu surrogate certifies is
    # refused by the K2 objective before any launch (the lanes objective
    # takes it, through the exact Bessel path)
    def with_nu(nu, metric="l2"):
        return MuyGPS(
            kernel=Matern(smoothness=nu, deformation=Isotropy(
                {"l2": l2, "F2": F2}[metric],
                length_scale=Parameter(0.4, (0.1, 1)))),
            noise=tm.noise,
        )

    for nu, match in (
        (Parameter(1.5, (0.01, 2.5)), "exceed the certified"),
        (Parameter(1.5, (0.5, 12.0)), "exceed the certified"),
        (Parameter(25.0), "outside the certified"),
    ):
        with pytest.raises(ValueError, match=match):
            make_fused_train_objective(with_nu(nu), *data, device="cpu")
        with pytest.raises(ValueError, match=match):
            Fused_L_BFGS_B_optimize(with_nu(nu), *data, device="cpu")
        make_fast_loo_objective(with_nu(nu), *data, device="cpu")
    with pytest.raises(ValueError, match="requires the l2 metric"):
        make_fused_train_objective(
            with_nu(Parameter(1.37), "F2"), *data, device="cpu"
        )
    # anisotropic models take per-feature differences, not distances
    aniso = carried_for_training(jax_model_to_train(ls=(0.5, 0.7)))
    with pytest.raises(ValueError, match="difference"):
        make_fused_train_objective(aniso, *data, device="cpu")
    assert _build.launches["fused_train_stats"] == 0


def test_objectives_default_to_cuda(iso, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jm, data, _, _ = iso
    tm = carried_for_training(jm)
    for build in (make_fast_loo_objective, make_fused_train_objective):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(tm, *data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Fused_L_BFGS_B_optimize(tm, *data)


@pytest.mark.parametrize(
    "model,prob,params,loss", AUTOGRAD_CASES,
    ids=[f"{i}-{c[3]}" for i, c in enumerate(AUTOGRAD_CASES)],
)
def test_batched_layout_matches_jax(model, prob, params, loss):
    """The batched layout against the JAX package's, value and every
    gradient (JAX's under jax.value_and_grad, the port's under autograd)."""
    jm = jax_model_to_train(**model)
    data = problem(AUTOGRAD_CASES.index((model, prob, params, loss)), **prob)
    jobj, jnames = jax_fast_objective(
        jm, *(jnp.asarray(a) for a in data), loss=loss, layout="batched"
    )
    v_ref, g_ref = jax.value_and_grad(jobj)(
        {k: jnp.asarray(v) for k, v in params.items()}
    )
    obj, names = make_fast_loo_objective(
        carried_for_training(jm), *data, loss=loss, layout="batched",
        device="cpu",
    )
    assert sorted(names) == sorted(jnames)
    theta = {
        k: torch.tensor(v0, dtype=torch.float64, requires_grad=True)
        for k, v0 in params.items()
    }
    value = obj(theta)
    value.backward()
    np.testing.assert_allclose(float(value), float(v_ref), rtol=1e-10)
    for k in params:
        np.testing.assert_allclose(
            float(theta[k].grad), float(g_ref[k]), rtol=1e-10, atol=1e-12,
            err_msg=k,
        )


def test_batched_layout_failed_factor_is_nan_inside_sync_free(iso):
    """A proposal whose Kin is not positive definite (a negative nugget
    larger than the smallest eigenvalue): outside sync_free the Cholesky
    raises, as the scipy chassis expect; inside it the objective is NaN, as
    JAX's batched layout returns, and nothing raises."""
    jm, data, _, _ = iso
    obj, _ = make_fast_loo_objective(
        carried_for_training(jm), *data, layout="batched", device="cpu"
    )
    bad = {"length_scale": 0.33, "noise": -0.5}
    with pytest.raises(torch.linalg.LinAlgError):
        obj(bad)
    with tsolve.sync_free():
        assert torch.isnan(obj(bad))
        assert torch.isfinite(obj({"length_scale": 0.33, "noise": 2e-3}))
    with pytest.raises(torch.linalg.LinAlgError):
        obj(bad)
