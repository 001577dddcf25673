"""The shared-factorization shear LOO objective of the port against
muygpys_tpu.optimize.shear_objective on the same batch (f64): value rtol
1e-9 and gradient rtol 1e-7 (tests/test_shear_objective.py's tolerances),
both kernel families x mse/lool x both solver layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import (
    carried_shear,
    jax_shear_model,
    shear_problem,
    shear_train_tensors,
)

from muygpys_tpu.optimize import shear_objective as jso
from muygpys_torch.gp.hyperparameter import FixedScale
from muygpys_torch.optimize import (
    L_BFGS_B_optimize,
    lool_fn,
    make_shear_loo_objective,
    mse_fn,
    shear_objective_supports,
)

PARAMS = {"length_scale": 0.12, "noise": 2e-4}
FREE = dict(ls_bounds=(0.02, 0.5), noise_bounds=(1e-6, 1e-2))


@pytest.fixture(scope="module")
def problem():
    return shear_problem(np.random.default_rng(17))


def _port_value_and_grad(obj, as_kwargs=False):
    theta = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in PARAMS.items()}
    value = obj(**theta) if as_kwargs else obj(theta)
    value.backward()
    return float(value.detach()), {k: float(t.grad) for k, t in theta.items()}


@pytest.fixture(scope="module")
def jax_reference(problem):
    """The JAX objective's value and gradient, once per (family, loss): its
    two layouts agree to rounding (tests/test_shear_objective.py), so the
    batched one, a small graph, stands for both."""
    out = {}
    for family in ("33", "23"):
        jm = jax_shear_model(family, **FREE)
        data = shear_train_tensors(jm, *problem, family, jnp.asarray)
        for loss in ("mse", "lool"):
            obj, names = jso.make_shear_loo_objective(
                jm, *data, loss=loss, layout="batched"
            )
            v, g = jax.jit(jax.value_and_grad(obj))(PARAMS)
            out[family, loss] = (float(v), {k: float(g[k]) for k in PARAMS},
                                 list(names))
    return out


@pytest.mark.parametrize("layout", ["lanes", "batched"])
@pytest.mark.parametrize("loss", ["mse", "lool"])
@pytest.mark.parametrize("family", ["33", "23"])
def test_matches_jax_objective(problem, jax_reference, family, loss, layout):
    tm = carried_shear(jax_shear_model(family, **FREE))
    data = shear_train_tensors(tm, *problem, family, torch.as_tensor)
    obj, names = make_shear_loo_objective(
        tm, *data, loss=loss, layout=layout, device="cpu"
    )
    v_ref, g_ref, names_ref = jax_reference[family, loss]
    assert names == names_ref == ["length_scale", "noise"]
    value, grad = _port_value_and_grad(obj)
    np.testing.assert_allclose(value, v_ref, rtol=1e-9)
    for k in PARAMS:
        np.testing.assert_allclose(
            grad[k], g_ref[k], rtol=1e-7,
            err_msg=f"{family}/{loss}/{layout}/{k}",
        )


@pytest.mark.parametrize("loss", ["mse", "lool"])
def test_matches_generic_objective_of_the_port(problem, loss):
    """The functor chain (kernel -> perturb -> posterior mean / covariance
    -> loss) through the block layouts of ops/solve.py gives the same
    objective as the shared factorization."""
    tm = carried_shear(jax_shear_model("33", **FREE))
    data = shear_train_tensors(tm, *problem, "33", torch.as_tensor)
    generic = L_BFGS_B_optimize.make_obj_fn(
        tm, *data, loss_fn=mse_fn if loss == "mse" else lool_fn
    )
    fast, _ = make_shear_loo_objective(
        tm, *data, loss=loss, layout="batched", device="cpu"
    )
    v_gen, g_gen = _port_value_and_grad(generic, as_kwargs=True)
    v_fast, g_fast = _port_value_and_grad(fast)
    np.testing.assert_allclose(v_fast, v_gen, rtol=1e-9)
    for k in PARAMS:
        np.testing.assert_allclose(g_fast[k], g_gen[k], rtol=1e-7)


def test_stored_values_stand_in_for_fixed_parameters(problem):
    tm = carried_shear(jax_shear_model("33", ls=0.12, noise=2e-4))
    data = shear_train_tensors(tm, *problem, "33", torch.as_tensor)
    fixed, names = make_shear_loo_objective(tm, *data, device="cpu")
    assert names == []
    free = carried_shear(jax_shear_model("33", **FREE))
    obj, _ = make_shear_loo_objective(free, *data, device="cpu")
    assert float(fixed({})) == float(obj(PARAMS))


def test_supports_and_rejects(problem):
    model = carried_shear(jax_shear_model("33", **FREE))
    assert shear_objective_supports(model, "mse")
    assert shear_objective_supports(model, "lool")
    assert not shear_objective_supports(model, "looph")
    # AnalyticScale x lool stays on the generic objective, which
    # re-estimates the scale per evaluation; mse is scale-free
    analytic = carried_shear(jax_shear_model("33", scale="analytic", **FREE))
    assert not shear_objective_supports(analytic, "lool")
    assert shear_objective_supports(analytic, "mse")
    from test_torch_convert import carried_for_training, jax_model_to_train

    assert not shear_objective_supports(
        carried_for_training(jax_model_to_train()), "mse"
    )
    data = shear_train_tensors(model, *problem, "33", torch.as_tensor)
    with pytest.raises(ValueError, match="shear objective"):
        make_shear_loo_objective(model, *data, loss="looph", device="cpu")
    with pytest.raises(ValueError, match="shear objective"):
        make_shear_loo_objective(analytic, *data, loss="lool", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        make_shear_loo_objective(model, *data, layout="nope", device="cpu")


def test_vector_scale_is_refused_under_lool(problem):
    """A vector FixedScale is not collapsed to its first component: lool
    bakes ONE scale into the covariance, so a non-scalar one raises; mse
    never reads it."""
    model = carried_shear(jax_shear_model("33", **FREE))
    model.scale = FixedScale(val=np.array([1.0, 2.0, 3.0]))
    data = shear_train_tensors(model, *problem, "33", torch.as_tensor)
    assert shear_objective_supports(model, "lool")
    with pytest.raises(ValueError, match="scalar scale"):
        make_shear_loo_objective(model, *data, loss="lool", device="cpu")
    obj, _ = make_shear_loo_objective(model, *data, loss="mse", device="cpu")
    assert np.isfinite(float(obj(PARAMS)))
    # a one-element array is a scalar scale
    model.scale = FixedScale(val=np.array([2.0]))
    one, _ = make_shear_loo_objective(model, *data, loss="lool", device="cpu")
    model.scale = FixedScale(val=2.0)
    two, _ = make_shear_loo_objective(model, *data, loss="lool", device="cpu")
    assert float(one(PARAMS)) == float(two(PARAMS))


def test_objective_defaults_to_cuda(problem, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = carried_shear(jax_shear_model("33", **FREE))
    data = shear_train_tensors(model, *problem, "33", torch.as_tensor)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_shear_loo_objective(model, *data)
