"""The training chassis, port against JAX on the same batch (f64, CPU):
Fused_L_BFGS_B_optimize (K2's plain version vs the TPU kernel in interpret
mode, and the lanes engines), the generic L_BFGS_B_optimize and
Adam_optimize, at tests/test_pallas_train.py's optimum tolerances (length
scale rtol 1e-3, noise rtol 1e-2)."""

import numpy as np
import pytest
import torch

from test_torch_convert import carried_for_training, jax_model_to_train
from test_torch_fast_objective import problem

from muygpys_tpu import optimize as jopt
from muygpys_torch.convert import arrays_from_muygps
from muygpys_torch.gpu import _build
from muygpys_torch.optimize import (
    Adam_optimize,
    Fused_L_BFGS_B_optimize,
    L_BFGS_B_optimize,
    lool_fn,
    mse_fn,
)


def _jax_values(jm):
    return (
        float(jm.kernel.deformation.length_scale()), float(jm.noise())
    )


def _port_values(tm):
    vals = arrays_from_muygps(tm)
    return vals["length_scale"], vals["noise"]


def _assert_same_optimum(tm, jm):
    ls, noise = _port_values(tm)
    ls_ref, noise_ref = _jax_values(jm)
    np.testing.assert_allclose(ls, ls_ref, rtol=1e-3)
    np.testing.assert_allclose(noise, noise_ref, rtol=1e-2)


@pytest.fixture(scope="module")
def batch():
    return problem(11)


@pytest.fixture(scope="module")
def jax_fused(batch):
    jm = jax_model_to_train()
    return jm, jopt.Fused_L_BFGS_B_optimize(
        jm, *batch, engine="pallas", interpret=True
    )


def test_fused_chassis_matches_jax(batch, jax_fused):
    jm, jref = jax_fused
    _build.reset_launches()
    kernel = Fused_L_BFGS_B_optimize(
        carried_for_training(jm), *batch, engine="kernel", device="cpu"
    )
    assert _build.launches["fused_train_stats"] == 0
    _assert_same_optimum(kernel, jref)
    lanes = Fused_L_BFGS_B_optimize(
        carried_for_training(jm), *batch, engine="lanes", device="cpu"
    )
    _assert_same_optimum(lanes, jref)
    # the original model is left as it was
    assert float(jm.kernel.deformation.length_scale()) == 0.4


def test_generic_chassis_matches_jax(batch, jax_fused):
    jm, jfused = jax_fused
    jref = jopt.L_BFGS_B_optimize(jm, *batch, loss_fn=jopt.lool_fn)
    tm = L_BFGS_B_optimize(
        carried_for_training(jm), *batch, loss_fn=lool_fn
    )
    _assert_same_optimum(tm, jref)
    # and the generic optimum is the fused one (tests/test_pallas_train.py)
    _assert_same_optimum(tm, jfused)


def test_generic_chassis_mse_matches_jax(batch):
    jm = jax_model_to_train(nu=0.5, noise_bounds="fixed")
    jref = jopt.L_BFGS_B_optimize(jm, *batch, loss_fn=jopt.mse_fn)
    tm = L_BFGS_B_optimize(carried_for_training(jm), *batch, loss_fn=mse_fn)
    np.testing.assert_allclose(
        _port_values(tm)[0], _jax_values(jref)[0], rtol=1e-3
    )


def test_adam_follows_jax(batch):
    """torch.optim.Adam with the JAX defaults (learning rate 0.05) takes
    the optax trajectory: 40 steps end at the same point."""
    jm = jax_model_to_train()
    jref = jopt.Adam_optimize(jm, *batch, loss_fn=jopt.lool_fn, n_iter=40)
    tm = Adam_optimize(
        carried_for_training(jm), *batch, loss_fn=lool_fn, n_iter=40
    )
    np.testing.assert_allclose(
        _port_values(tm), _jax_values(jref), rtol=1e-6
    )


def _free_nu_model():
    """tests/test_pallas_train.py's free-smoothness model: started AT an
    integer, length scale and smoothness free, noise fixed."""
    return jax_model_to_train(
        nu=1.0, nu_bounds=(0.2, 3.0), noise_bounds="fixed"
    )


def _exact_objective(batch):
    """The port's exact-Bessel generic objective, the judge of an optimum."""
    obj = L_BFGS_B_optimize.make_obj_fn(
        carried_for_training(_free_nu_model()), *batch, loss_fn=lool_fn
    )

    def at(ls, nu):
        with torch.no_grad():
            return float(obj(length_scale=ls, smoothness=nu))

    return at


@pytest.fixture(scope="module")
def jax_free_nu(batch):
    jm = _free_nu_model()
    trained = jopt.Fused_L_BFGS_B_optimize(
        jm, *batch, engine="pallas", interpret=True
    )
    return (float(trained.kernel.deformation.length_scale()),
            float(trained.kernel.smoothness()))


@pytest.mark.parametrize("engine", ["kernel", "lanes"])
def test_fused_chassis_trains_free_smoothness(batch, jax_free_nu, engine):
    """A free-nu model through both engines.  The random-target problem is
    ridge-flat in (ls, nu), so the bar is the OBJECTIVE reached, judged by
    the exact objective at both optima (tests/test_pallas_train.py):
    no worse than the JAX chassis's by 5e-3 relative."""
    exact = _exact_objective(batch)
    v_ref = exact(*jax_free_nu)
    _build.reset_launches()
    trained = Fused_L_BFGS_B_optimize(
        carried_for_training(_free_nu_model()), *batch, engine=engine,
        device="cpu",
    )
    assert _build.launches["fused_train_stats"] == 0
    vals = arrays_from_muygps(trained)
    assert 0.01 <= vals["length_scale"] <= 5.0
    assert 0.2 <= vals["smoothness"] <= 3.0
    # it moved: the start is (0.4, 1.0)
    v_start = exact(0.4, 1.0)
    v_opt = exact(vals["length_scale"], vals["smoothness"])
    assert v_opt > v_start
    assert v_opt >= v_ref - 5e-3 * abs(v_ref), (v_opt, v_ref, vals)


def test_generic_chassis_trains_free_smoothness(batch, jax_free_nu):
    """L_BFGS_B_optimize on autograd through kve (d/dnu by forward mode
    through the algorithm) reaches the fused chassis's objective."""
    exact = _exact_objective(batch)
    trained = L_BFGS_B_optimize(
        carried_for_training(_free_nu_model()), *batch, loss_fn=lool_fn
    )
    vals = arrays_from_muygps(trained)
    v_ref = exact(*jax_free_nu)
    v_opt = exact(vals["length_scale"], vals["smoothness"])
    assert v_opt >= v_ref - 5e-3 * abs(v_ref), (v_opt, v_ref, vals)


def test_adam_follows_jax_with_free_smoothness(batch):
    """Adam on a free-nu model takes the optax trajectory."""
    jm = _free_nu_model()
    jref = jopt.Adam_optimize(jm, *batch, loss_fn=jopt.lool_fn, n_iter=6)
    tm = Adam_optimize(
        carried_for_training(jm), *batch, loss_fn=lool_fn, n_iter=6
    )
    vals = arrays_from_muygps(tm)
    np.testing.assert_allclose(
        [vals["length_scale"], vals["smoothness"]],
        [float(jref.kernel.deformation.length_scale()),
         float(jref.kernel.smoothness())], rtol=1e-6,
    )


def test_chassis_survive_a_failing_cholesky(batch):
    """A proposal whose factorization fails scores the penalty instead of
    ending the run (torch raises where JAX returns NaN)."""
    tm = carried_for_training(jax_model_to_train(
        ls_bounds=(0.01, 1e5), noise_bounds=(0.0, 1e-1)
    ))
    obj = L_BFGS_B_optimize.make_obj_fn(tm, *batch, loss_fn=lool_fn)
    with pytest.raises(torch.linalg.LinAlgError):
        obj(length_scale=1e5, noise=0.0)
    out = L_BFGS_B_optimize(tm, *batch, loss_fn=lool_fn)
    ls, noise = _port_values(out)
    assert 0.01 <= ls <= 1e5 and 0.0 <= noise <= 0.1


@pytest.mark.parametrize("engine", ["kernel", "lanes"])
def test_fused_chassis_refuses_a_nonfinite_start(batch, engine):
    """With a non-finite objective at x0 the NaN-safe line search would
    "converge" at once; the chassis raises instead (JAX's probe)."""
    t, y, cw, pw = batch
    t = t.copy()
    t[3] = np.nan
    with pytest.raises(ValueError, match="non-finite at the initial point"):
        Fused_L_BFGS_B_optimize(
            carried_for_training(jax_model_to_train()), t, y, cw, pw,
            engine=engine, device="cpu",
        )


# -- the lensing shear family -------------------------------------------------


@pytest.fixture(scope="module")
def shear_batch():
    from _torch_models import shear_problem

    return shear_problem(np.random.default_rng(23))


@pytest.fixture(scope="module")
def jax_shear_optimum(shear_batch):
    """The JAX generic chassis on the shear problem, loss mse: the optimum
    tests/test_shear_objective.py holds every shear route to."""
    import jax.numpy as jnp

    from _torch_models import jax_shear_model, shear_train_tensors

    jm = jax_shear_model("33", ls_bounds=(0.02, 0.5))
    data = shear_train_tensors(jm, *shear_batch, "33", jnp.asarray)
    ref = jopt.L_BFGS_B_optimize(jm, *data, loss_fn=jopt.mse_fn)
    return float(ref.kernel.deformation.length_scale())


def _shear_model_and_data(shear_batch, family="33", **kw):
    from _torch_models import (
        carried_shear,
        jax_shear_model,
        shear_train_tensors,
    )

    kw.setdefault("ls_bounds", (0.02, 0.5))
    tm = carried_shear(jax_shear_model(family, **kw))
    return tm, shear_train_tensors(tm, *shear_batch, family, torch.as_tensor)


@pytest.mark.parametrize("engine", ["kernel", "lanes"])
def test_fused_chassis_routes_shear(shear_batch, jax_shear_optimum, engine):
    """A shear model the shear objective accepts trains on its batched
    layout whatever ``engine`` says, launches no kernel, and lands at the
    generic chassis' optimum (tests/test_shear_objective.py's rtol 5e-3)."""
    tm, data = _shear_model_and_data(shear_batch)
    _build.reset_launches()
    trained = Fused_L_BFGS_B_optimize(
        tm, *data, loss="mse", engine=engine, device="cpu"
    )
    assert sum(_build.launches.values()) == 0
    ls = arrays_from_muygps(trained)["length_scale"]
    assert abs(ls - 0.15) > 1e-3  # it moved
    np.testing.assert_allclose(ls, jax_shear_optimum, rtol=5e-3)
    assert arrays_from_muygps(tm)["length_scale"] == 0.15  # a new model


def test_generic_chassis_trains_shear(shear_batch, jax_shear_optimum):
    """scripts/shear_sky_demo.py's call: L_BFGS_B_optimize(..., loss_fn=
    mse_fn) on a shear model, through the block layouts of ops/solve.py."""
    tm, data = _shear_model_and_data(shear_batch)
    trained = L_BFGS_B_optimize(tm, *data, loss_fn=mse_fn)
    np.testing.assert_allclose(
        arrays_from_muygps(trained)["length_scale"], jax_shear_optimum,
        rtol=5e-3,
    )


def test_fused_chassis_shear_lool_fixed_scale(shear_batch):
    """lool under a FixedScale routes to the shear objective too: the fused
    chassis and the generic one reach the same optimum of the same
    objective."""
    tm, data = _shear_model_and_data(shear_batch, noise=1e-2)
    fused = Fused_L_BFGS_B_optimize(tm, *data, loss="lool", device="cpu")
    generic = L_BFGS_B_optimize(tm, *data, loss_fn=lool_fn)
    np.testing.assert_allclose(
        arrays_from_muygps(fused)["length_scale"],
        arrays_from_muygps(generic)["length_scale"], rtol=5e-3,
    )


def test_fused_chassis_shear_analytic_scale_names_the_generic_chassis(
    shear_batch,
):
    """Shear lool with an AnalyticScale is a different objective (the scale
    is re-estimated per evaluation): a targeted ValueError, before any
    evaluation, names the chassis that trains it -- and that chassis does."""
    tm, data = _shear_model_and_data(shear_batch, scale="analytic", noise=1e-2)
    with pytest.raises(ValueError, match="L_BFGS_B_optimize"):
        Fused_L_BFGS_B_optimize(tm, *data, loss="lool", device="cpu")
    with pytest.raises(ValueError, match="L_BFGS_B_optimize"):
        Fused_L_BFGS_B_optimize(tm, *data, loss="looph", device="cpu")
    # mse is scale-free: accepted
    assert Fused_L_BFGS_B_optimize(tm, *data, loss="mse", device="cpu")
    trained = L_BFGS_B_optimize(tm, *data, loss_fn=lool_fn)
    assert 0.02 < arrays_from_muygps(trained)["length_scale"] < 0.5


def test_jax_spelling_pallas_and_interpret(batch, monkeypatch):
    """JAX's default ``engine="pallas"`` is the port's ``"kernel"``, and
    ``interpret=`` is taken by name: it never reaches
    ``scipy.optimize.minimize`` (which would raise on it)."""
    from scipy import optimize as sopt

    seen = []
    minimize = sopt.minimize

    def spy(*args, **kwargs):
        seen.append(set(kwargs))
        return minimize(*args, **kwargs)

    monkeypatch.setattr(sopt, "minimize", spy)
    jm = jax_model_to_train()
    kernel = Fused_L_BFGS_B_optimize(
        carried_for_training(jm), *batch, engine="kernel", device="cpu"
    )
    pallas = Fused_L_BFGS_B_optimize(
        carried_for_training(jm), *batch, engine="pallas", interpret=True,
        device="cpu",
    )
    assert _port_values(pallas) == _port_values(kernel)
    assert all("interpret" not in kw for kw in seen) and len(seen) == 2
    with pytest.raises(ValueError, match="unknown engine"):
        Fused_L_BFGS_B_optimize(
            carried_for_training(jm), *batch, engine="mosaic", device="cpu"
        )
