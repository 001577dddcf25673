"""The device chassis (muygpys_torch.optimize.device_chassis) on the CPU, in
f64, where its L-BFGS steps run eagerly:

- against the scipy oracle (the port's L_BFGS_B_optimize) on the same
  objective, rtol 1e-4, as tests/test_device_chassis.py holds the JAX one;
- against the JAX package's device chassis on the same inputs
  (Fused_Device_LBFGS_optimize(engine="lanes") and Device_LBFGS_optimize):
  length scale within rtol 1e-6, iteration counts within one;
- a free noise stays inside its bounds; the kernel engine (K2's plain
  version) against the lanes engine, rtol 1e-3;
- make_device_trainer: one program for two batches of one shape, warm
  start, shear routing, the loss registry;
- what the chassis refuses.

The JAX references run once per module (fixtures)."""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_convert import carried_for_training, jax_model_to_train

from muygpys_tpu.optimize import device_chassis as jdc
from muygpys_tpu.optimize import lool_fn as jax_lool_fn
from muygpys_torch.convert import arrays_from_muygps, muygps_from_arrays
from muygpys_torch.gpu import _build
from muygpys_torch.optimize import (
    Device_LBFGS_optimize,
    Fused_Device_LBFGS_optimize,
    L_BFGS_B_optimize,
    lool_fn,
    make_device_trainer,
)

LS_BOUNDS = (0.01, 1.0)


def problem(seed, count=250, batch=128, nn=25):
    """A 1-D smooth field with noise: LOO batch tensors in the
    make_train_tensors layout (distances (B, n, n), (B, n); targets (B,),
    (B, n)), neighbours by brute force in numpy."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(size=count))
    y = np.sin(12.0 * x) + 0.03 * rng.standard_normal(count)
    bi = rng.choice(count, batch, replace=False)
    d = np.abs(x[bi][:, None] - x[None, :])
    nbrs = np.argsort(d, axis=1, kind="stable")[:, 1:nn + 1]
    pts = x[nbrs]
    pw = np.abs(pts[:, :, None] - pts[:, None, :])
    cw = np.abs(x[bi][:, None] - pts)
    return y[bi], y[nbrs], cw, pw


def jax_model(noise_bounds="fixed"):
    return jax_model_to_train(ls=0.3, ls_bounds=LS_BOUNDS,
                              noise_bounds=noise_bounds)


def length_scale(model):
    return float(arrays_from_muygps(model)["length_scale"])


def jax_iterations(run):
    """Run a JAX device chassis verbosely; (model, iterations)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model = run()
    its = re.search(r"'iterations': (\d+)", out.getvalue())
    return model, int(its[1])


@pytest.fixture(scope="module")
def data():
    return problem(0)


@pytest.fixture(scope="module")
def jax_lanes(data):
    """JAX's fused device chassis through its batched objective."""
    jdata = tuple(jnp.asarray(a) for a in data)
    model, its = jax_iterations(lambda: jdc.Fused_Device_LBFGS_optimize(
        jax_model(), *jdata, loss="lool", engine="lanes", verbose=True,
    ))
    return float(model.kernel.deformation.length_scale()), its


def test_fused_device_lbfgs_matches_scipy(data):
    model = carried_for_training(jax_model())
    oracle = L_BFGS_B_optimize(
        model, *(torch.as_tensor(a) for a in data), loss_fn=lool_fn
    )
    info = {}
    opt = Fused_Device_LBFGS_optimize(
        model, *data, loss="lool", engine="lanes", device="cpu", info=info
    )
    assert info["iterations"] >= 1 and info["evaluations"] > info["iterations"]
    assert info["capture_ms"] == 0.0  # eager steps on the CPU
    np.testing.assert_allclose(length_scale(opt), length_scale(oracle),
                               rtol=1e-4)


def test_fused_device_lbfgs_matches_jax(data, jax_lanes):
    ls_jax, its_jax = jax_lanes
    info = {}
    opt = Fused_Device_LBFGS_optimize(
        carried_for_training(jax_model()), *data, loss="lool",
        engine="lanes", device="cpu", info=info,
    )
    np.testing.assert_allclose(length_scale(opt), ls_jax, rtol=1e-6)
    assert abs(info["iterations"] - its_jax) <= 1, (info, its_jax)


def test_generic_device_lbfgs_matches_jax(data, jax_lanes):
    """Device_LBFGS_optimize (the generic composed objective, autograd
    inside the step) against JAX's, and against the fused chassis'
    optimum."""
    jm = jax_model()
    cw, pw = data[2], data[3]
    jdata = tuple(jnp.asarray(a) for a in (data[0], data[1], cw, pw))
    jopt, its_jax = jax_iterations(lambda: jdc.Device_LBFGS_optimize(
        jm, *jdata, loss_fn=jax_lool_fn, verbose=True
    ))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        opt = Device_LBFGS_optimize(
            carried_for_training(jm), *(torch.as_tensor(a) for a in data),
            loss_fn=lool_fn, verbose=True,
        )
    its = int(re.search(r"'iterations': (\d+)", out.getvalue())[1])
    ls_jax = float(jopt.kernel.deformation.length_scale())
    np.testing.assert_allclose(length_scale(opt), ls_jax, rtol=1e-6)
    assert abs(its - its_jax) <= 1, (its, its_jax)
    np.testing.assert_allclose(length_scale(opt), jax_lanes[0], rtol=1e-4)


def test_fused_device_lbfgs_free_noise_in_bounds(data):
    """A free noise: the bijector keeps every proposal inside the box, and
    the optimum is the scipy chassis' (length scale and noise)."""
    model = carried_for_training(jax_model(noise_bounds=(1e-6, 1e-1)))
    opt = Fused_Device_LBFGS_optimize(
        model, *data, loss="lool", engine="lanes", device="cpu",
    )
    vals = arrays_from_muygps(opt)
    assert LS_BOUNDS[0] < vals["length_scale"] < LS_BOUNDS[1]
    assert 1e-6 < vals["noise"] < 1e-1
    oracle = arrays_from_muygps(L_BFGS_B_optimize(
        model, *(torch.as_tensor(a) for a in data), loss_fn=lool_fn
    ))
    for key in ("length_scale", "noise"):
        np.testing.assert_allclose(vals[key], oracle[key], rtol=1e-3,
                                   err_msg=key)


def test_kernel_engine_matches_lanes(data):
    """K2 (its plain version on the CPU) under the device chassis against
    the batched lanes engine; K2 ran once per evaluation."""
    model = carried_for_training(jax_model())
    ls_lanes = length_scale(Fused_Device_LBFGS_optimize(
        model, *data, engine="lanes", device="cpu"
    ))
    info = {}
    _build.reset_launches()
    ls_kernel = length_scale(Fused_Device_LBFGS_optimize(
        model, *data, engine="kernel", device="cpu", info=info
    ))
    assert _build.launches["fused_train_stats"] == 0  # plain version
    np.testing.assert_allclose(ls_kernel, ls_lanes, rtol=1e-3)
    assert info["evaluations"] > info["iterations"] >= 1


def test_device_trainer_reuse_across_batches(data):
    """One program for two batches of one shape; the first batch's optimum
    is the fused chassis'; info["z"] warm-starts the second."""
    model = carried_for_training(jax_model())
    trainer = make_device_trainer(model, loss="lool", device="cpu")
    trained1, info1 = trainer(*data)
    ls1 = length_scale(trained1)
    ls_fused = length_scale(Fused_Device_LBFGS_optimize(
        model, *data, engine="lanes", device="cpu"
    ))
    np.testing.assert_allclose(ls1, ls_fused, rtol=1e-10)
    assert info1["iterations"] >= 1
    trained2, info2 = trainer(*problem(1), z_init=info1["z"])
    assert trainer.cache_size() == 1, "the second batch built anew"
    assert trainer.captures() == 0  # no graph on the CPU
    assert LS_BOUNDS[0] < length_scale(trained2) < LS_BOUNDS[1]
    assert info2["iterations"] >= 1
    # the same batch again from the optimum: it stops at once
    _, info3 = trainer(*data, z_init=info1["z"])
    assert info3["iterations"] <= 2
    assert trainer.cache_size() == 1


def shear_problem(rng):
    """A small shear sky (300 points, nn 10, batch 64) as the JAX
    package's shear trainer test builds it."""
    from muygpys_torch.gp.deformation import DifferenceIsotropy, F2
    from muygpys_torch.gp.hyperparameter import FixedScale, Parameter
    from muygpys_torch.gp.kernels.experimental import ShearKernel
    from muygpys_torch.gp.muygps import MuyGPS
    from muygpys_torch.gp.noise import ShearNoise33

    pts = rng.uniform(size=(300, 2))
    phase = pts @ (2 * np.pi * np.array([2.0, 3.0]))
    targets = np.stack(
        [np.sin(phase), 0.4 * np.cos(phase), 0.3 * np.sin(2 * phase)], 1
    )
    model = MuyGPS(
        kernel=ShearKernel(deformation=DifferenceIsotropy(
            F2, length_scale=Parameter(0.15, (0.02, 0.5))
        )),
        noise=ShearNoise33(1e-3 * 2.0 / 0.1**4),
        scale=FixedScale(),
    )
    bi = rng.choice(300, 64, replace=False)
    d = ((pts[bi][:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    bni = np.argsort(d, axis=1, kind="stable")[:, 1:11]
    pts_t = torch.as_tensor(pts)
    pw = model.kernel.deformation.pairwise_tensor(pts_t, torch.as_tensor(bni))
    cw = model.kernel.deformation.crosswise_tensor(
        pts_t, pts_t, torch.as_tensor(bi), torch.as_tensor(bni)
    )
    bt = torch.as_tensor(targets[bi])
    bnt = torch.as_tensor(targets[bni].swapaxes(-2, -1))
    return model, (bt, bnt, cw, pw)


def test_device_trainer_shear_routing():
    """The shear family trains on the batched shear assembly, in the
    trainer and in the fused device chassis alike (one program for two
    epochs); the shear lool under an AnalyticScale is refused."""
    model, batch = shear_problem(np.random.default_rng(3))
    trainer = make_device_trainer(model, loss="mse", device="cpu")
    opt, info = trainer(*batch)
    assert info["iterations"] > 0 and np.isfinite(info["value"])
    ls = length_scale(opt)
    assert 0.02 <= ls <= 0.5 and abs(ls - 0.15) > 1e-6
    trainer(*batch, z_init=info["z"])
    assert trainer.cache_size() == 1
    fused = Fused_Device_LBFGS_optimize(model, *batch, loss="mse",
                                        device="cpu")
    np.testing.assert_allclose(length_scale(fused), ls, rtol=1e-10)
    from muygpys_torch.gp.hyperparameter import AnalyticScale

    model.scale = AnalyticScale()
    with pytest.raises(ValueError, match="generic Device_LBFGS_optimize"):
        Fused_Device_LBFGS_optimize(model, *batch, loss="lool", device="cpu")


def test_device_trainer_loss_registry():
    """A loss name resolves through the loss registry, as in the JAX
    trainer ("pseudo_huber" is the fast objective's "huber"); an unknown
    one is refused."""
    t, y, cw, pw = problem(2, count=150, batch=64, nn=10)
    model = carried_for_training(jax_model())
    trainer = make_device_trainer(model, loss="pseudo_huber", device="cpu")
    trained, info = trainer(t, y, cw, pw)
    assert info["iterations"] > 0 and np.isfinite(info["value"])
    assert length_scale(trained) != 0.3
    with pytest.raises(ValueError, match="no generic LossFn"):
        make_device_trainer(model, loss="nonsense", device="cpu")


def test_refusals(data, monkeypatch):
    model = carried_for_training(jax_model())
    with pytest.raises(ValueError, match="unknown engine"):
        Fused_Device_LBFGS_optimize(model, *data, engine="mosaic",
                                    device="cpu")
    # a start whose objective is not finite
    bad = muygps_from_arrays(
        length_scale=0.3, length_scale_bounds=LS_BOUNDS, noise=-0.9,
        noise_bounds="fixed", scale="analytic", smoothness=1.5,
    )
    for engine in ("kernel", "lanes"):
        with pytest.raises(ValueError, match="non-finite at the initial"):
            Fused_Device_LBFGS_optimize(bad, *data, engine=engine,
                                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Fused_Device_LBFGS_optimize(model, *data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_trainer(model)
    # the generic chassis: a numpy batch goes on the card, not the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Device_LBFGS_optimize(model, *data, loss_fn=lool_fn)


def test_generic_device_lbfgs_places_a_numpy_batch(data):
    """A numpy batch trains where ``device`` says, as the same batch in
    tensors does."""
    model = carried_for_training(jax_model())
    from_numpy = Device_LBFGS_optimize(model, *data, loss_fn=lool_fn,
                                       device="cpu")
    from_tensors = Device_LBFGS_optimize(
        model, *(torch.as_tensor(a) for a in data), loss_fn=lool_fn
    )
    assert length_scale(from_numpy) == length_scale(from_tensors)


def trainer_case(route):
    """(model, loss, batch 1, batch 2) of one trainer route."""
    if route == "shear":
        model, first = shear_problem(np.random.default_rng(3))
        _, second = shear_problem(np.random.default_rng(4))
        return model, "mse", first, second
    model = carried_for_training(jax_model())
    if route == "fast":
        return model, "lool", problem(0), problem(1)
    # a LossFn the fast objective does not cover: the generic objective
    from muygpys_torch.optimize.loss import lool_fn_unscaled

    small = dict(count=150, batch=64, nn=10)
    return model, lool_fn_unscaled, problem(2, **small), problem(3, **small)


@pytest.mark.parametrize("route", ["fast", "shear", "generic"])
def test_device_trainer_second_batch_trains_on_its_own_data(route):
    """A re-used trainer trains its second batch as a fresh trainer does:
    the batch copied into the static buffers is the data the objective
    reads (a builder that copied or precomputed from them would train on
    the first batch)."""
    model, loss, first, second = trainer_case(route)
    trainer = make_device_trainer(model, loss=loss, device="cpu")
    _, info1 = trainer(*first)
    reused, info2 = trainer(*second, z_init=info1["z"])
    assert trainer.cache_size() == 1
    fresh, info_fresh = make_device_trainer(model, loss=loss, device="cpu")(
        *second, z_init=info1["z"]
    )
    np.testing.assert_allclose(info2["z"].numpy(), info_fresh["z"].numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(length_scale(reused), length_scale(fresh),
                               rtol=1e-10)
    assert info2["iterations"] == info_fresh["iterations"]
    assert not np.allclose(info2["z"].numpy(), info1["z"].numpy())


def test_jax_spelling_pallas_and_interpret(data):
    """``engine="pallas"`` (JAX's default) runs K2 as ``"kernel"`` does,
    and JAX's ``interpret`` is taken and unused."""
    model = carried_for_training(jax_model())
    kernel = length_scale(Fused_Device_LBFGS_optimize(
        model, *data, engine="kernel", device="cpu"
    ))
    pallas = length_scale(Fused_Device_LBFGS_optimize(
        model, *data, engine="pallas", interpret=True, device="cpu"
    ))
    assert pallas == kernel
