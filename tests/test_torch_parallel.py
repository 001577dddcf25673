"""The port's sharded paths on a world of 4 gloo ranks (and a sub-mesh of
2), against the port's serial results and the JAX package's.

Every case of tests/test_distributed.py runs once in one module-scoped
spawn (tests/_torch_parallel_worker.py:distributed_cases); the parent
computes the port's serial values and JAX's on the same numpy inputs.

Limits: sharded against the port's serial values at JAX's own sharded
limits (objectives rtol 1e-10, gradients 1e-9, posteriors 1e-10 / atol
1e-12; the shear objective 1e-9 / 1e-8; the optimum 1e-5); against JAX at
the limits the port's serial tests use for the same functions (generic and
K2 objectives rtol 1e-8, gradients 1e-6; posteriors 1e-8 / atol 1e-10; the
scale 1e-10; the fast mean 1e-10 / 1e-12; the shear objective 1e-9 / 1e-7;
the optimum 1e-3).  Every rank's values are equal to each other's.
"""

import functools

import numpy as np
import pytest
import torch

import _torch_parallel_worker as W

WORLD = 4


@pytest.fixture(scope="module")
def payload(rng):
    from muygpys_tpu._test.sampler import UnivariateSampler
    from muygpys_tpu.neighbors import NN_Wrapper
    from muygpys_tpu.optimize import sample_batch

    sampler = UnivariateSampler(
        data_count=600, train_ratio=0.5, nu=1.5, length_scale=0.05,
        measurement_noise=1e-3, rng=rng,
    )
    xtr, _ = sampler.features()
    ytr, _ = sampler.sample()
    nbrs = NN_Wrapper(xtr, 20, nn_method="exact")
    bi, bni = sample_batch(nbrs, 256, xtr.shape[0], rng=rng)
    b, n = 64, 10
    A = rng.normal(size=(b, n, n))
    pts = rng.uniform(size=(64, 2))
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    return {
        "xtr": np.asarray(xtr), "ytr": np.asarray(ytr),
        "bi": np.asarray(bi), "bni": np.asarray(bni),
        "knn_train": rng.normal(size=(1024, 5)),
        "knn_queries": rng.normal(size=(100, 5)),
        "Kin_h": A @ np.swapaxes(A, -2, -1) / n + 2.0 * np.eye(n),
        "Kcross_h": rng.uniform(0.1, 1.0, size=(b, n)),
        "y_h": rng.normal(size=(b, n)),
        "noise_h": rng.uniform(0.01, 0.1, size=(b, n)),
        "pts": pts,
        "shear_targets": rng.normal(size=(64, 3)),
        "shear_bni": np.argsort(d, axis=1)[:, 1:11],
    }


@pytest.fixture(scope="module")
def ranks(payload):
    """The ranks' results; the parent computes the heavy references (JAX's
    compiles, the serial chassis runs) while the world runs."""
    global _P
    _P = payload
    world = W.World("distributed_cases", WORLD, payload)
    for loss in ("lool", "mse", "looph"):
        _jax_vag(loss, 77)
    _jax_k2("lool")
    _jax_vag("lool", None)
    for loss in ("mse", "lool"):
        _jax_shear_vag(loss)
    _jax_shear_mean()
    _serial_optima()
    return world.results()


@pytest.fixture(scope="module")
def r0(ranks):
    return ranks[0]


# -- the port's serial values and JAX's -------------------------------------


def _jax_problem(p, batch=None):
    import jax.numpy as jnp

    from muygpys_tpu.gp import MuyGPS
    from muygpys_tpu.gp.deformation import Isotropy, l2
    from muygpys_tpu.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_tpu.gp.kernels import Matern
    from muygpys_tpu.gp.noise import HomoscedasticNoise

    model = MuyGPS(
        kernel=Matern(
            smoothness=Parameter(1.5),
            deformation=Isotropy(l2, length_scale=Parameter(0.3, (0.01, 1.0))),
        ),
        noise=HomoscedasticNoise(1e-3),
        scale=AnalyticScale(),
    )
    bi, bni = p["bi"][:batch], p["bni"][:batch]
    return model, model.make_train_tensors(
        bi, bni, jnp.asarray(p["xtr"]), jnp.asarray(p["ytr"])
    )


def _jax_value_and_grad(model, tensors, loss, at=0.07):
    import jax

    from muygpys_tpu.optimize import L_BFGS_B_optimize

    cw, pw, bt, bnt = tensors
    obj = L_BFGS_B_optimize.make_obj_fn(model, bt, bnt, cw, pw, loss_fn=loss)
    v, g = jax.jit(jax.value_and_grad(lambda ls: obj(length_scale=ls)))(at)
    return float(v), float(g)


@functools.cache
def _jax_vag(loss_name, batch):
    import muygpys_tpu.optimize as JO

    model, tensors = _jax_problem(_P, batch)
    return _jax_value_and_grad(model, tensors,
                               getattr(JO, f"{loss_name}_fn"))


@functools.cache
def _jax_k2(loss):
    """JAX's fused objective (its kernel interpreted) at (0.07, 2e-3)."""
    import jax
    import jax.numpy as jnp

    from muygpys_tpu.gp.noise import HomoscedasticNoise
    from muygpys_tpu.pallas.fused_train import make_fused_train_objective

    jm, (jcw, jpw, jbt, jbnt) = _jax_problem(_P)
    jm.noise = HomoscedasticNoise(1e-3, (1e-5, 1e-1))
    jm._make()
    jvag, names = make_fused_train_objective(jm, jbt, jbnt, jcw, jpw,
                                             loss=loss, interpret=True)
    jv, jg = jax.jit(jvag)({"length_scale": jnp.asarray(0.07),
                            "noise": jnp.asarray(2e-3)})
    return list(names), [float(jv)] + [float(jg[n]) for n in names]


@functools.cache
def _jax_shear_vag(loss):
    """JAX's shear assembly (batched layout) at length scale 0.1."""
    import jax

    from muygpys_tpu.optimize.shear_objective import (
        make_shear_loo_objective,
    )

    jm, (cw, pw, bt, bnt) = _jax_shear(_P, 0.15, (0.02, 0.5))
    fn, _ = make_shear_loo_objective(jm, bt, bnt, cw, pw, loss=loss,
                                     layout="batched")
    v, g = jax.jit(jax.value_and_grad(fn))({"length_scale": 0.1})
    return float(v), float(g["length_scale"])


@functools.cache
def _jax_shear_mean():
    import jax

    jm, (cw, pw, _, bnt) = _jax_shear(_P, 0.12)
    return np.asarray(jax.jit(
        lambda c, w, y: jm.posterior_mean(jm.kernel(w), jm.kernel(c), y)
    )(cw, pw, bnt))


@functools.cache
def _serial_optima():
    """The optimum length scale of the port's serial generic chassis and
    of JAX's; the port's serial K2 optimum (length scale, noise)."""
    import muygpys_tpu.optimize as JO
    from muygpys_torch.optimize import (
        Fused_L_BFGS_B_optimize,
        L_BFGS_B_optimize,
        lool_fn,
    )

    model = W.matern_model()
    cw, pw, bt, bnt = W.train_tensors(model, _P)
    opt = L_BFGS_B_optimize(model, bt, bnt, cw, pw, loss_fn=lool_fn)
    jm, (jcw, jpw, jbt, jbnt) = _jax_problem(_P)
    jopt = JO.L_BFGS_B_optimize(jm, jbt, jbnt, jcw, jpw, loss_fn=JO.lool_fn)
    kmodel = W.matern_model(noise_bounds=(1e-5, 1e-1))
    kc, kp, kt, kn = W.train_tensors(kmodel, _P)
    kopt = Fused_L_BFGS_B_optimize(kmodel, kt, kn, kc, kp, device="cpu")
    return {
        "ls": float(opt.kernel.deformation.length_scale()),
        "jax_ls": float(jopt.kernel.deformation.length_scale()),
        "k2": [float(kopt.kernel.deformation.length_scale()),
               float(kopt.noise())],
    }


def _port_value_and_grad(loss_name, batch=None, at=0.07):
    from muygpys_torch import optimize as O

    model = W.matern_model()
    cw, pw, bt, bnt = W.train_tensors(model, _P, batch)
    obj = O.L_BFGS_B_optimize.make_obj_fn(
        model, bt, bnt, cw, pw, loss_fn=getattr(O, f"{loss_name}_fn")
    )
    return W.value_and_grad(obj, "length_scale", at)


def test_ranks_agree(ranks):
    """Every rank holds the same values (lockstep, as the JAX package's
    multi-process test asserts across processes)."""
    rank_only = {"local_rows", "sub_slice", "sub_obj"}
    for other in ranks[1:]:
        for key, want in ranks[0].items():
            if key in rank_only:
                continue
            got = other[key]
            if isinstance(want, str):
                assert got == want, key
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
    assert ranks[0]["sub_obj"] == ranks[1]["sub_obj"]
    assert [r["local_rows"] for r in ranks] == [256 // WORLD] * WORLD


def test_sharded_objective_matches_serial(r0):
    serial, _ = _port_value_and_grad("lool")
    np.testing.assert_allclose(r0["obj"], serial, rtol=1e-10)
    np.testing.assert_allclose(r0["obj_float"], serial, rtol=1e-10)
    np.testing.assert_allclose(r0["obj"], _jax_vag("lool", None)[0],
                               rtol=1e-8)


def test_sharded_gradient_matches_serial(r0):
    """No world-size factor: the gradient through the all-reduces equals
    the serial one."""
    _, g_serial = _port_value_and_grad("lool")
    np.testing.assert_allclose(r0["grad"], g_serial, rtol=1e-9)
    np.testing.assert_allclose(r0["grad"], _jax_vag("lool", None)[1],
                               rtol=1e-6)


@pytest.mark.parametrize("loss", ["lool", "mse", "looph"])
def test_ragged_sharded_objective_matches_serial(r0, loss):
    """77 rows on 4 ranks: padded to 80 with edge rows and 0/1 weights; the
    value, the gradient and sigma^2 inside equal the unpadded serial ones."""
    assert r0["ragged_rows"] == 80 and r0["ragged_weight"] == 77
    v_serial, g_serial = _port_value_and_grad(loss, batch=77)
    v, g = r0[f"ragged_{loss}"]
    np.testing.assert_allclose(v, v_serial, rtol=1e-10)
    np.testing.assert_allclose(g, g_serial, rtol=1e-9)
    jv, jg = _jax_vag(loss, 77)
    np.testing.assert_allclose(v, jv, rtol=1e-8)
    np.testing.assert_allclose(g, jg, rtol=1e-6)


def test_sharded_posterior_matches_serial(r0):
    import jax.numpy as jnp

    assert r0["posterior_sharded"]
    model = W.matern_model()
    cw, pw, bt, bnt = W.train_tensors(model, _P)
    Kin, Kcross = model.kernel(pw), model.kernel(cw)
    close = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        r0["mean"], model.posterior_mean(Kin, Kcross, bnt).numpy(), **close
    )
    np.testing.assert_allclose(
        r0["var"], model.posterior_variance(Kin, Kcross).numpy(), **close
    )
    jm, (jcw, jpw, _, jbnt) = _jax_problem(_P)
    jKin, jKc = jm.kernel(jpw), jm.kernel(jcw)
    np.testing.assert_allclose(
        r0["mean"], np.asarray(jm.posterior_mean(jKin, jKc, jbnt)),
        rtol=1e-8, atol=1e-10,
    )
    np.testing.assert_allclose(
        r0["var"], np.asarray(jm.posterior_variance(jKin, jKc)),
        rtol=1e-8, atol=1e-10,
    )
    del jnp


def test_sharded_scale_optimization(r0):
    """The analytic sigma^2 over the sharded batch reduces its numerator
    and its count globally."""
    model = W.matern_model()
    cw, pw, bt, bnt = W.train_tensors(model, _P)
    model.optimize_scale(pw, bnt)
    np.testing.assert_allclose(r0["scale"], float(model.scale()), rtol=1e-10)
    jm, (_, jpw, _, jbnt) = _jax_problem(_P)
    jm.optimize_scale(jpw, jbnt)
    np.testing.assert_allclose(r0["scale"], float(jm.scale()), rtol=1e-10)


def test_sharded_optimization_recovers_like_serial(r0):
    optima = _serial_optima()
    np.testing.assert_allclose(r0["opt_ls"], optima["ls"], rtol=1e-5)
    np.testing.assert_allclose(r0["opt_ls"], optima["jax_ls"], rtol=1e-3)


def test_sharded_knn_matches_serial(r0):
    import jax.numpy as jnp

    from muygpys_tpu.neighbors import _brute_force_knn

    idx_s, d2_s = _brute_force_knn(
        jnp.asarray(_P["knn_train"]), jnp.asarray(_P["knn_queries"]), 12
    )
    np.testing.assert_allclose(
        r0["knn_d2"], np.asarray(d2_s), rtol=1e-9, atol=1e-12
    )
    assert (r0["knn_idx"] == np.asarray(idx_s)).mean() > 0.999


def test_sharded_knn_rejects_ragged(r0):
    assert "must divide" in r0["knn_ragged"]


def test_sharded_heteroscedastic_and_fast_paths(r0):
    from muygpys_torch.gp.noise import HeteroscedasticNoise
    from muygpys_torch.ops import solve as solve_ops

    assert r0["fast_sharded"]
    Kin, Kcross, y, noise = (torch.as_tensor(_P[k]) for k in (
        "Kin_h", "Kcross_h", "y_h", "noise_h"))
    coeffs = solve_ops.fast_posterior_mean_precompute(
        HeteroscedasticNoise(noise).perturb(Kin), y
    )
    fast = solve_ops.fast_posterior_mean(Kcross, coeffs)
    close = dict(rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(r0["coeffs"], coeffs.numpy(), **close)
    np.testing.assert_allclose(r0["fast"], fast.numpy(), **close)

    import jax.numpy as jnp

    from muygpys_tpu.gp.noise import HeteroscedasticNoise as JH
    from muygpys_tpu.ops import solve as jsolve

    jc = jsolve.fast_posterior_mean_precompute(
        JH(jnp.asarray(_P["noise_h"])).perturb(jnp.asarray(_P["Kin_h"])),
        jnp.asarray(_P["y_h"]),
    )
    jf = jsolve.fast_posterior_mean(jnp.asarray(_P["Kcross_h"]), jc)
    np.testing.assert_allclose(r0["coeffs"], np.asarray(jc), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(r0["fast"], np.asarray(jf), rtol=1e-10,
                               atol=1e-12)


def _jax_shear(p, ls, bounds="fixed"):
    import jax.numpy as jnp

    from muygpys_tpu.gp import MuyGPS
    from muygpys_tpu.gp.deformation import F2, DifferenceIsotropy
    from muygpys_tpu.gp.hyperparameter import FixedScale, Parameter
    from muygpys_tpu.gp.kernels.experimental import ShearKernel
    from muygpys_tpu.gp.noise import ShearNoise33

    model = MuyGPS(
        kernel=ShearKernel(deformation=DifferenceIsotropy(
            F2, length_scale=Parameter(ls, bounds))),
        noise=ShearNoise33(1e-4),
        scale=FixedScale(),
    )
    pts = jnp.asarray(p["pts"])
    bni = p["shear_bni"]
    pw = model.kernel.deformation.pairwise_tensor(pts, bni)
    cw = model.kernel.deformation.crosswise_tensor(
        pts, pts, np.arange(pts.shape[0]), bni
    )
    bt = jnp.asarray(p["shear_targets"])
    bnt = jnp.asarray(p["shear_targets"][bni].swapaxes(-2, -1))
    return model, (cw, pw, bt, bnt)


def test_sharded_shear_objective_matches_serial(r0):
    """The shear family over the sharded batch: the generic objective
    (mse) and the shear assembly (mse, lool), value and gradient.  JAX's
    side is its shear assembly in the batched layout (its generic chain
    gives the same objective: tests/test_torch_shear_objective.py)."""
    from muygpys_torch import optimize as O
    from muygpys_torch.optimize.shear_objective import (
        make_shear_loo_objective,
    )

    model = W.shear_model(0.15, (0.02, 0.5))
    cw, pw, bt, bnt = W.shear_tensors(model, _P)
    obj = O.L_BFGS_B_optimize.make_obj_fn(model, bt, bnt, cw, pw,
                                          loss_fn=O.mse_fn)
    v, g = W.value_and_grad(obj, "length_scale", 0.1)
    np.testing.assert_allclose(r0["shear_generic"][0], v, rtol=1e-9)
    np.testing.assert_allclose(r0["shear_generic"][1], g, rtol=1e-8)
    for loss in ("mse", "lool"):
        fobj, _ = make_shear_loo_objective(model, bt, bnt, cw, pw, loss=loss,
                                           layout="batched", device="cpu")
        v, g = W.value_and_grad(
            lambda length_scale: fobj({"length_scale": length_scale}),
            "length_scale", 0.1,
        )
        np.testing.assert_allclose(r0[f"shear_{loss}"][0], v, rtol=1e-9)
        np.testing.assert_allclose(r0[f"shear_{loss}"][1], g, rtol=1e-8)
        jv, jg = _jax_shear_vag(loss)
        np.testing.assert_allclose(r0[f"shear_{loss}"][0], jv, rtol=1e-9)
        np.testing.assert_allclose(r0[f"shear_{loss}"][1], jg, rtol=1e-7)
        if loss == "mse":
            np.testing.assert_allclose(r0["shear_generic"][0], jv,
                                       rtol=1e-9)
            np.testing.assert_allclose(r0["shear_generic"][1], jg,
                                       rtol=1e-7)


def test_sharded_shear_posterior_matches_serial(r0):
    model = W.shear_model(0.12)
    cw, pw, bt, bnt = W.shear_tensors(model, _P)
    serial = model.posterior_mean(model.kernel(pw), model.kernel(cw), bnt)
    np.testing.assert_allclose(r0["shear_posterior"], serial.numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(r0["shear_posterior"], _jax_shear_mean(),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("loss", ["lool", "mse", "looph"])
def test_sharded_k2_objective_matches_serial(r0, loss):
    """K2 on each rank's rows, the epilogue's sums all-reduced: value and
    gradient equal the serial K2 objective's (no world-size factor), and
    for lool JAX's fused objective."""
    from muygpys_torch.optimize.fused_objective import (
        make_fused_train_objective,
    )

    model = W.matern_model(noise_bounds=(1e-5, 1e-1))
    cw, pw, bt, bnt = W.train_tensors(model, _P)
    fused, names = make_fused_train_objective(model, bt, bnt, cw, pw,
                                              loss=loss, device="cpu")
    v, g = fused({"length_scale": 0.07, "noise": 2e-3})
    serial = [float(v)] + [float(g[n]) for n in names]
    got = r0[f"k2_{loss}"]
    np.testing.assert_allclose(got[0], serial[0], rtol=1e-10)
    np.testing.assert_allclose(got[1:], serial[1:], rtol=1e-9)

    if loss != "lool":
        # the serial K2 objective of these losses is held to JAX's in
        # tests/test_torch_fused_train.py
        return
    jnames, jvals = _jax_k2(loss)
    assert jnames == list(names)
    np.testing.assert_allclose(got[0], jvals[0], rtol=1e-8)
    np.testing.assert_allclose(got[1:], jvals[1:], rtol=1e-6)


def test_sharded_fused_chassis_matches_serial(r0):
    np.testing.assert_allclose(r0["k2_opt"], _serial_optima()["k2"],
                               rtol=1e-5)


def test_local_chunk_slice_submesh(ranks):
    """Row arithmetic against THE MESH: a sub-mesh of ranks 0 and 1 chunks
    12 rows in halves, ranks outside it own none, and the ragged error
    names the mesh's device count."""
    assert [r["sub_slice"] for r in ranks] == [(0, 6), (6, 12), (0, 0),
                                               (0, 0)]
    assert "device count 2" in ranks[0]["sub_ragged"]


def test_shard_ragged_global_submesh(ranks):
    """shard_ragged_global pads to the SUB-mesh's multiple and the weighted
    objective equals the unpadded serial value."""
    assert ranks[0]["sub_rows"] == 78
    serial, _ = _port_value_and_grad("lool", batch=77)
    np.testing.assert_allclose(ranks[0]["sub_obj"], serial, rtol=1e-10)
