"""FastServer(mesh=, shard=) of the port on a world of 8 gloo ranks, against
the JAX package's sharded server on its 8-device virtual mesh and the
port's serial server (tests/test_serve.py's mesh cases, with its bucket
sizes and its refusals).

On the CPU the port runs the kernels' plain versions; every server runs
eagerly (a gloo mesh is not captured).  Limits: sharded against serial
lanes and shear at rtol 1e-10 / atol 1e-12 (JAX's); the fused and kernel
engines against the reference chain at rtol 1e-8 / atol 1e-10 (JAX's);
against JAX's sharded servers at the port's serial serving limits (lanes
rtol 1e-5 / atol 1e-8; the coords solve and the shear lanes engine 1e-8 /
1e-10; the shear kernel engine 1e-6 / 1e-9).  Every rank returns the whole
answer, equal on every rank.
"""

import functools

import numpy as np
import pytest

import _torch_parallel_worker as W

WORLD = 8


@pytest.fixture(scope="module")
def payload(rng):
    spts = np.random.default_rng(5).uniform(size=(250, 2))
    phase = spts @ (2 * np.pi * np.array([3.0, 5.0]))
    return {
        "xtr": rng.uniform(size=(300, 3)),
        "ytr": rng.standard_normal((300, 1)),
        "xte": rng.uniform(size=(130, 3)),
        "shear_pts": spts,
        "shear_targets3": np.stack(
            [np.sin(phase), 0.4 * np.cos(phase), 0.3 * np.sin(2 * phase)],
            axis=1,
        ),
        "shear_xte": np.random.default_rng(6).uniform(size=(40, 2)),
    }


@pytest.fixture(scope="module")
def ranks(payload):
    global _P
    _P = payload
    world = W.World("serve_mesh_cases", WORLD, payload)
    _jax_servers()
    _port_serial()
    return world.results()


def _jax_model():
    from muygpys_tpu.gp import MuyGPS
    from muygpys_tpu.gp.deformation import Isotropy, l2
    from muygpys_tpu.gp.hyperparameter import FixedScale, Parameter
    from muygpys_tpu.gp.kernels import Matern
    from muygpys_tpu.gp.noise import HomoscedasticNoise

    scale = FixedScale()
    scale._set(2.0)
    return MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5),
                      deformation=Isotropy(l2, length_scale=Parameter(0.5))),
        noise=HomoscedasticNoise(1e-3),
        scale=scale,
    )


@functools.cache
def _jax_servers():
    """JAX's sharded servers on the 8-device virtual mesh (its kernels
    interpreted) and its reference chain."""
    import jax.numpy as jnp

    from muygpys_tpu.gp import MuyGPS
    from muygpys_tpu.gp.deformation import F2, DifferenceIsotropy
    from muygpys_tpu.gp.hyperparameter import FixedScale, Parameter
    from muygpys_tpu.gp.kernels.experimental import ShearKernel
    from muygpys_tpu.gp.noise import ShearNoise33
    from muygpys_tpu.neighbors import NN_Wrapper
    from muygpys_tpu.pallas import fused_predict as fp
    from muygpys_tpu.parallel import make_mesh
    from muygpys_tpu.serve import FastServer

    xtr, ytr, xte = _P["xtr"], _P["ytr"], _P["xte"]
    model = _jax_model()
    mesh = make_mesh(8)
    nbrs = NN_Wrapper(xtr, 12, nn_method="exact")
    out = {"lanes": FastServer(model, nbrs, xtr, ytr, bucket=64,
                               engine="lanes", mesh=mesh).predict(xte[:100])}

    def reference(x, y, q, nb):
        nn_idx, _ = nb.get_nns(q)
        cw, pw, bnt = model.make_predict_tensors(
            np.arange(q.shape[0]), nn_idx, jnp.asarray(q), jnp.asarray(x),
            jnp.asarray(y),
        )
        Kin, Kc = model.kernel(pw), model.kernel(cw)
        return (np.asarray(model.posterior_mean(Kin, Kc, bnt)),
                np.asarray(model.posterior_variance(Kin, Kc)))

    out["reference"] = reference(xtr, ytr, xte[:100], nbrs)
    n = (xtr.shape[0] // 8) * 8
    nt = NN_Wrapper(xtr[:n], 12, nn_method="exact")
    out["train_reference"] = reference(xtr[:n], ytr[:n], xte[:50], nt)
    orig = fp.fused_predict_coords_bl
    fp.fused_predict_coords_bl = functools.partial(orig, interpret=True)
    try:
        out["train"] = FastServer(
            model, nt, xtr[:n], ytr[:n], bucket=64, engine="fused",
            mesh=mesh, shard="train",
        ).predict(xte[:50])
    finally:
        fp.fused_predict_coords_bl = orig

    smodel = MuyGPS(
        kernel=ShearKernel(deformation=DifferenceIsotropy(
            F2, length_scale=Parameter(0.08))),
        noise=ShearNoise33(1e-3 * 2.0 / 0.08**4),
        scale=FixedScale(),
    )
    snbrs = NN_Wrapper(_P["shear_pts"], 8, nn_method="exact")
    out["shear_lanes"] = FastServer(
        smodel, snbrs, _P["shear_pts"], _P["shear_targets3"], bucket=40,
        engine="lanes", mesh=mesh,
    ).predict(_P["shear_xte"])
    return out


@functools.cache
def _port_serial():
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    xtr, ytr, xte = _P["xtr"], _P["ytr"], _P["xte"]
    model = W.matern_model(ls=0.5, ls_bounds="fixed", scale=2.0)
    out = {"lanes": FastServer(
        model, NN_Wrapper(xtr, 12, device="cpu"), xtr, ytr, bucket=64,
        engine="lanes", device="cpu",
    ).predict(xte[:100])}
    smodel = W.shear_model(0.08, noise=1e-3 * 2.0 / 0.08**4)
    snbrs = NN_Wrapper(_P["shear_pts"], 8, device="cpu")
    for engine in ("lanes", "kernel"):
        out[f"shear_{engine}"] = FastServer(
            smodel, snbrs, _P["shear_pts"], _P["shear_targets3"], bucket=40,
            engine=engine, device="cpu",
        ).predict(_P["shear_xte"])
    return out


def _close(got, want, rtol, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


def test_ranks_agree_and_run_eagerly(ranks):
    for other in ranks[1:]:
        for key, want in ranks[0].items():
            if isinstance(want, tuple):
                for g, w in zip(other[key], want):
                    np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                assert other[key] == want, key
    # gloo on the CPU: every server runs its core eagerly
    assert ranks[0]["modes"] == ["eager"] * 6


def test_mesh_sharded_serving(ranks):
    """shard="queries": lanes equals the serial server exactly; kernel
    and fused equal the reference chain; all against JAX's sharded
    servers.  The refusals are JAX's."""
    r0, serial, jax_out = ranks[0], _port_serial(), _jax_servers()
    _close(r0["lanes"], serial["lanes"], 1e-10, 1e-12)
    _close(r0["lanes"], jax_out["lanes"], 1e-5, 1e-8)
    for engine in ("kernel", "fused"):
        _close(r0[engine], jax_out["reference"], 1e-8, 1e-10)
    assert "bucket 60 must divide by the mesh size 8" in r0["divide"]
    assert r0["reference"]


def test_mesh_train_sharded_serving(ranks):
    """shard="train": 37 rows a shard, each searched exactly, the union
    merged; equal to the reference chain and to JAX's train-sharded
    server."""
    r0, jax_out = ranks[0], _jax_servers()
    _close(r0["train"], jax_out["train_reference"], 1e-8, 1e-10)
    _close(r0["train"], jax_out["train"], 1e-8, 1e-10)
    assert r0["train_fused"] and r0["train_shard"]
    assert "must divide by the mesh size 8" in r0["train_divide"]


@pytest.mark.parametrize("engine", ["lanes", "kernel"])
def test_shear_mesh_sharded(ranks, engine):
    """The shear bucket (lanes; kernel = K5's plain version here) under
    shard="queries" equals the serial shear server and JAX's sharded lanes
    server."""
    r0, serial = ranks[0], _port_serial()
    got = r0[f"shear_{engine}"]
    assert got[0].shape == (40, 3) and got[1].shape == (40, 3, 3)
    _close(got, serial[f"shear_{engine}"], 1e-10, 1e-12)
    rtol, atol = (1e-8, 1e-10) if engine == "lanes" else (1e-6, 1e-9)
    _close(got, _jax_servers()["shear_lanes"], rtol, atol)
