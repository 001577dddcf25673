"""The slice end to end: the port's FastServer (on the CPU, through the
kernels' plain versions) against muygpys_tpu.serve.FastServer on the same
data, with the trained model carried across by convert.muygps_from_arrays.

Engines pair as fused <-> fused, kernel <-> pallas, lanes <-> lanes,
reference <-> reference.  Train 2048 at d = 2 makes the fused engine run the
candidate kernel and its pruned variant (spatial sort is on by default)."""

import numpy as np
import pytest
import torch

from _torch_models import carried, jax_model

from muygpys_tpu.neighbors import NN_Wrapper as JaxNN
from muygpys_tpu.serve import FastServer as JaxServer
from muygpys_torch.gpu import _build
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.serve import FastServer

NN = 12
BUCKET = 64


@pytest.fixture(scope="module")
def data(rng):
    xtr = rng.uniform(size=(2048, 2))
    ytr = rng.standard_normal((2048, 1))
    xte = rng.uniform(size=(100, 2))  # two buckets, the second padded
    eps = rng.uniform(1e-4, 1e-2, size=2048)
    return xtr, ytr, xte, eps


# (engine, kernel, nu, metric, anisotropic, heteroscedastic, extra kwargs)
CASES = [
    ("fused", "matern", 1.5, "l2", False, False, {}),
    ("fused", "matern", 2.5, "l2", True, True, {}),
    ("fused", "matern", 0.5, "l2", False, False, {"spatial_sort": False}),
    ("fused", "matern", 1.5, "l2", True, False, {"rerank": False}),
    ("kernel", "matern", 0.5, "l2", False, False, {}),
    ("kernel", "rbf", None, "F2", True, True, {}),
    ("lanes", "matern", 1.5, "l2", False, False, {}),
    ("lanes", "matern", np.inf, "l2", True, True, {}),
    ("reference", "matern", 1.5, "l2", False, False, {}),
    ("reference", "matern", 2.5, "l2", True, False, {}),
]


@pytest.mark.parametrize(
    "engine,kernel,nu,metric,aniso,hetero,kw", CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}-{'aniso' if c[4] else 'iso'}"
         f"-{'hetero' if c[5] else 'homo'}-{sorted(c[6])}" for c in CASES],
)
def test_server_matches_jax(data, engine, kernel, nu, metric, aniso, hetero,
                            kw):
    xtr, ytr, xte, eps = data
    jm = jax_model(
        kernel=kernel, nu=nu, metric=metric,
        ls=(0.4, 0.7) if aniso else 0.5,
        hetero=np.full((4, NN), 1e-3) if hetero else None,
    )
    tm = carried(jm)
    meas = eps if hetero else None
    jax_engine = "pallas" if engine == "kernel" else engine
    ref = JaxServer(
        jm, JaxNN(xtr, NN), xtr, ytr, bucket=BUCKET, engine=jax_engine,
        measurement_noise=meas, **kw,
    )
    port = FastServer(
        tm, NN_Wrapper(xtr, NN, device="cpu"), xtr, ytr, bucket=BUCKET,
        engine=engine, measurement_noise=meas, device="cpu", **kw,
    )
    if engine == "fused":
        assert port._spatial == ref._spatial
    _build.reset_launches()
    mean, var = port.predict(xte)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert sum(_build.launches.values()) == 0
    m0, v0 = ref.predict(xte)
    assert mean.shape == (100, 1) and var.shape == (100,)
    assert mean.dtype == np.float64
    # fused/kernel run K1's elimination in the TPU kernel's order, as
    # tests/test_serve.py holds the pallas engines; lanes and reference use
    # differently ordered solves (test_serve.py's engine tolerance)
    rtol, atol = (1e-8, 1e-10) if engine in ("fused", "kernel") else (1e-5, 1e-8)
    np.testing.assert_allclose(mean, np.asarray(m0), rtol=rtol, atol=atol)
    np.testing.assert_allclose(var, np.asarray(v0), rtol=rtol, atol=atol)


def test_fused_small_train_uses_exact_candidates(data):
    """Below 1024 training rows the fused engine takes exact brute-force
    candidates (no kernel), as in the JAX package."""
    xtr, ytr, xte, _ = data
    xtr, ytr = xtr[:300], ytr[:300]
    jm = jax_model()
    ref = JaxServer(jm, JaxNN(xtr, NN), xtr, ytr, bucket=BUCKET, engine="fused")
    port = FastServer(
        carried(jm), NN_Wrapper(xtr, NN, device="cpu"), xtr, ytr,
        bucket=BUCKET, engine="fused", device="cpu",
    )
    assert not port._spatial
    mean, var = port.predict(xte[:40])
    m0, v0 = ref.predict(xte[:40])
    np.testing.assert_allclose(mean, np.asarray(m0), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var, np.asarray(v0), rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError, match="spatial_sort"):
        FastServer(
            carried(jm), NN_Wrapper(xtr, NN, device="cpu"), xtr, ytr,
            bucket=BUCKET, engine="fused", spatial_sort=True, device="cpu",
        )


def test_multivariate_targets(data):
    """r = 2 responses through the fused and lanes engines."""
    xtr, _, xte, _ = data
    ytr = np.random.default_rng(3).standard_normal((2048, 2))
    jm = jax_model(nu=2.5)
    for engine in ("fused", "lanes"):
        ref = JaxServer(
            jm, JaxNN(xtr, NN), xtr, ytr, bucket=BUCKET, engine=engine
        )
        port = FastServer(
            carried(jm), NN_Wrapper(xtr, NN, device="cpu"), xtr, ytr,
            bucket=BUCKET, engine=engine, device="cpu",
        )
        mean, var = port.predict(xte[:40])
        m0, v0 = ref.predict(xte[:40])
        assert mean.shape == (40, 2)
        np.testing.assert_allclose(mean, np.asarray(m0), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(var, np.asarray(v0), rtol=1e-5, atol=1e-8)


def test_server_errors(data):
    xtr, ytr, _, _ = data
    tm = carried(jax_model())
    nbrs = NN_Wrapper(xtr, NN, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        FastServer(tm, nbrs, xtr, ytr, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        FastServer(tm, nbrs, xtr, ytr, shard="train", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        FastServer(tm, nbrs, xtr, ytr, engine="pallas", device="cpu")
    hm = carried(jax_model(hetero=np.full((4, NN), 1e-3)))
    with pytest.raises(ValueError, match="measurement_noise"):
        FastServer(hm, nbrs, xtr, ytr, device="cpu")
    with pytest.raises(ValueError, match="homoscedastic"):
        FastServer(
            hm, nbrs, xtr, ytr, engine="reference",
            measurement_noise=np.ones(2048), device="cpu",
        )
    with pytest.raises(ValueError, match="entries"):
        FastServer(
            hm, nbrs, xtr, ytr, measurement_noise=np.ones(5), device="cpu"
        )


def test_server_defaults_to_cuda(data, monkeypatch):
    xtr, ytr, _, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = carried(jax_model())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FastServer(tm, NN_Wrapper(xtr, NN, device="cpu"), xtr, ytr)
