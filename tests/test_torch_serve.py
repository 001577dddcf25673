"""The slice end to end: the port's FastServer (on the CPU, through the
kernels' plain versions) against muygpys_tpu.serve.FastServer on the same
data, with the trained model carried across by convert.muygps_from_arrays.

Engines pair as fused <-> fused, kernel <-> pallas, lanes <-> lanes,
reference <-> reference.  Train 2048 at d = 2 makes the fused engine run the
candidate kernel and its pruned variant (spatial sort is on by default)."""

import numpy as np
import pytest
import torch

from _torch_models import carried, carried_shear, jax_model, jax_shear_model

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
    # general smoothness: the traced-nu surrogate in fused and kernel, the
    # exact Bessel path in lanes and reference
    ("fused", "matern", 0.31, "l2", False, False, {}),
    ("fused", "matern", 1.2, "l2", True, True, {}),
    ("kernel", "matern", 4.8, "l2", False, False, {}),
    ("kernel", "matern", 2.0, "l2", True, False, {}),
    ("lanes", "matern", 1.2, "l2", False, True, {}),
    ("reference", "matern", 4.8, "l2", False, False, {}),
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


@pytest.mark.parametrize("engine", ["fused", "kernel"])
@pytest.mark.parametrize("nu", [0.31, 4.8])
def test_general_smoothness_matches_exact_chain(data, engine, nu):
    """The surrogate engines against the port's own reference engine (the
    exact Bessel path) at tests/test_serve.py's tolerances: the solve
    amplifies the surrogate's ~1e-9 kernel deviation by the neighborhood
    conditioning, and rough kernels (nu < 1/2) reach ~3e4 here."""
    xtr, ytr, xte, _ = data
    tm = carried(jax_model(nu=nu))
    nbrs = NN_Wrapper(xtr, NN, device="cpu")
    # no re-rank question: the exact index for the kernel engine, and the
    # fused engine's candidates re-ranked exactly
    got = FastServer(
        tm, nbrs, xtr, ytr, bucket=BUCKET, engine=engine, device="cpu"
    ).predict(xte[:40])
    want = FastServer(
        tm, nbrs, xtr, ytr, bucket=BUCKET, engine="reference", device="cpu"
    ).predict(xte[:40])
    rtol = 1e-3 if nu < 0.5 else 2e-6
    np.testing.assert_allclose(got[0], want[0], rtol=rtol, atol=1e-8)
    np.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=1e-8)


def test_general_smoothness_out_of_range(data):
    xtr, ytr, xte, _ = data
    nbrs = NN_Wrapper(xtr, NN, device="cpu")
    exotic = carried(jax_model(nu=25.0))
    for engine in ("fused", "kernel"):
        with pytest.raises(ValueError, match="general Matern smoothness"):
            FastServer(exotic, nbrs, xtr, ytr, bucket=BUCKET, engine=engine,
                       device="cpu")
    mean, var = FastServer(
        exotic, nbrs, xtr, ytr, bucket=BUCKET, engine="lanes", device="cpu"
    ).predict(xte[:10])
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    f2 = carried(jax_model(nu=1.2, metric="F2"))
    with pytest.raises(ValueError, match="requires the l2 metric"):
        FastServer(f2, nbrs, xtr, ytr, bucket=BUCKET, engine="kernel",
                   device="cpu")


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


class _ThreeRankMesh:
    """Stands for a mesh of three ranks where no world is up: the bucket
    check reads only its size."""

    def size(self):
        return 3


def test_server_errors(data):
    xtr, ytr, _, _ = data
    tm = carried(jax_model())
    nbrs = NN_Wrapper(xtr, NN, device="cpu")
    # as JAX: a bucket the mesh size does not divide is refused before the
    # mesh is used, and shard="train" without a mesh changes nothing
    with pytest.raises(ValueError, match="must divide by the mesh size 3"):
        FastServer(tm, nbrs, xtr, ytr, mesh=_ThreeRankMesh(), device="cpu")
    FastServer(tm, nbrs, xtr, ytr, shard="train", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        FastServer(tm, nbrs, xtr, ytr, engine="mosaic", device="cpu")
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


@pytest.fixture(scope="module")
def shear_data():
    """tests/test_serve.py's shear problem: 250 sky points, three smooth
    components, nn = 8, the nugget relative to the prior diagonal 2/ls^2."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(size=(250, 2))
    phase = pts @ (2 * np.pi * np.array([3.0, 5.0]))
    targets = np.stack(
        [np.sin(phase), 0.4 * np.cos(phase), 0.3 * np.sin(2 * phase)], axis=1
    )
    return pts, targets, rng.uniform(size=(70, 2))  # two buckets, one padded


SHEAR_LS = 0.08
SHEAR_NOISE = 1e-3 * 2.0 / SHEAR_LS**4


@pytest.mark.parametrize("engine", ["lanes", "kernel"])
@pytest.mark.parametrize("family", ["33", "23"])
def test_shear_server_matches_jax(shear_data, family, engine):
    """Both shear engines on device="cpu" against the JAX FastServer (lanes,
    and pallas in interpret mode), at tests/test_serve.py's rtol 1e-8 / atol
    1e-10: mean (count, 3), full covariance (count, 3, 3)."""
    pts, targets, xte = shear_data
    obs = targets if family == "33" else targets[:, 1:]
    jm = jax_shear_model(family, ls=SHEAR_LS, noise=SHEAR_NOISE, scale=1.7)
    ref = JaxServer(
        jm, JaxNN(pts, 8, nn_method="exact"), pts, obs, bucket=40,
        engine="pallas" if engine == "kernel" else "lanes",
    )
    port = FastServer(
        carried_shear(jm), NN_Wrapper(pts, 8, device="cpu"), pts, obs,
        bucket=40, engine=engine, device="cpu",
    )
    _build.reset_launches()
    mean, cov = port.predict(xte)
    assert sum(_build.launches.values()) == 0
    m0, c0 = ref.predict(xte)
    assert mean.shape == (70, 3) and cov.shape == (70, 3, 3)
    assert mean.dtype == np.float64
    np.testing.assert_allclose(mean, np.asarray(m0), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(cov, np.asarray(c0), rtol=1e-8, atol=1e-10)
    # a posterior covariance: symmetric, positive diagonal under the prior's
    np.testing.assert_allclose(cov, cov.transpose(0, 2, 1), rtol=1e-9, atol=1e-9)
    diag = np.diagonal(cov, axis1=1, axis2=2)
    assert (diag > 0).all()
    assert (diag < 1.7 * np.array([2.0, 1.0, 1.0]) / SHEAR_LS**2).all()


def test_shear_engines_agree(shear_data):
    """The kernel engine (K5's plain version here) and the lanes engine give
    the same numbers: the floored elimination and the floored Cholesky are
    one arithmetic."""
    pts, targets, xte = shear_data
    tm = carried_shear(jax_shear_model("33", ls=SHEAR_LS, noise=SHEAR_NOISE))
    nbrs = NN_Wrapper(pts, 8, device="cpu")
    outs = [
        FastServer(tm, nbrs, pts, targets, bucket=40, engine=engine,
                   device="cpu").predict(xte[:40])
        for engine in ("kernel", "lanes")
    ]
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-10, atol=1e-12)


def test_shear_server_errors(shear_data):
    """The four refusals of the JAX server and the observed-component
    check."""
    pts, targets, _ = shear_data
    tm = carried_shear(jax_shear_model("33", ls=SHEAR_LS, noise=SHEAR_NOISE))
    nbrs = NN_Wrapper(pts, 8, device="cpu")
    for engine in ("fused", "reference"):
        with pytest.raises(ValueError, match="shear models serve via"):
            FastServer(tm, nbrs, pts, targets, engine=engine, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        FastServer(tm, nbrs, pts, targets, engine="mosaic", device="cpu")
    with pytest.raises(ValueError, match="measurement noise"):
        FastServer(tm, nbrs, pts, targets, measurement_noise=np.ones(250),
                   device="cpu")
    with pytest.raises(ValueError, match="shards queries"):
        FastServer(tm, nbrs, pts, targets, shard="train", device="cpu")
    with pytest.raises(ValueError, match="unknown shard mode"):
        FastServer(tm, nbrs, pts, targets, shard="rows", device="cpu")
    with pytest.raises(ValueError, match="must divide by the mesh size 3"):
        FastServer(tm, nbrs, pts, targets, mesh=_ThreeRankMesh(),
                   device="cpu")
    with pytest.raises(ValueError, match="observes 3 components"):
        FastServer(tm, nbrs, pts, targets[:, 1:], device="cpu")
    two = carried_shear(jax_shear_model("23", ls=SHEAR_LS, noise=SHEAR_NOISE))
    with pytest.raises(ValueError, match="observes 2 components"):
        FastServer(two, nbrs, pts, targets, engine="kernel", device="cpu")


def test_server_refuses_unknown_kernels(data):
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import Parameter
    from muygpys_torch.gp.kernels import KernelFn
    from muygpys_torch.gp.muygps import MuyGPS

    class Other(KernelFn):
        def _make(self):
            self._make_base()

    xtr, ytr, _, _ = data
    model = MuyGPS(kernel=Other(Isotropy(l2, length_scale=Parameter(1.0))))
    with pytest.raises(ValueError, match="Matern/RBF/Shear"):
        FastServer(model, NN_Wrapper(xtr, NN, device="cpu"), xtr, ytr,
                   device="cpu")


def test_server_defaults_to_cuda(data, monkeypatch):
    xtr, ytr, _, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = carried(jax_model())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FastServer(tm, NN_Wrapper(xtr, NN, device="cpu"), xtr, ytr)
    shear = carried_shear(jax_shear_model("33"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FastServer(shear, NN_Wrapper(xtr, NN, device="cpu"), xtr,
                   np.zeros((2048, 3)), engine="kernel")


def test_pallas_is_the_kernel_engine(data):
    """``FastServer(engine="pallas")``, JAX's name, serves as the port's
    ``"kernel"`` engine does, bit for bit."""
    xtr, ytr, xte, _ = data
    tm = carried(jax_model(kernel="matern", nu=1.5, metric="l2", ls=0.5))
    out = {}
    for engine in ("kernel", "pallas"):
        server = FastServer(
            tm, NN_Wrapper(xtr, NN, device="cpu"), xtr, ytr, bucket=BUCKET,
            engine=engine, device="cpu",
        )
        assert server.engine == "kernel"
        out[engine] = server.predict(xte)
    for a, b in zip(out["kernel"], out["pallas"]):
        np.testing.assert_array_equal(a, b)
