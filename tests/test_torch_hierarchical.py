"""Hierarchical (nonstationary) length scales in muygpys_torch against
muygpys_tpu (mirrors tests/test_nonstationary.py), f64 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import muygpys_tpu.gp as jgp
import muygpys_tpu.gp.deformation as jdef
import muygpys_tpu.gp.hyperparameter as jhyp
import muygpys_tpu.gp.hyperparameter.experimental as jexp
import muygpys_tpu.gp.kernels as jker
import muygpys_tpu.gp.noise as jnoise
import muygpys_tpu.optimize as jopt
from muygpys_tpu.optimize.fast_objective import (
    make_fast_loo_objective as jax_fast_objective,
)
from muygpys_torch.gp import MuyGPS
from muygpys_torch.gp.deformation import Isotropy, l2
from muygpys_torch.gp.hyperparameter import (
    AnalyticScale,
    Parameter,
    VectorParameter,
)
from muygpys_torch.gp.hyperparameter.experimental import (
    HierarchicalParameter,
    NamedHierarchicalParameter,
    NamedHierarchicalVectorParameter,
    sample_knots,
)
from muygpys_torch.gp.kernels import RBF, Matern
from muygpys_torch.gp.noise import HomoscedasticNoise
from muygpys_torch.optimize import (
    Fused_Device_LBFGS_optimize,
    Fused_L_BFGS_B_optimize,
    L_BFGS_B_optimize,
    lool_fn,
    make_device_trainer,
    make_fast_loo_objective,
)

KNOTS = 5


@pytest.mark.parametrize("kernel", ["rbf", "matern"])
def test_parameter_values_match_jax(kernel, rng):
    """Shapes and per-point values within 1e-10 of JAX; near a knot the
    field approaches the knot's value (tests/test_nonstationary.py)."""
    knot_count, batch_count, feat = 10, 50, 4
    knots = np.asarray(sample_knots(feat, knot_count))
    assert knots.shape == (knot_count, feat)
    values = rng.uniform(0.2, 0.8, knot_count)
    port_kernel = {"rbf": RBF, "matern": Matern}[kernel]
    jax_kernel = {"rbf": jker.RBF, "matern": jker.Matern}[kernel]
    port = NamedHierarchicalParameter("custom_param_name", HierarchicalParameter(
        knots, VectorParameter(*[Parameter(float(v)) for v in values]),
        port_kernel(),
    ))
    ref = jexp.NamedHierarchicalParameter(
        "custom_param_name", jexp.HierarchicalParameter(
            jnp.asarray(knots),
            jhyp.VectorParameter(*[jhyp.Parameter(float(v)) for v in values]),
            jax_kernel(),
        ),
    )
    assert port._Kin_higher.dtype == torch.float64
    assert port._Kin_higher.device.type == "cpu"
    bf = rng.uniform(size=(batch_count, feat))
    got = port(torch.as_tensor(bf))
    assert got.shape == (batch_count,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(bf))),
                               rtol=0, atol=1e-10)
    near = port(torch.as_tensor(knots))
    np.testing.assert_allclose(near.numpy(), values, atol=0.1)
    # proposed knot values by name, in f32 features' dtype
    proposed = {f"custom_param_name{i}": 0.3 for i in range(knot_count)}
    got32 = port(torch.as_tensor(bf, dtype=torch.float32), **proposed)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(
        got32.numpy(), np.asarray(ref(jnp.asarray(bf), **proposed)),
        rtol=1e-5,
    )
    assert port.knot_values().tolist() == pytest.approx(values.tolist())


def test_vector_parameter_and_apply_fn():
    from muygpys_torch.gp.hyperparameter import NamedVectorParameter

    vec = NamedVectorParameter("ls", VectorParameter(Parameter(0.5),
                                                     Parameter(2.0)))
    out = vec.apply_fn(lambda **kw: kw)(ls1=3.0, other=1)
    assert out == {"ls0": 0.5, "ls1": 3.0, "other": 1}
    knots = np.array([[0.2], [0.8]])
    hier = NamedHierarchicalVectorParameter("h", VectorParameter(
        HierarchicalParameter(knots, VectorParameter(
            Parameter(0.3), Parameter(0.6)), RBF()),
    ))
    params, rest = hier.filter_kwargs(batch_features=torch.tensor([[0.5]]),
                                      other=2)
    assert set(params) == {"h0"} and rest == {
        "batch_features": rest["batch_features"], "other": 2}
    assert params["h0"].shape == ()


def _pair(knots, nn_noise=1e-3, kernel="matern"):
    values = [Parameter(0.5, (0.1, 2.0)) for _ in range(len(knots))]
    jvalues = [jhyp.Parameter(0.5, (0.1, 2.0)) for _ in range(len(knots))]
    port = MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=HierarchicalParameter(
                knots, VectorParameter(*values), RBF())
        )),
        noise=HomoscedasticNoise(nn_noise), scale=AnalyticScale(),
    )
    ref = jgp.MuyGPS(
        kernel=jker.Matern(smoothness=jhyp.Parameter(1.5),
                           deformation=jdef.Isotropy(
            jdef.l2, length_scale=jexp.HierarchicalParameter(
                jnp.asarray(knots), jhyp.VectorParameter(*jvalues),
                jker.RBF()),
        )),
        noise=jnoise.HomoscedasticNoise(nn_noise), scale=jhyp.AnalyticScale(),
    )
    return port, ref


@pytest.fixture(scope="module")
def batch(rng):
    knots = np.asarray(sample_knots(2, KNOTS))
    xtr = rng.uniform(size=(100, 2))
    ytr = rng.standard_normal((100, 1))
    bi = np.arange(32)
    bni = rng.integers(0, 100, size=(32, 8))
    port, ref = _pair(knots)
    tb = port.make_train_tensors(bi, bni, torch.as_tensor(xtr),
                                 torch.as_tensor(ytr))
    jb = ref.make_train_tensors(bi, bni, jnp.asarray(xtr), jnp.asarray(ytr))
    return dict(knots=knots, bf=xtr[bi], port=port, ref=ref, tb=tb, jb=jb)


PROPOSAL = {f"length_scale{i}": 0.3 + 0.1 * i for i in range(KNOTS)}


def test_model_surface_and_kernel(batch):
    port, ref = batch["port"], batch["ref"]
    names, _, bounds = port.get_opt_params()
    assert names == [f"length_scale{i}" for i in range(KNOTS)]
    assert names == ref.get_opt_params()[0]
    np.testing.assert_array_equal(bounds, [(0.1, 2.0)] * KNOTS)
    bf = torch.as_tensor(batch["bf"])
    Kin = port.kernel(batch["tb"][1], batch_features=bf)
    assert Kin.shape == (32, 8, 8)
    jKin = ref.kernel(batch["jb"][1], batch_features=jnp.asarray(batch["bf"]))
    np.testing.assert_allclose(Kin.numpy(), np.asarray(jKin), rtol=0,
                               atol=1e-7)
    with pytest.raises(ValueError, match="batch_features"):
        port.kernel(batch["tb"][1])
    scaled = port.optimize_scale(batch["tb"][1], batch["tb"][3],
                                 batch_features=bf)
    ref.optimize_scale(batch["jb"][1], batch["jb"][3],
                       batch_features=jnp.asarray(batch["bf"]))
    assert float(scaled.scale()) == pytest.approx(float(ref.scale()),
                                                  rel=1e-7)


# Knot layouts of the objective comparison: scipy's LatinHypercube(2,
# scramble=False, seed=s) over the data of _layout_batch.  Seeds 115, 288,
# 169 and 297 are where a sweep of 300 layouts found the two packages
# furthest apart (6.5e-10, 2.2e-10, 4.2e-11, 1.9e-11 relative); seed 0 is
# an ordinary one.  At those four the proposal's field sinks to the softplus
# floor (a length scale of 1e-6 to 5e-5) at a batch point, where the
# objective resolves the ~1e-8 rounding of a point's distance to itself:
# JAX's own objective on the port's (centred) distance tensors differs
# from JAX's on its own (uncentred) by the same amounts, while on the same
# tensors the two packages agree within 1.1e-12 over all 300 layouts.
# Neither the knot system's single LU factorization (JAX's Cholesky
# against its LU: <= 1.1e-12) nor its conditioning (9.4e3 at seed 115) is
# the cause.
LAYOUT_SEEDS = (115, 288, 169, 297, 0)
# the full chain: 3x the largest spread of JAX's objective between the two
# distance assemblies (6.5e-10, seed 115)
CHAIN_RTOL = 2e-9


@pytest.fixture(scope="module")
def layout_data():
    import zlib

    rng = np.random.default_rng(zlib.crc32(b"test_torch_hierarchical"))
    xtr = rng.uniform(size=(100, 2))
    ytr = rng.standard_normal((100, 1))
    return xtr, ytr, np.arange(32), rng.integers(0, 100, size=(32, 8))


def _layout_batch(layout_data, seed):
    from scipy.stats.qmc import LatinHypercube

    xtr, ytr, bi, bni = layout_data
    port, ref = _pair(LatinHypercube(2, scramble=False, seed=seed).random(
        KNOTS))
    tb = port.make_train_tensors(bi, bni, torch.as_tensor(xtr),
                                 torch.as_tensor(ytr))
    jb = ref.make_train_tensors(bi, bni, jnp.asarray(xtr), jnp.asarray(ytr))
    return dict(bf=xtr[bi], port=port, ref=ref, tb=tb, jb=jb)


@pytest.mark.parametrize("seed", LAYOUT_SEEDS)
def test_objectives_with_batch_features_match_jax(layout_data, seed):
    """The generic LOO objective and the lanes and batched fast objectives,
    each against JAX's, at one proposal of the knot values: on JAX's
    distance tensors within 1e-10, each package on its own within
    CHAIN_RTOL (the comment above LAYOUT_SEEDS)."""
    batch = _layout_batch(layout_data, seed)
    tb, jb = batch["tb"], batch["jb"]
    bf = batch["bf"]
    jax_dists = (torch.as_tensor(np.asarray(jb[0])),
                 torch.as_tensor(np.asarray(jb[1])))
    ref_obj = jopt.L_BFGS_B_optimize.make_obj_fn(
        batch["ref"], jb[2], jb[3], jb[0], jb[1],
        batch_features=jnp.asarray(bf), loss_fn=jopt.lool_fn,
    )
    want = float(ref_obj(**PROPOSAL))
    for (cw, pw), rel in ((jax_dists, 1e-10), (tb[:2], CHAIN_RTOL)):
        port_obj = L_BFGS_B_optimize.make_obj_fn(
            batch["port"], tb[2], tb[3], cw, pw,
            batch_features=torch.as_tensor(bf), loss_fn=lool_fn,
        )
        assert float(port_obj(**PROPOSAL)) == pytest.approx(want, rel=rel)
    for layout in ("lanes", "batched"):
        jfast, _ = jax_fast_objective(
            batch["ref"], jb[2], jb[3], jb[0], jb[1], layout=layout,
            batch_features=jnp.asarray(bf),
        )
        want = float(jfast(PROPOSAL))
        for (cw, pw), rel in ((jax_dists, 1e-10), (tb[:2], CHAIN_RTOL)):
            fast, names = make_fast_loo_objective(
                batch["port"], tb[2], tb[3], cw, pw, layout=layout,
                batch_features=bf, device="cpu",
            )
            assert names == list(PROPOSAL)
            assert float(fast(PROPOSAL)) == pytest.approx(want, rel=rel)
        with pytest.raises(ValueError, match="batch_features"):
            make_fast_loo_objective(batch["port"], tb[2], tb[3], tb[0],
                                    tb[1], layout=layout, device="cpu")


def test_kernel_engines_name_lanes_and_lanes_trains(batch):
    """K2 takes no hierarchical field: both "kernel" engines raise before
    any launch, naming engine="lanes", which trains the model (held to
    the generic chassis' optimum)."""
    tb, bf = batch["tb"], batch["bf"]
    args = (batch["port"], tb[2], tb[3], tb[0], tb[1])
    with pytest.raises(ValueError, match='engine="lanes"'):
        Fused_L_BFGS_B_optimize(*args, batch_features=bf, device="cpu")
    with pytest.raises(ValueError, match='engine="lanes"'):
        Fused_Device_LBFGS_optimize(*args, batch_features=bf, device="cpu")
    lanes = Fused_L_BFGS_B_optimize(*args, engine="lanes",
                                    batch_features=bf, device="cpu")
    generic = L_BFGS_B_optimize(*args, batch_features=torch.as_tensor(bf),
                                loss_fn=lool_fn)
    np.testing.assert_allclose(lanes.get_opt_params()[1],
                               generic.get_opt_params()[1], rtol=1e-4)
    assert not np.allclose(lanes.get_opt_params()[1], 0.5)


def _field(rng, n):
    """tests/test_nonstationary.py's field: ls 0.08 left of 0.5, 0.6 right,
    a Gibbs-kernel draw."""
    x = rng.uniform(size=(n, 1))
    ls_true = np.where(x[:, 0] < 0.5, 0.08, 0.6)
    lsi, lsj = ls_true[:, None], ls_true[None, :]
    pref = np.sqrt(2 * lsi * lsj / (lsi**2 + lsj**2))
    d2 = (x[:, 0:1] - x[None, :, 0]) ** 2
    K = pref * np.exp(-d2 / (lsi**2 + lsj**2)) + 1e-8 * np.eye(n)
    y = (np.linalg.cholesky(K) @ rng.standard_normal(n))[:, None]
    return x, y


def test_device_trainer_recovers_the_field_and_reads_new_features(rng):
    """make_device_trainer(...)(..., batch_features=) on the CPU: the
    field's ordering recovered at the knots (right/left > 1.5), and a
    second batch through the same trainer uses ITS features: the result
    equals a fresh trainer's on that batch, not the first batch's."""
    from muygpys_torch.neighbors import NN_Wrapper

    n, nn, batch = 420, 16, 128
    x, y = _field(rng, n)
    knots = np.array([[0.15], [0.35], [0.65], [0.85]])
    values = VectorParameter(*[Parameter(0.3, (0.02, 1.5))
                               for _ in range(4)])
    model = MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=HierarchicalParameter(knots, values, RBF()))),
        noise=HomoscedasticNoise(1e-5), scale=AnalyticScale(),
    )
    nbrs = NN_Wrapper(x, nn, device="cpu")
    bi = rng.choice(n, batch, replace=False)
    bni, _ = nbrs.get_batch_nns(bi)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    cw, pw, bt, bnt = model.make_train_tensors(bi, bni, xt, yt)
    trainer = make_device_trainer(model, loss="lool", device="cpu")
    opt, info = trainer(bt, bnt, cw, pw, batch_features=xt[bi])
    assert info["iterations"] > 0 and np.isfinite(info["value"])
    knots_ls = [float(opt.kernel._hyperparameters[f"length_scale{i}"]())
                for i in range(4)]
    left, right = np.mean(knots_ls[:2]), np.mean(knots_ls[2:])
    assert right / left > 1.5, knots_ls

    # the second batch: same shapes, other points and features
    bi2 = rng.choice(n, batch, replace=False)
    bni2, _ = nbrs.get_batch_nns(bi2)
    tensors2 = model.make_train_tensors(bi2, bni2, xt, yt)
    cw2, pw2, bt2, bnt2 = tensors2
    again, info2 = trainer(bt2, bnt2, cw2, pw2, batch_features=xt[bi2])
    assert trainer.cache_size() == 1
    fresh, info_f = make_device_trainer(model, device="cpu")(
        bt2, bnt2, cw2, pw2, batch_features=xt[bi2]
    )
    np.testing.assert_allclose(again.get_opt_params()[1],
                               fresh.get_opt_params()[1], rtol=1e-10)
    assert info2["value"] == pytest.approx(info_f["value"], rel=1e-12)
    # the features matter: the second batch's targets on the first
    # batch's features train to another optimum
    stale, _ = make_device_trainer(model, device="cpu")(
        bt2, bnt2, cw2, pw2, batch_features=xt[bi]
    )
    assert not np.allclose(stale.get_opt_params()[1],
                           fresh.get_opt_params()[1], rtol=1e-3)
