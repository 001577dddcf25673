"""The deep-kernel layer, trainer and predictor (muygpys_torch.nn,
muygpys_torch.examples.deep_kernel) against the flax/optax ones of
muygpys_tpu on the same inputs, f64 on the CPU, from parameters carried
across by ``convert.deep_kernel_params_from_flax``.

JAX's fixture at its own size (tests/test_deep_kernel.py:34-44: 600 points
x 6 features, an MLP 6 -> 16 -> 2), its flax ``Dense`` layers holding
f64 parameters (flax keeps f32 ones by default, whose gradients and
updates round to f32).  Tolerances: the forward pass 1e-10 and the
predictions 1e-8, each relative to the largest entry of its tensor; the
loss gradient and the trained parameters 1e-8 relative to the largest
entry of the whole gradient or parameter set.  (The last layer's bias has
an exact gradient of zero, since translations leave distances alone, so
both packages give rounding noise there; and Adam divides each gradient
entry by its own running size, so an entry's rounding, small against the
whole gradient, becomes an update of its own size.)
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from muygpys_tpu.examples import deep_kernel as jdk
from muygpys_tpu.gp import MuyGPS as JMuyGPS
from muygpys_tpu.gp.deformation import Isotropy as JIso, l2 as jl2
from muygpys_tpu.gp.hyperparameter import Parameter as JParam
from muygpys_tpu.gp.kernels import Matern as JMatern
from muygpys_tpu.gp.noise import HomoscedasticNoise as JNoise
from muygpys_tpu.neighbors import NN_Wrapper as JaxNN
from muygpys_tpu.nn import DeepKernelMuyGPs as JDeep
from muygpys_tpu.ops import loss as jloss
from muygpys_torch import convert
from muygpys_torch.examples import deep_kernel as tdk
from muygpys_torch.gp import MuyGPS
from muygpys_torch.gp.deformation import Anisotropy, Isotropy, l2
from muygpys_torch.gp.hyperparameter import Parameter
from muygpys_torch.gp.kernels import Matern
from muygpys_torch.gp.noise import HomoscedasticNoise
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.nn import DeepKernelMuyGPs
from muygpys_torch.ops import loss as tloss

NN_COUNT = 20


class MLP(fnn.Module):
    width: int = 16
    out: int = 2

    @fnn.compact
    def __call__(self, x):
        x = fnn.Dense(self.width, param_dtype=jnp.float64)(x)
        x = fnn.tanh(x)
        return fnn.Dense(self.out, param_dtype=jnp.float64)(x)


def _jax_model(nu=1.5):
    return JDeep(embedding=MLP(), muygps_model=JMuyGPS(
        kernel=JMatern(smoothness=JParam(nu),
                       deformation=JIso(jl2, length_scale=JParam(1.0))),
        noise=JNoise(1e-3),
    ))


def _port_model(nu=1.5, deformation=None):
    embedding = torch.nn.Sequential(
        torch.nn.Linear(6, 16), torch.nn.Tanh(), torch.nn.Linear(16, 2)
    )
    return DeepKernelMuyGPs(embedding, MuyGPS(
        kernel=Matern(smoothness=Parameter(nu), deformation=deformation
                      or Isotropy(l2, length_scale=Parameter(1.0))),
        noise=HomoscedasticNoise(1e-3),
    ))


def _close(a, b, tol, scale=None):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b).max() if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _close_grads(port, ref, tol):
    """Each tensor within ``tol`` of the largest entry of all of ``ref``."""
    scale = max(float(r.abs().max()) for r in ref.values())
    assert set(port) == set(ref)
    for name in ref:
        _close(port[name], ref[name].numpy(), tol, scale)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# the last layer's bias: its exact gradient is zero, so Adam moves it by
# each package's rounding noise over its eps (~1e-6 in 5 steps)
TRANSLATION = "embedding.2.bias"


def _assert_params_match(port, flax_tree, tol):
    ref = convert.deep_kernel_params_from_flax(_numpy_tree(flax_tree),
                                               _port_model())
    for name in (TRANSLATION,):
        assert float(port[name].abs().max()) < 1e-5
        assert float(ref[name].abs().max()) < 1e-5
    _close_grads({n: p.numpy() for n, p in port.items() if n != TRANSLATION},
                 {n: r for n, r in ref.items() if n != TRANSLATION}, tol)


@pytest.fixture(scope="module")
def problem():
    """Targets depend on 2 of 6 features (tests/test_deep_kernel.py)."""
    rng = np.random.default_rng(0)
    n = 600
    X = rng.uniform(size=(n, 6))
    y = (np.sin(2 * np.pi * X[:, 0]) + np.cos(2 * np.pi * X[:, 1]))[:, None]
    y += 0.05 * rng.standard_normal((n, 1))
    batch = rng.choice(400, 200, replace=False)
    return X[:400], y[:400], X[400:], y[400:], batch


@pytest.fixture(scope="module")
def start(problem):
    """JAX's initial parameters (``PRNGKey(0)``) and the batch tensors."""
    xtr, ytr, _, _, batch = problem
    nn_idx = np.asarray(JaxNN(xtr, NN_COUNT).get_batch_nns(batch)[0])
    args = (jnp.asarray(xtr), jnp.asarray(batch), jnp.asarray(nn_idx),
            jnp.asarray(ytr)[nn_idx])
    flax_params = jax.jit(_jax_model().init)(jax.random.PRNGKey(0), *args)
    return flax_params, nn_idx, args


def _port_args(problem, nn_idx):
    xtr, ytr, _, _, batch = problem
    nn_idx = torch.as_tensor(np.array(nn_idx))
    return (torch.as_tensor(xtr), torch.as_tensor(batch), nn_idx,
            torch.as_tensor(ytr)[nn_idx])


def test_forward_matches_flax(problem, start):
    flax_params, nn_idx, args = start
    m0, v0 = _jax_model().apply(flax_params, *args)
    model = _port_model()
    params = convert.deep_kernel_params_from_flax(_numpy_tree(flax_params),
                                                  model)
    mean, var = functional_call(model, params, _port_args(problem, nn_idx))
    assert mean.shape == (200, 1) and var.shape == (200,)
    _close(mean.detach(), m0, 1e-10)
    _close(var.detach(), v0, 1e-10)


def test_loss_gradient_matches_jax(problem, start):
    """The lool gradient over every parameter (embedding and GP), through
    the pairwise distances' diagonal: within 1e-8 of JAX's."""
    flax_params, nn_idx, args = start
    _, ytr, _, _, batch = problem
    jm = _jax_model()

    def jax_loss(p):
        mean, var = jm.apply(p, *args)
        return jloss.lool_fn_unscaled(mean, jnp.asarray(ytr)[batch], var)

    jgrad = jax.jit(jax.grad(jax_loss))(flax_params)
    model = _port_model()
    params = {n: p.requires_grad_(True) for n, p in
              convert.deep_kernel_params_from_flax(
                  _numpy_tree(flax_params), model).items()}
    mean, var = functional_call(model, params, _port_args(problem, nn_idx))
    loss = tloss.lool_fn_unscaled(mean, torch.as_tensor(ytr)[batch], var)
    loss.backward()
    ref = convert.deep_kernel_params_from_flax(_numpy_tree(jgrad), model)
    _close_grads({n: p.grad.numpy() for n, p in params.items()}, ref, 1e-8)


@pytest.fixture(scope="module")
def jax_trained(problem):
    """JAX's 5 training steps, with no rebuild and with a rebuild every 2
    epochs."""
    xtr, ytr, _, _, batch = problem
    out = {}
    for freq in (10, 2):
        nbrs, params, info = jdk.train_deep_kernel_muygps(
            _jax_model(), xtr, ytr, batch, JaxNN(xtr, NN_COUNT),
            training_iterations=5, learning_rate=1e-2, scheduler_decay=0.95,
            update_frequency=freq, rng_key=jax.random.PRNGKey(0),
        )
        out[freq] = nbrs, params, info
    return out


@pytest.mark.parametrize("freq", [10, 2])
def test_training_matches_optax(problem, start, jax_trained, freq,
                                monkeypatch):
    """Five steps from JAX's initial parameters (the port's init helper
    patched to return them): final parameters within 1e-8, the final loss,
    and the rebuilt neighbour sets equal."""
    xtr, ytr, _, _, batch = problem
    flax_params = start[0]
    model = _port_model()
    carried = convert.deep_kernel_params_from_flax(_numpy_tree(flax_params),
                                                   model)
    monkeypatch.setattr(tdk, "_init_params",
                        lambda m, key=None, device=None: dict(carried))
    nbrs, params, info = tdk.train_deep_kernel_muygps(
        model, xtr, ytr, batch, NN_Wrapper(xtr, NN_COUNT, device="cpu"),
        training_iterations=5, learning_rate=1e-2, scheduler_decay=0.95,
        update_frequency=freq, device="cpu",
    )
    jnbrs, jparams, jinfo = jax_trained[freq]
    _assert_params_match(params, jparams, 1e-8)
    # the loss at the fifth step's parameters: lool at this start (Kin's
    # condition ~2e4, variances ~2e-4) moves ~1e2 times its parameters
    np.testing.assert_allclose(info["final_loss"], jinfo["final_loss"],
                               rtol=1e-6)
    assert info["rebuilds"] == (2 if freq == 2 else 0)
    i_t = nbrs.get_batch_nns(batch)[0]
    i_j = np.asarray(jnbrs.get_batch_nns(batch)[0])
    np.testing.assert_array_equal(i_t, i_j)
    # the model spec is left as it was
    for name, p in model.named_parameters():
        assert not p.requires_grad or p.grad is None


def test_predict_matches_jax(problem, jax_trained):
    xtr, ytr, xte, _, _ = problem
    jnbrs, jparams, _ = jax_trained[2]
    m0, v0 = jdk.predict_model(_jax_model(), jparams, xte, xtr, ytr, jnbrs,
                               NN_COUNT)
    model = _port_model()
    params = convert.deep_kernel_params_from_flax(_numpy_tree(jparams), model)
    # the index of the last rebuild (epoch 4 of 5), on JAX's embedding
    nbrs = NN_Wrapper(np.asarray(jnbrs.train), NN_COUNT, device="cpu")
    for fn in (tdk.predict_model, tdk.predict_single_model,
               tdk.predict_multiple_model):
        mean, var = fn(model, params, xte, xtr, ytr, nbrs, NN_COUNT)
        _close(mean, m0, 1e-8)
        _close(var, v0, 1e-8)


def test_update_nearest_neighbors(problem):
    """tests/test_deep_kernel.py's shapes: the rebuilt index lives in the
    embedded space."""
    xtr, ytr, _, _, _ = problem
    model = _port_model()
    params = tdk._init_params(model, 1, device="cpu")
    nbrs, nn_idx, nn_targets = tdk.update_nearest_neighbors(
        model, params, xtr, ytr, np.arange(100), 10
    )
    assert nn_idx.shape == (100, 10)
    assert nn_targets.shape == (100, 10, 1)
    assert nbrs.feature_count == 2


def test_init_follows_flax_dense_defaults():
    """One rng_key fixes one start; Linear weights are LeCun-normal within
    two deviations, biases zero; the GP layer starts at its spec; the
    module itself is not changed."""
    model = _port_model()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    a = tdk._init_params(model, 3, device="cpu")
    b = tdk._init_params(model, 3, device="cpu")
    c = tdk._init_params(model, 4, device="cpu")
    for n in a:
        assert torch.equal(a[n], b[n])
        assert a[n].dtype == torch.float64
    assert not torch.equal(a["embedding.0.weight"], c["embedding.0.weight"])
    w = a["embedding.0.weight"]
    std = (1.0 / 6) ** 0.5 / 0.87962566103423978
    assert w.shape == (16, 6) and float(w.abs().max()) <= 2 * std
    assert torch.equal(a["embedding.2.bias"], torch.zeros(2,
                                                          dtype=torch.float64))
    assert float(a["gp_layer.log_length_scale"]) == 0.0
    np.testing.assert_allclose(float(a["gp_layer.log_noise"]), np.log(1e-3))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n])


def test_train_and_predict():
    """tests/test_deep_kernel.py's bars, at 40 iterations (JAX's test runs
    150): the objective falls, predictions are finite, the test error is
    under 1.5 x the targets' variance, and the length scale moved."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(600, 6))
    y = (np.sin(2 * np.pi * X[:, 0]) + np.cos(2 * np.pi * X[:, 1]))[:, None]
    y += 0.05 * rng.standard_normal((600, 1))
    xtr, ytr, xte, yte = X[:400], y[:400], X[400:], y[400:]
    batch = rng.choice(400, 200, replace=False)
    model = _port_model()
    nbrs = NN_Wrapper(xtr, NN_COUNT, device="cpu")
    _, _, first = tdk.train_deep_kernel_muygps(
        model, xtr, ytr, batch, nbrs, training_iterations=1,
        learning_rate=1e-2, device="cpu",
    )
    trained_nbrs, params, info = tdk.train_deep_kernel_muygps(
        model, xtr, ytr, batch, nbrs, training_iterations=40,
        learning_rate=1e-2, scheduler_decay=0.995, update_frequency=10,
        device="cpu",
    )
    assert np.isfinite(info["final_loss"])
    assert info["final_loss"] < first["final_loss"]
    mean, var = tdk.predict_model(model, params, xte, xtr, ytr,
                                  trained_nbrs, NN_COUNT)
    assert mean.shape == (200, 1) and torch.all(torch.isfinite(mean))
    assert torch.all(var >= -1e-8)
    mse = float(np.mean((mean.numpy()[:, 0] - yte[:, 0]) ** 2))
    assert mse < 1.5 * np.var(yte), mse
    assert float(params["gp_layer.log_length_scale"]) != 0.0


def test_loss_name_validation(problem):
    xtr, ytr, _, _, _ = problem
    nbrs = NN_Wrapper(xtr, 10, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        tdk.train_deep_kernel_muygps(
            _port_model(), xtr, ytr, np.arange(50), nbrs,
            training_iterations=1, loss_function="nope", device="cpu",
        )


def test_layer_refuses_anisotropy():
    from muygpys_torch.gp.hyperparameter import VectorParameter

    with pytest.raises(NotImplementedError, match="Anisotropy"):
        _port_model(deformation=Anisotropy(
            l2, length_scale=VectorParameter(Parameter(1.0), Parameter(1.0))
        ))


def test_multivariate_layer_matches_flax(problem):
    """Per-response heads ``response_0``, ``response_1`` over one
    embedding: JAX's means and variances from carried parameters."""
    import warnings

    from muygpys_tpu.gp import MultivariateMuyGPS as JM
    from muygpys_tpu.nn import MultivariateMuyGPsLayer as JLayer
    from muygpys_torch.gp import MultivariateMuyGPS as TM
    from muygpys_torch.nn import MultivariateMuyGPsLayer

    xtr, ytr, _, _, _ = problem
    y2 = np.concatenate([ytr, -ytr + 0.1], axis=1)
    rng = np.random.default_rng(1)
    bi = np.arange(50)
    bni = rng.integers(0, 400, size=(50, 10))

    def spec(pkg_args, nu):
        k, iso, met, par, noise = pkg_args
        return {"kernel": k(smoothness=par(nu), deformation=iso(
            met, length_scale=par(0.7))), "noise": noise(1e-3)}

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jm = JM(*(spec((JMatern, JIso, jl2, JParam, JNoise), nu)
                  for nu in (1.5, 2.5)))
        tm = TM(*(spec((Matern, Isotropy, l2, Parameter,
                        HomoscedasticNoise), nu) for nu in (1.5, 2.5)))
    jlayer = JLayer(muygps_model=jm)
    jargs = (jnp.asarray(xtr), jnp.asarray(bi), jnp.asarray(bni),
             jnp.asarray(y2)[bni])
    fparams = jax.jit(jlayer.init)(jax.random.PRNGKey(0), *jargs)
    m0, v0 = jax.jit(jlayer.apply)(fparams, *jargs)
    layer = MultivariateMuyGPsLayer(tm)
    params = convert.deep_kernel_params_from_flax(_numpy_tree(fparams),
                                                  layer)
    assert set(params) == {f"response_{i}.{n}" for i in (0, 1)
                           for n in ("log_length_scale", "log_noise")}
    mean, var = functional_call(layer, params, (
        torch.as_tensor(xtr), torch.as_tensor(bi), torch.as_tensor(bni),
        torch.as_tensor(y2)[bni]))
    assert mean.shape == (50, 2) and var.shape == (50, 2)
    _close(mean.detach(), m0, 1e-10)
    _close(var.detach(), v0, 1e-10)


def test_trained_smoothness_matches_flax(problem, start):
    """``train_smoothness=True``: the general Matern through the Bessel
    function, its ``log_smoothness`` gradient with the others."""
    _, ytr, _, _, batch = problem
    flax_params, nn_idx, args = start
    jm = JDeep(embedding=MLP(), muygps_model=_jax_model(1.2).muygps_model,
               train_smoothness=True)
    fparams = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)

    def jax_loss(p):
        mean, var = jm.apply(p, *args)
        return jloss.lool_fn_unscaled(mean, jnp.asarray(ytr)[batch], var)

    jval, jgrad = jax.jit(jax.value_and_grad(jax_loss))(fparams)
    base = _port_model(1.2)
    model = DeepKernelMuyGPs(base.embedding, base.muygps_model,
                             train_smoothness=True)
    params = {n: p.requires_grad_(True) for n, p in
              convert.deep_kernel_params_from_flax(
                  _numpy_tree(fparams), model).items()}
    assert "gp_layer.log_smoothness" in params
    mean, var = functional_call(model, params, _port_args(problem, nn_idx))
    loss = tloss.lool_fn_unscaled(mean, torch.as_tensor(ytr)[batch], var)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-10)
    ref = convert.deep_kernel_params_from_flax(_numpy_tree(jgrad), model)
    _close_grads({n: p.grad.numpy() for n, p in params.items()}, ref, 1e-8)


def test_converter_refuses_mismatches(start):
    flax_params = _numpy_tree(start[0])
    model = _port_model()
    tree = {"params": dict(flax_params["params"])}
    emb = dict(tree["params"]["embedding"])
    emb.pop("Dense_1")
    bad = {"params": {**tree["params"], "embedding": emb}}
    with pytest.raises(ValueError, match="torch.nn.Linear"):
        convert.deep_kernel_params_from_flax(bad, model)
    wide = _port_model()
    wide.embedding[0] = torch.nn.Linear(6, 8)
    with pytest.raises(ValueError, match="kernel"):
        convert.deep_kernel_params_from_flax(flax_params, wide)
    gp = dict(tree["params"]["gp_layer"])
    gp["log_smoothness"] = np.asarray(0.0)
    with pytest.raises(ValueError, match="not the layer's"):
        convert.deep_kernel_params_from_flax(
            {"params": {**tree["params"], "gp_layer": gp}}, model)
