"""muygpys_torch.checkpoint against muygpys_tpu.checkpoint: files cross
both ways.  A model written by either package loads into the other and
predicts the same (posterior mean and variance, f64, rtol 1e-10, atol
1e-12); both packages write the same JSON (as parsed) for the same model;
the fast state round-trips bit for bit.
"""

import importlib
import json
import math
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import muygpys_tpu.checkpoint as jck
import muygpys_torch.checkpoint as tck

CLOSE = dict(rtol=1e-10, atol=1e-12)
TRAIN, TEST, NN = 120, 16, 8
KINDS = ["matern_iso", "rbf_aniso", "hetero", "null_noise", "shear33",
         "downsample", "multivariate"]
PACKAGES = {"jax": "muygpys_tpu", "torch": "muygpys_torch"}


def _mod(pkg, name):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def _asarray(pkg):
    return jnp.asarray if pkg == "jax" else torch.as_tensor


def build(pkg, kind, het_noise=None):
    """The same model in either package (the class names are the
    same)."""
    gp, dfm = _mod(pkg, "gp"), _mod(pkg, "gp.deformation")
    hp, kern = _mod(pkg, "gp.hyperparameter"), _mod(pkg, "gp.kernels")
    noise = _mod(pkg, "gp.noise")
    P = hp.Parameter

    def matern(nu, ls, bounds="fixed"):
        return kern.Matern(
            smoothness=P(nu),
            deformation=dfm.Isotropy(dfm.l2, length_scale=P(ls, bounds)),
        )

    def trained(scale, val):
        scale._set(val)
        return scale

    if kind == "matern_iso":
        return gp.MuyGPS(
            kernel=matern(1.5, 0.3, (0.05, 1.0)),
            noise=noise.HomoscedasticNoise(1e-3, (1e-6, 0.1)),
            scale=trained(hp.AnalyticScale(iteration_count=2), 1.3),
        )
    if kind == "rbf_aniso":
        return gp.MuyGPS(
            kernel=kern.RBF(deformation=dfm.Anisotropy(
                dfm.F2, length_scale=hp.VectorParameter(
                    P(0.3, (0.05, 1.0)), P(0.45)
                ),
            )),
            noise=noise.HomoscedasticNoise(1e-4),
            scale=trained(hp.FixedScale(), 2.0),
        )
    if kind == "hetero":
        return gp.MuyGPS(
            kernel=matern(2.5, 0.4),
            noise=noise.HeteroscedasticNoise(np.array(het_noise)),
        )
    if kind == "null_noise":
        return gp.MuyGPS(kernel=matern(math.inf, 0.5),
                         noise=noise.NullNoise())
    if kind == "shear33":
        shear = _mod(pkg, "gp.kernels.experimental")
        return gp.MuyGPS(
            kernel=shear.ShearKernel(deformation=dfm.DifferenceIsotropy(
                dfm.F2, length_scale=P(0.3, (0.05, 1.0))
            )),
            noise=noise.ShearNoise33(1e-3),
            scale=trained(hp.FixedScale(), 0.8),
        )
    if kind == "downsample":
        return gp.MuyGPS(
            kernel=matern(0.5, 0.3),
            noise=noise.HomoscedasticNoise(1e-3),
            scale=trained(
                hp.DownSampleScale(down_count=5, iteration_count=4), 0.7
            ),
        )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return gp.MultivariateMuyGPS(
            {"kernel": matern(1.5, 0.3), "noise": noise.NullNoise(),
             "scale": trained(hp.DownSampleScale(down_count=5), 0.9)},
            {"kernel": matern(0.5, 0.2, (0.05, 1.0)),
             "noise": noise.HomoscedasticNoise(1e-2),
             "scale": hp.AnalyticScale()},
        )


@pytest.fixture(scope="module")
def problem(rng):
    train = rng.uniform(size=(TRAIN, 2))
    test = rng.uniform(size=(TEST, 2))
    y = np.stack([np.sin(4 * train[:, 0]), np.cos(3 * train[:, 1])], 1)
    y3 = rng.standard_normal((TRAIN, 3))
    dt = np.linalg.norm(test[:, None] - train[None], axis=-1)
    test_nn = np.argsort(dt, axis=1)[:, :NN]
    het = rng.uniform(1e-3, 1e-2, size=(TEST, NN))
    return train, test, y, y3, test_nn, het


def tensors(kind, problem):
    """(crosswise, pairwise, nn_targets) of the problem as numpy, assembled
    by the JAX package once, so both packages predict from the same
    distances (the Gram-identity assembly rounds differently in each, and
    the zero-nugget model multiplies that by its conditioning)."""
    train, test, y, y3, test_nn, het = problem
    model = build("jax", kind, het)
    targets = y3 if kind == "shear33" else y if kind == "multivariate" \
        else y[:, :1]
    cw, pw, nnt = model.make_predict_tensors(
        np.arange(TEST), test_nn, jnp.asarray(test), jnp.asarray(train),
        jnp.asarray(targets),
    )
    if kind == "shear33":  # (b, nn, 3) -> the block layout (b, 3, nn)
        nnt = nnt.swapaxes(-2, -1)
    return tuple(np.array(t) for t in (cw, pw, nnt))


def predict(pkg, model, kind, problem):
    """Posterior mean and variance of ``model`` on the problem."""
    cw, pw, nnt = (_asarray(pkg)(t) for t in tensors(kind, problem))
    if kind == "multivariate":
        return (model.posterior_mean(pw, cw, nnt),
                model.posterior_variance(pw, cw))
    Kin, Kcross = model.kernel(pw), model.kernel(cw)
    return (model.posterior_mean(Kin, Kcross, nnt),
            model.posterior_variance(Kin, Kcross))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _load(pkg, path):
    if pkg == "jax":
        return jck.load_model(path)
    return tck.load_model(path, device="cpu")


def _save(pkg, path, model):
    (jck if pkg == "jax" else tck).save_model(path, model)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_file_crosses_and_predicts_the_same(tmp_path, problem, kind,
                                            direction):
    src, dst = direction.split("_to_")
    het = problem[-1]
    model = build(src, kind, het)
    path = str(tmp_path / f"{kind}.json")
    _save(src, path, model)
    restored = _load(dst, path)
    want_mean, want_var = predict(src, model, kind, problem)
    got_mean, got_var = predict(dst, restored, kind, problem)
    np.testing.assert_allclose(_np(got_mean), _np(want_mean), **CLOSE)
    np.testing.assert_allclose(_np(got_var), _np(want_var), **CLOSE)
    # structure and state: the same model, built directly in the
    # destination package, compares equal (heteroscedastic noise, an
    # array, is compared by value: __eq__ raises on it in both packages)
    twin = build(dst, kind, het)
    pairs = (zip(restored.models, twin.models) if kind == "multivariate"
             else [(restored, twin)])
    for r, t in pairs:
        assert type(r.kernel) is type(t.kernel)
        assert type(r.noise) is type(t.noise)
        assert type(r.scale) is type(t.scale)
        assert r.scale.trained == t.scale.trained
        assert r.kernel.get_opt_params() == t.kernel.get_opt_params()
        if kind == "hetero":
            np.testing.assert_array_equal(_np(r.noise()), het)
            assert r.kernel.smoothness() == t.kernel.smoothness()
        else:
            assert r == t
        if kind in ("downsample", "multivariate") and hasattr(
            r.scale, "_down_count"
        ):
            assert (r.scale._down_count, r.scale._iteration_count) == (
                t.scale._down_count, t.scale._iteration_count
            )


@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_write_the_same_json(tmp_path, problem, kind):
    het = problem[-1]
    paths = {}
    for pkg in PACKAGES:
        paths[pkg] = str(tmp_path / f"{pkg}.json")
        _save(pkg, paths[pkg], build(pkg, kind, het))
    with open(paths["jax"]) as f_j, open(paths["torch"]) as f_t:
        assert json.load(f_t) == json.load(f_j)
    if kind == "hetero":
        j = np.load(paths["jax"] + ".npz")
        t = np.load(paths["torch"] + ".npz")
        assert sorted(j.files) == sorted(t.files) == ["het_noise_0"]
        np.testing.assert_array_equal(t["het_noise_0"], j["het_noise_0"])
    if kind == "null_noise":
        with open(paths["torch"]) as f:
            assert '"inf"' in f.read()


@pytest.mark.parametrize(
    "coeff_dtype,index_dtype",
    [(np.float64, np.int64), (np.float32, np.int32)],
)
def test_fast_state_round_trips_bit_for_bit(tmp_path, rng, coeff_dtype,
                                            index_dtype):
    coeffs = rng.standard_normal((TRAIN, NN, 2)).astype(coeff_dtype)
    nn = rng.integers(0, TRAIN, (TRAIN, NN)).astype(index_dtype)
    # port -> port, from tensors
    p = str(tmp_path / "t.npz")
    tck.save_fast_state(p, torch.as_tensor(coeffs), torch.as_tensor(nn))
    c, n = tck.load_fast_state(p, device="cpu")
    assert c.dtype == torch.from_numpy(coeffs).dtype
    assert n.dtype == torch.from_numpy(nn).dtype
    np.testing.assert_array_equal(c.numpy(), coeffs)
    np.testing.assert_array_equal(n.numpy(), nn)
    # port -> JAX and JAX -> port
    c_j, n_j = jck.load_fast_state(p)
    np.testing.assert_array_equal(c_j, coeffs)
    np.testing.assert_array_equal(n_j, nn)
    pj = str(tmp_path / "j.npz")
    jck.save_fast_state(pj, jnp.asarray(coeffs), jnp.asarray(nn))
    c, n = tck.load_fast_state(pj, device="cpu")
    np.testing.assert_array_equal(c.numpy(), np.asarray(jnp.asarray(coeffs)))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jnp.asarray(nn)))


def test_loading_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``device="cpu"`` a load goes to the card, and without a card
    it raises (no silent CPU fallback)."""
    path = str(tmp_path / "m.json")
    tck.save_model(path, build("torch", "matern_iso"))
    tck.save_fast_state(str(tmp_path / "f.npz"), np.zeros((2, 3)),
                        np.zeros((2, 3), int))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.load_model(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.load_fast_state(str(tmp_path / "f.npz"))


def test_unknown_types_raise(tmp_path):
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, MetricFn
    from muygpys_torch.gp.hyperparameter import Parameter
    from muygpys_torch.gp.kernels import Matern

    odd = MetricFn(None, None, None, None, name="odd")
    model = MuyGPS(kernel=Matern(
        smoothness=Parameter(1.5),
        deformation=Isotropy(odd, length_scale=Parameter(0.3)),
    ))
    with pytest.raises(ValueError, match="unknown metric"):
        tck.save_model(str(tmp_path / "m.json"), model)
