"""muygpys_torch.gp.muygps (with gp.noise and gp.tensors) against the JAX
MuyGPS on the same trained model and data (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import carried, jax_model

from muygpys_torch.gp import tensors as tgt
from muygpys_torch.gp.noise import HeteroscedasticNoise, HomoscedasticNoise


@pytest.fixture(scope="module")
def data(rng):
    x = rng.uniform(size=(80, 2))
    y = rng.standard_normal((80, 1))
    xq = rng.uniform(size=(15, 2))
    nn = np.stack([rng.choice(80, 8, replace=False) for _ in range(15)])
    return x, y, xq, nn


CASES = [
    dict(nu=0.5), dict(nu=2.5, ls=(0.3, 0.8)),
    dict(kernel="rbf", metric="F2", ls=0.7),
    dict(nu=1.5, hetero=np.full((15, 8), 2e-3)),
]


@pytest.mark.parametrize("spec", CASES, ids=[str(c) for c in CASES])
def test_posteriors_match_jax(data, spec):
    x, y, xq, nn = data
    jm = jax_model(**spec)
    tm = carried(jm)
    T, J = torch.as_tensor, jnp.asarray
    bi = np.arange(15)
    cw_t, pw_t, nt_t = tm.make_predict_tensors(T(bi), T(nn), T(xq), T(x), T(y))
    cw_j, pw_j, nt_j = jm.make_predict_tensors(J(bi), J(nn), J(xq), J(x), J(y))
    np.testing.assert_allclose(nt_t.numpy(), np.asarray(nt_j))
    Kin_t, Kc_t = tm.kernel(pw_t), tm.kernel(cw_t)
    Kin_j, Kc_j = jm.kernel(pw_j), jm.kernel(cw_j)
    # l2 distances near 0 differ by ~sqrt(eps) between the two packages'
    # Gram-identity products (see test_torch_deformation.py); the solves
    # then differ as tests/test_serve.py's differently ordered engines do
    np.testing.assert_allclose(Kin_t.numpy(), np.asarray(Kin_j), rtol=1e-12, atol=1e-7)
    close = dict(rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        tm.posterior_mean(Kin_t, Kc_t, nt_t).numpy(),
        np.asarray(jm.posterior_mean(Kin_j, Kc_j, nt_j)), **close,
    )
    np.testing.assert_allclose(
        tm.posterior_variance(Kin_t, Kc_t).numpy(),
        np.asarray(jm.posterior_variance(Kin_j, Kc_j)), **close,
    )
    m_t, v_t = tm.posterior_mean_and_variance(Kin_t, Kc_t, nt_t)
    m_j, v_j = jm.posterior_mean_and_variance(Kin_j, Kc_j, nt_j)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **close)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **close)


def test_noise_models(data):
    _, _, _, nn = data
    K = torch.zeros((2, 3, 3), dtype=torch.float64)
    np.testing.assert_allclose(
        HomoscedasticNoise(0.1).perturb(K)[0].numpy(), 0.1 * np.eye(3)
    )
    eps = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    np.testing.assert_allclose(
        HeteroscedasticNoise(eps).perturb(K)[1].numpy(), np.diag(eps[1])
    )
    with pytest.raises(ValueError, match="non-negative"):
        HeteroscedasticNoise(-eps)
    with pytest.raises(ValueError, match="non-array"):
        HeteroscedasticNoise(0.5)
    with pytest.raises(ValueError, match="strictly positive"):
        HomoscedasticNoise(0.1, (-1.0, 1.0))
    meas = torch.arange(80, dtype=torch.float64)
    assert torch.equal(
        tgt.make_heteroscedastic_tensor(meas, torch.as_tensor(nn)),
        meas[torch.as_tensor(nn)],
    )


def test_train_tensors_and_opt_surface_match_jax(data):
    """make_train_tensors, the free-parameter lists and the kwarg-threaded
    objective pieces (a proposed length scale and noise reach the kernel
    and the solves) against the JAX model."""
    from test_torch_convert import carried_for_training, jax_model_to_train

    x, y, _, _ = data
    bi = np.arange(0, 80, 5)
    nn = np.stack([np.delete(np.arange(80), i)[i % 7::9][:8] for i in bi])
    for spec in (dict(), dict(ls=(0.3, 0.8), noise_bounds="fixed")):
        jm = jax_model_to_train(**spec)
        tm = carried_for_training(jm)
        assert tm.fixed() is False and tm.fixed() == jm.fixed()
        names, vals, bounds = tm.get_opt_params()
        jn, jv, jb = jm.get_opt_params()
        assert names == jn
        np.testing.assert_array_equal(vals, np.asarray(jv))
        np.testing.assert_array_equal(bounds, np.asarray(jb))
        T, J = torch.as_tensor, jnp.asarray
        tt = tm.make_train_tensors(bi, nn, T(x), T(y))
        jt = jm.make_train_tensors(J(bi), J(nn), J(x), J(y))
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(
                a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-7
            )
        proposal = {nm: 0.9 * v for nm, v in zip(names, vals)}
        cw_t, pw_t, _, nt_t = tt
        cw_j, pw_j, _, nt_j = jt
        Kin_t = tm.kernel.get_opt_fn()(pw_t, **proposal)
        Kc_t = tm.kernel.get_opt_fn()(cw_t, **proposal)
        Kin_j = jm.kernel.get_opt_fn()(pw_j, **proposal)
        Kc_j = jm.kernel.get_opt_fn()(cw_j, **proposal)
        np.testing.assert_allclose(
            Kin_t.numpy(), np.asarray(Kin_j), rtol=1e-12, atol=1e-7
        )
        close = dict(rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(
            tm.get_opt_mean_fn()(Kin_t, Kc_t, nt_t, **proposal).numpy(),
            np.asarray(jm.get_opt_mean_fn()(Kin_j, Kc_j, nt_j, **proposal)),
            **close,
        )
        np.testing.assert_allclose(
            tm.get_opt_var_fn()(Kin_t, Kc_t, **proposal).numpy(),
            np.asarray(jm.get_opt_var_fn()(Kin_j, Kc_j, **proposal)),
            **close,
        )


@pytest.mark.parametrize("family", ["33", "23"])
def test_shear_posteriors_match_jax(data, family):
    """A 5-D Kin routes posterior_mean_and_variance through the batch-last
    floored block Cholesky with kernel.Kout() and the scale; the separate
    mean and variance functors go through the block layouts of
    ops/solve.py.  tests/test_serve.py's shear tolerance."""
    from _torch_models import carried_shear, jax_shear_model

    x, _, xq, nn = data
    y = np.random.default_rng(4).standard_normal((80, 3))
    obs = y if family == "33" else y[:, 1:]
    ls = 0.2
    jm = jax_shear_model(family, ls=ls, noise=1e-3 * 2 / ls**2, scale=1.7)
    tm = carried_shear(jm)
    T, J = torch.as_tensor, jnp.asarray
    bi = np.arange(15)
    cw_t, pw_t, nt_t = tm.make_predict_tensors(T(bi), T(nn), T(xq), T(x), T(obs))
    cw_j, pw_j, nt_j = jm.make_predict_tensors(J(bi), J(nn), J(xq), J(x), J(obs))
    assert pw_t.shape == (15, 8, 8, 2) and cw_t.shape == (15, 8, 2)
    np.testing.assert_allclose(pw_t.numpy(), np.asarray(pw_j), rtol=0, atol=0)
    nt_t, nt_j = nt_t.transpose(-2, -1), jnp.swapaxes(nt_j, -2, -1)
    Kin_t, Kc_t = tm.kernel(pw_t), tm.kernel(cw_t)
    Kin_j, Kc_j = jm.kernel(pw_j), jm.kernel(cw_j)
    close = dict(rtol=1e-8, atol=1e-10)
    m_t, c_t = tm.posterior_mean_and_variance(Kin_t, Kc_t, nt_t)
    m_j, c_j = jm.posterior_mean_and_variance(Kin_j, Kc_j, nt_j)
    assert m_t.shape == (15, 3) and c_t.shape == (15, 3, 3)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **close)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **close)
    np.testing.assert_allclose(
        tm.posterior_mean(Kin_t, Kc_t, nt_t).numpy(),
        np.asarray(jm.posterior_mean(Kin_j, Kc_j, nt_j)), **close,
    )
    np.testing.assert_allclose(
        tm.posterior_variance(Kin_t, Kc_t).numpy(),
        np.asarray(jm.posterior_variance(Kin_j, Kc_j)), **close,
    )
    # the functor chain and the fused path agree with each other
    np.testing.assert_allclose(
        tm.posterior_variance(Kin_t, Kc_t).numpy(), c_t.numpy(), **close
    )
