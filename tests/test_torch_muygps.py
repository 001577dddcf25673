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
