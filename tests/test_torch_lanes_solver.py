"""muygpys_torch.ops.lanes_solver against muygpys_tpu.ops.lanes_solver
(f64), including the relative Gill-Murray pivot floor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.ops import lanes_solver as jl
from muygpys_torch.ops import lanes_solver as tl


@pytest.fixture(scope="module")
def spd(rng):
    n, B, r = 9, 16, 2
    A = rng.standard_normal((B, n, n))
    K = A @ np.swapaxes(A, 1, 2) + n * np.eye(n)
    K_bl = np.transpose(K, (1, 2, 0))
    Kc = rng.standard_normal((n, B))
    y = rng.standard_normal((n, r, B))
    return K_bl, Kc, y


def test_cholesky_and_solves(spd):
    K, _, y = spd
    L_t = tl.cholesky_bl(torch.as_tensor(K))
    L_j = jl.cholesky_bl(jnp.asarray(K))
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-12, atol=1e-13)
    x_t = tl.solve_bl(torch.as_tensor(K), torch.as_tensor(y))
    x_j = jl.solve_bl(jnp.asarray(K), jnp.asarray(y))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-10, atol=1e-12)


def test_serve_mean_and_variance(spd):
    K, Kc, y = spd
    m_t, v_t = tl.serve_mean_and_variance_bl(
        torch.as_tensor(K), torch.as_tensor(Kc), 1.0, torch.as_tensor(y)
    )
    m_j, v_j = jl.serve_mean_and_variance_bl(
        jnp.asarray(K), jnp.asarray(Kc), 1.0, jnp.asarray(y)
    )
    assert m_t.shape == (2, 16) and v_t.shape == (16,)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-10, atol=1e-12)


def test_pivot_floor_on_singular_lanes():
    """A rank-deficient lane is floored (finite), exactly as in JAX."""
    n, B = 5, 4
    v = np.random.default_rng(2).standard_normal((n, 1))
    K = np.repeat((v @ v.T)[:, :, None], B, axis=2)  # rank 1: singular
    K[:, :, 0] = np.eye(n)  # one healthy lane
    L_t = tl.cholesky_bl(torch.as_tensor(K))
    L_j = jl.cholesky_bl(jnp.asarray(K))
    assert torch.isfinite(L_t).all()
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-10, atol=1e-12)
