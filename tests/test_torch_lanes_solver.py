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


@pytest.fixture(scope="module")
def multiout(rng):
    B, I, n, O = 10, 3, 6, 3
    m = I * n
    A = rng.standard_normal((B, m, 2 * m))
    Kin = (A @ A.transpose(0, 2, 1) / (2 * m) + 0.5 * np.eye(m)).reshape(
        B, I, n, I, n
    )
    return (Kin, rng.standard_normal((B, I, n, O)), np.eye(O) * 1.3 + 0.1,
            rng.standard_normal((B, I, n)))


def test_multiout_frontend_bl(multiout):
    Kin, Kc, _, y = multiout
    got = tl.multiout_frontend_bl(*(torch.as_tensor(t) for t in (Kin, Kc, y)))
    want = jl.multiout_frontend_bl(*(jnp.asarray(t) for t in (Kin, Kc, y)))
    for g, w, shape in zip(got, want, ((18, 18, 10), (18, 3, 10), (18, 10))):
        assert g.shape == shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_multiout_serve_matches_jax(multiout):
    Kin, Kc, Kout, y = multiout
    T, J = torch.as_tensor, jnp.asarray
    m_t, c_t = tl.multiout_serve_mean_and_variance(T(Kin), T(Kc), T(Kout), T(y))
    m_j, c_j = jl.multiout_serve_mean_and_variance(J(Kin), J(Kc), J(Kout), J(y))
    assert m_t.shape == (10, 3) and c_t.shape == (10, 3, 3)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-10, atol=1e-12)
    # the batch-last function itself, with a prior handed over in f32
    bl_t = tl.multiout_frontend_bl(T(Kin), T(Kc), T(y))
    bl_j = jl.multiout_frontend_bl(J(Kin), J(Kc), J(y))
    m_t, c_t = tl.serve_mean_and_variance_multiout_bl(
        bl_t[0], bl_t[1], T(Kout).float(), bl_t[2]
    )
    m_j, c_j = jl.serve_mean_and_variance_multiout_bl(
        bl_j[0], bl_j[1], J(Kout), bl_j[2]
    )
    assert m_t.shape == (3, 10) and c_t.shape == (3, 3, 10)
    assert c_t.dtype == torch.float64
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-7, atol=1e-7)


def test_multiout_gradient_flows_through_the_floored_factor(multiout):
    """The shear lanes objective differentiates through this solver."""
    Kin, Kc, Kout, y = multiout
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    mean, cov = tl.multiout_serve_mean_and_variance(
        torch.as_tensor(Kin) * s, torch.as_tensor(Kc), torch.as_tensor(Kout),
        torch.as_tensor(y),
    )
    (mean.sum() + cov.sum()).backward()

    def f(v):
        m, c = tl.multiout_serve_mean_and_variance(
            torch.as_tensor(Kin) * v, torch.as_tensor(Kc),
            torch.as_tensor(Kout), torch.as_tensor(y),
        )
        return float(m.sum() + c.sum())

    fd = (f(1 + 1e-6) - f(1 - 1e-6)) / 2e-6
    np.testing.assert_allclose(float(s.grad), fd, rtol=1e-6)
