"""muygpys_torch.ops.solve against muygpys_tpu.ops.solve (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.ops import solve as js
from muygpys_torch.ops import solve as ts


@pytest.fixture(scope="module")
def problem(rng):
    b, n = 12, 8
    A = rng.standard_normal((b, n, n))
    Kin = A @ np.swapaxes(A, 1, 2) + n * np.eye(n)
    Kcross = rng.standard_normal((b, n))
    y1 = rng.standard_normal((b, n))
    y3 = rng.standard_normal((b, n, 3))
    return Kin, Kcross, y1, y3


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("which", ["y1", "y3"])
def test_mean_variance(problem, which):
    Kin, Kcross, y1, y3 = problem
    y = y1 if which == "y1" else y3
    T, J = torch.as_tensor, jnp.asarray
    _close(
        ts.posterior_mean(T(Kin), T(Kcross), T(y)),
        js.posterior_mean(J(Kin), J(Kcross), J(y)),
    )
    _close(
        ts.diagonal_variance(T(Kin), T(Kcross), 1.0),
        js.diagonal_variance(J(Kin), J(Kcross), 1.0),
    )
    m_t, v_t = ts.serve_mean_and_variance(T(Kin), T(Kcross), 1.0, T(y))
    m_j, v_j = js.serve_mean_and_variance(J(Kin), J(Kcross), 1.0, J(y))
    assert m_t.shape == m_j.shape
    _close(m_t, m_j)
    _close(v_t, v_j)


@pytest.fixture(scope="module")
def block_problem(rng):
    b, i, n, o = 7, 3, 5, 3
    m = i * n
    A = rng.standard_normal((b, m, 2 * m))
    Kin = (A @ A.transpose(0, 2, 1) / (2 * m) + 0.5 * np.eye(m)).reshape(
        b, i, n, i, n
    )
    return (Kin, rng.standard_normal((b, i, n, o)), np.eye(o) * 1.3 + 0.1,
            rng.standard_normal((b, i, n)))


def test_block_layouts_not_ported(block_problem):
    """The multi-output block layouts, refused until the shear slice, now
    solve: Kin (b, i, n, i, n), Kcross (b, i, n, o), nn_targets (b, i, n)
    against the JAX package's generic flattening."""
    Kin, Kcross, Kout, y = block_problem
    T, J = torch.as_tensor, jnp.asarray
    mean = ts.posterior_mean(T(Kin), T(Kcross), T(y))
    assert mean.shape == (7, 3)
    _close(mean, js.posterior_mean(J(Kin), J(Kcross), J(y)))
    var = ts.diagonal_variance(T(Kin), T(Kcross), T(Kout))
    assert var.shape == (7, 3, 3)
    _close(var, js.diagonal_variance(J(Kin), J(Kcross), J(Kout)))
    m_j, v_j = js.posterior_mean_and_variance(J(Kin), J(Kcross), J(Kout), J(y))
    for fn in (ts.serve_mean_and_variance, ts.posterior_mean_and_variance):
        m_t, v_t = fn(T(Kin), T(Kcross), T(Kout), T(y))
        _close(m_t, m_j)
        _close(v_t, v_j)


def test_block_layout_prior_dtype_and_gradient(block_problem):
    """A prior held in another width is cast to the covariance's; autograd
    flows through the flattened Cholesky."""
    Kin, Kcross, Kout, y = block_problem
    T = torch.as_tensor
    var = ts.diagonal_variance(T(Kin), T(Kcross), T(Kout).float())
    assert var.dtype == torch.float64
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    ts.posterior_mean(T(Kin) * s, T(Kcross), T(y)).sum().backward()

    def f(v):
        return float(ts.posterior_mean(T(Kin) * v, T(Kcross), T(y)).sum())

    fd = (f(1 + 1e-6) - f(1 - 1e-6)) / 2e-6
    np.testing.assert_allclose(float(s.grad), fd, rtol=1e-6)
