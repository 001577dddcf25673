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


def test_block_layouts_not_ported(problem):
    Kin = torch.zeros((2, 3, 4, 3, 4))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ts.serve_mean_and_variance(Kin, torch.zeros((2, 3, 4, 3)), 1.0,
                                   torch.zeros((2, 3, 4)))
