"""muygpys_torch.ops.tensors against muygpys_tpu.ops.tensors (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.ops import tensors as jt
from muygpys_torch.ops import tensors as tt


@pytest.fixture(scope="module")
def data(rng):
    x = rng.uniform(size=(60, 3))
    nn = rng.integers(0, 60, size=(20, 7))
    bi = rng.integers(0, 60, size=20)
    return x, nn, bi


def _close(a, b, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_differences(data):
    x, nn, bi = data
    J, T = jnp.asarray, torch.as_tensor
    _close(tt.pairwise_diffs(T(x), T(nn)), jt.pairwise_diffs(J(x), J(nn)))
    _close(
        tt.crosswise_diffs(T(x), T(x), T(bi), T(nn)),
        jt.crosswise_diffs(J(x), J(x), J(bi), J(nn)),
    )
    diffs = np.array(jt.pairwise_diffs(J(x), J(nn)))
    _close(tt.F2(T(diffs)), jt.F2(J(diffs)))
    _close(tt.l2(T(diffs)), jt.l2(J(diffs)))


def test_gram_identity_distances(data):
    x, nn, bi = data
    J, T = jnp.asarray, torch.as_tensor
    _close(tt.pairwise_F2(T(x), T(nn)), jt.pairwise_F2(J(x), J(nn)), atol=1e-14)
    _close(
        tt.crosswise_F2(T(x), T(x), T(bi), T(nn)),
        jt.crosswise_F2(J(x), J(x), J(bi), J(nn)),
        atol=1e-14,
    )
    # the diagonals are exact zeros (clamped cancellation)
    pw = tt.pairwise_F2(T(x), T(nn))
    assert torch.all(torch.diagonal(pw, dim1=1, dim2=2) >= 0)


def test_one_dimensional_features(data):
    x, nn, _ = data
    _close(
        tt.pairwise_diffs(torch.as_tensor(x[:, 0]), torch.as_tensor(nn)),
        jt.pairwise_diffs(jnp.asarray(x[:, 0]), jnp.asarray(nn)),
    )


def test_safe_sqrt_zero_treatment():
    x = torch.tensor([0.0, 4.0, 1e-300], dtype=torch.float64, requires_grad=True)
    y = tt.safe_sqrt(x)
    _close(y.detach(), jt.safe_sqrt(jnp.asarray([0.0, 4.0, 1e-300])))
    y.sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad[0] == 0.0


def test_heteroscedastic_tensor(data):
    _, nn, _ = data
    eps = np.linspace(0.1, 1.0, 60)
    _close(
        tt.make_heteroscedastic_tensor(torch.as_tensor(eps), torch.as_tensor(nn)),
        jt.make_heteroscedastic_tensor(jnp.asarray(eps), jnp.asarray(nn)),
    )
