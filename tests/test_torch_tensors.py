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


@pytest.mark.parametrize("feat", [1, 2, 5])
def test_f32_distances_keep_their_relative_precision(feat):
    """Dense unit-scale neighbourhoods (squared distances ~1e-4): in f32
    the centred pairwise assembly and the direct crosswise differences
    stay within 1e-5 relative, or ~eps times a neighbourhood's squared
    span (2e-9) absolute, of f64 on the same rounded coordinates (the
    plain Gram identity loses ~eps |a|^2 = 1e-7 absolute), and a
    neighbourhood's Matern 3/2 matrix at length scale 0.03 plus 1e-3 on
    the diagonal factors in f32."""
    rng = np.random.default_rng(4)
    centres = rng.uniform(0.5, 1.0, size=(64, 1, feat))
    x = (centres + 0.01 * rng.standard_normal((64, 31, feat))).reshape(-1, feat)
    nn = np.arange(64 * 31).reshape(64, 31)
    bi = nn[:, 0]
    want_pw = ((x[nn][:, :, None] - x[nn][:, None]) ** 2).sum(-1)
    want_cw = ((x[nn] - x[bi][:, None]) ** 2).sum(-1)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    pw = tt.pairwise_F2(x32, torch.as_tensor(nn)).double().numpy()
    cw = tt.crosswise_F2(x32, x32, torch.as_tensor(bi),
                         torch.as_tensor(nn)).double().numpy()
    # the f32 rounding of the coordinates themselves moves a squared
    # distance by ~2 |a - b| eps |a|: the floor both are held to
    rounding = ((x32.double().numpy()[nn][:, :, None]
                 - x32.double().numpy()[nn][:, None]) ** 2).sum(-1)
    _close(pw, rounding, rtol=1e-5, atol=2e-9)
    _close(cw, rounding[:, 0], rtol=1e-5, atol=2e-9)
    _close(pw, want_pw, rtol=1e-3, atol=5e-9)
    _close(cw, want_cw, rtol=1e-3, atol=5e-9)
    r = torch.sqrt(torch.as_tensor(pw, dtype=torch.float32)) / 0.03
    kin = (1 + 3**0.5 * r) * torch.exp(-(3**0.5) * r)
    kin = kin + 1e-3 * torch.eye(31)
    assert torch.linalg.cholesky_ex(kin)[1].eq(0).all()


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
