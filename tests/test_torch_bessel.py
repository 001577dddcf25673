"""muygpys_torch.ops.bessel against muygpys_tpu.ops.bessel on the same numpy
inputs, in f64: kve, kv, d/dx (the three-term identity) and d/dv (forward
mode through the Temme/CF2 algorithm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from muygpys_tpu.ops import bessel as jb
from muygpys_torch.ops import bessel as tb

# both regimes (Temme x <= 2, CF2 above), the split and a large argument
X = np.concatenate([np.logspace(-3, np.log10(2.0), 12), [2.0001, 3.0, 7.5, 18.0, 40.0]])
ORDERS = [0.05, 0.31, 0.5, 0.999, 1.0, 1.2, 2.0, 2.5, 4.8, 7.3]


@pytest.mark.parametrize("v", ORDERS)
def test_kve_and_kv_match_jax(v):
    x = torch.as_tensor(X)
    np.testing.assert_allclose(
        tb.kve(v, x).numpy(), np.asarray(jb.kve(v, jnp.asarray(X))),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        tb.kv(v, x).numpy(), np.asarray(jb.kv(v, jnp.asarray(X))), rtol=1e-10
    )
    # and the function itself, not only the other port
    np.testing.assert_allclose(
        tb.kv(v, x).numpy(), scipy.special.kv(v, X), rtol=1e-9
    )


@pytest.mark.parametrize("v", ORDERS)
def test_gradients_match_jax(v):
    x = torch.tensor(X, requires_grad=True)
    vt = torch.tensor(v, dtype=torch.float64, requires_grad=True)
    # a weighted sum, so every element's derivative counts
    w = np.cos(np.arange(X.size))
    (tb.kve(vt, x) * torch.as_tensor(w)).sum().backward()
    gx = jax.grad(lambda xx: jnp.sum(jb.kve(v, xx) * w))(jnp.asarray(X))
    gv = jax.grad(lambda vv: jnp.sum(jb.kve(vv, jnp.asarray(X)) * w))(
        jnp.float64(v)
    )
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=1e-10)
    np.testing.assert_allclose(float(vt.grad), float(gv), rtol=1e-10)


def test_order_derivative_is_elementwise():
    """An order tensor as large as x gets one derivative per element."""
    v = torch.tensor([0.31, 1.2, 4.8], dtype=torch.float64, requires_grad=True)
    x = torch.tensor([0.5, 2.5, 9.0], dtype=torch.float64)
    tb.kve(v, x).sum().backward()
    want = [
        float(jax.grad(jb.kve)(jnp.float64(vi), jnp.float64(xi)))
        for vi, xi in zip(v.tolist(), x.tolist())
    ]
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-10)


def test_order_derivative_vs_high_order_fd():
    """d/dv against 4th-order central differences of scipy's kv, near
    integers included."""
    vs = np.array([0.31, 0.999, 1.0, 1.001, 2.0, 3.2, 5.0])
    xs = np.array([0.05, 1.0, 1.9, 2.1, 10.0, 40.0])
    V, Xg = (a.ravel() for a in np.meshgrid(vs, xs, indexing="ij"))
    v = torch.tensor(V, requires_grad=True)
    tb.kv(v, torch.as_tensor(Xg)).sum().backward()
    h = 1e-4
    kv = scipy.special.kv
    fd = (-kv(V + 2 * h, Xg) + 8 * kv(V + h, Xg) - 8 * kv(V - h, Xg)
          + kv(V - 2 * h, Xg)) / (12 * h)
    scale = np.maximum(np.abs(fd), np.abs(kv(V, Xg)))
    assert np.max(np.abs(v.grad.numpy() - fd) / scale) < 1e-7


def test_f32_kve_finite_at_large_x():
    """The CF2 freeze: no NaN in f32 up to x ~ 300, and the f32 tangent of an
    f32 order stays f32."""
    x = torch.tensor(np.linspace(2.5, 300.0, 64), dtype=torch.float32)
    for v in (0.31, 1.2, 4.8):
        out = tb.kve(v, x)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        np.testing.assert_allclose(
            out.numpy(), scipy.special.kve(v, x.numpy().astype(float)),
            rtol=2e-5,
        )
    vt = torch.tensor(1.2, dtype=torch.float32, requires_grad=True)
    tb.kve(vt, x).sum().backward()
    assert vt.grad.dtype == torch.float32 and torch.isfinite(vt.grad)


def test_negative_order_and_integer_input():
    x = torch.as_tensor(X)
    torch.testing.assert_close(tb.kve(-1.2, x), tb.kve(1.2, x), rtol=0, atol=0)
    assert tb.kve(0.5, torch.tensor([1, 2, 3])).dtype == torch.float32
