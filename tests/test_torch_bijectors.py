"""muygpys_torch.optimize.bijectors against muygpys_tpu.optimize.bijectors
(f64): the tensor pair with its autograd derivative and its tensor
d theta / d z, the numpy twins and the name-keyed bijector."""

import jax
import jax.numpy as jnp
import numpy as np

from muygpys_tpu.optimize import bijectors as jbj
from muygpys_torch.optimize import bijectors as tbj

import torch

LO, HI = 1e-6, 0.1
Z = np.linspace(-25.0, 25.0, 41)
THETA = np.concatenate([[LO, HI], np.geomspace(1e-6, 0.1, 20)])


def test_forward_inverse_match_jax():
    z = torch.tensor(Z, requires_grad=True)
    th = tbj.forward(z, LO, HI)
    th.sum().backward()
    np.testing.assert_allclose(
        th.detach().numpy(), np.asarray(jbj.forward(jnp.asarray(Z), LO, HI)),
        rtol=1e-14,
    )
    dref = jax.vmap(jax.grad(lambda v: jbj.forward(v, LO, HI)))(
        jnp.asarray(Z)
    )
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(dref), rtol=1e-12)
    np.testing.assert_allclose(
        z.grad.numpy(), tbj.dforward_dz_np(Z, LO, HI), rtol=1e-12
    )
    # the tensor form the device chassis applies on the card
    np.testing.assert_allclose(
        tbj.dforward_dz(torch.as_tensor(Z), LO, HI).numpy(), np.asarray(dref),
        rtol=1e-12,
    )
    inner = THETA[2:-2]
    np.testing.assert_allclose(
        tbj.inverse(torch.as_tensor(inner), LO, HI).numpy(),
        np.asarray(jbj.inverse(jnp.asarray(inner), LO, HI)), rtol=1e-12,
    )


def test_numpy_twins_match_jax():
    np.testing.assert_array_equal(
        tbj.inverse_np(THETA, LO, HI), jbj.inverse_np(THETA, LO, HI)
    )
    np.testing.assert_array_equal(
        tbj.forward_np(Z, LO, HI), jbj.forward_np(Z, LO, HI)
    )
    np.testing.assert_array_equal(
        tbj.dforward_dz_np(Z, LO, HI), jbj.dforward_dz_np(Z, LO, HI)
    )
    # the clipped inverse keeps the bounds themselves finite
    assert np.all(np.isfinite(tbj.inverse_np(THETA, LO, HI)))
    np.testing.assert_allclose(
        tbj.forward_np(tbj.inverse_np(THETA[3:], LO, HI), LO, HI), THETA[3:],
        rtol=1e-7,
    )


def test_param_bijector_matches_jax():
    names, bounds = ["length_scale", "noise"], [(0.01, 5.0), (LO, HI)]
    t_theta, t_z = tbj.make_param_bijector(names, bounds)
    j_theta, j_z = jbj.make_param_bijector(names, bounds)
    start = {"length_scale": 0.4, "noise": 1e-3}
    assert t_z(start) == j_z(start)
    z = t_z(start)
    out = t_theta({k: torch.tensor(v, dtype=torch.float64) for k, v in z.items()})
    ref = j_theta({k: jnp.asarray(v) for k, v in z.items()})
    for k in names:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-14)
        np.testing.assert_allclose(float(out[k]), start[k], rtol=1e-9)
