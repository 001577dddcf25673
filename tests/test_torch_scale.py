"""muygpys_torch.ops.scale, the scale functors and MuyGPS.optimize_scale
against the JAX package on the same tensors (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_convert import carried_for_training, jax_model_to_train

from muygpys_tpu.ops import scale as js
from muygpys_torch.ops import scale as ts


@pytest.fixture(scope="module")
def data(rng):
    x = rng.uniform(size=(120, 2))
    y = rng.standard_normal((120, 2))
    bi = np.arange(0, 120, 3)
    nn = np.stack([rng.choice(np.delete(np.arange(120), i), 9, replace=False)
                   for i in bi])
    return x, y, bi, nn


@pytest.mark.parametrize("r", [1, 2])
def test_analytic_scale_optim_matches_jax(data, rng, r):
    A = rng.standard_normal((40, 9, 9))
    K = A @ A.transpose(0, 2, 1) + 9 * np.eye(9)
    y = rng.standard_normal((40, 9, r) if r > 1 else (40, 9))
    np.testing.assert_allclose(
        float(ts.analytic_scale_optim(torch.as_tensor(K), torch.as_tensor(y))),
        float(js.analytic_scale_optim(jnp.asarray(K), jnp.asarray(y))),
        rtol=1e-12,
    )


def test_analytic_scale_optim_block_layout_matches_jax(rng):
    """The 5-D flatten of the shear layout: (b, i, n, i, n) blocks and
    (b, i, n) targets, normalized by b * n."""
    b, i, n = 6, 3, 4
    m = i * n
    A = rng.standard_normal((b, m, m))
    K = (A @ A.transpose(0, 2, 1) + m * np.eye(m)).reshape(b, i, n, i, n)
    y = rng.standard_normal((b, i, n))
    got = float(ts.analytic_scale_optim(torch.as_tensor(K), torch.as_tensor(y)))
    np.testing.assert_allclose(
        got, float(js.analytic_scale_optim(jnp.asarray(K), jnp.asarray(y))),
        rtol=1e-12,
    )
    flat = K.reshape(b, m, m)
    want = sum(
        y[k].reshape(m) @ np.linalg.solve(flat[k], y[k].reshape(m))
        for k in range(b)
    ) / (b * n)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    with pytest.raises(ValueError, match="unsupported Kin shape"):
        ts.analytic_scale_optim(torch.zeros((2, 3, 4, 5)), torch.zeros((2, 3)))


@pytest.mark.parametrize("iterations", [1, 3])
def test_optimize_scale_matches_jax(data, iterations):
    from muygpys_tpu.gp.hyperparameter import AnalyticScale as JaxAnalytic
    from muygpys_torch.gp.hyperparameter import AnalyticScale

    x, y, bi, nn = data
    jm = jax_model_to_train(noise=3e-3)
    jm.scale = JaxAnalytic(iteration_count=iterations)
    tm = carried_for_training(jm)
    tm.scale = AnalyticScale(iteration_count=iterations)
    _, pw_j, _, nt_j = jm.make_train_tensors(bi, nn, jnp.asarray(x),
                                              jnp.asarray(y))
    _, pw_t, _, nt_t = tm.make_train_tensors(bi, nn, torch.as_tensor(x),
                                              torch.as_tensor(y))
    jm.optimize_scale(pw_j, nt_j)
    assert tm.optimize_scale(pw_t, nt_t) is tm
    assert isinstance(tm.scale(), float) and tm.scale.trained
    # the two packages' Gram-identity distances differ by ~sqrt(eps) where
    # they are 0 (test_torch_deformation.py), which moves sigma^2 ~1e-8
    np.testing.assert_allclose(
        tm.scale(), float(np.asarray(jm.scale())), rtol=1e-6
    )
    # the trained scale reaches the posterior variance
    Kin, Kc = tm.kernel(pw_t), tm.kernel(pw_t[:, 0, :])
    np.testing.assert_allclose(
        tm.posterior_variance(Kin, Kc).numpy(),
        tm.scale() * tm.get_opt_var_fn()(Kin, Kc).numpy(), rtol=1e-14,
    )


def test_fixed_scale_is_not_optimized(data):
    from muygpys_torch.gp.hyperparameter import FixedScale

    x, y, bi, nn = data
    tm = carried_for_training(jax_model_to_train())
    tm.scale = FixedScale(val=2.5)
    _, pw, _, nt = tm.make_train_tensors(bi, nn, torch.as_tensor(x),
                                         torch.as_tensor(y))
    assert tm.optimize_scale(pw, nt).scale() == 2.5
