"""muygpys_torch.ops.loss and the LossFn functors of
muygpys_torch.optimize.loss against the JAX package (f64), values and
autograd gradients against jax.grad of the same loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.ops import loss as jl
from muygpys_tpu.optimize import loss as jol
from muygpys_torch.ops import loss as tl
from muygpys_torch.optimize import loss as tol


@pytest.fixture(scope="module")
def data(rng):
    pred = rng.standard_normal((40, 2))
    targ = rng.standard_normal((40, 2))
    var = rng.uniform(0.1, 2.0, size=40)
    var[3] = -1e-18  # a variance f32 rounding pushed below 0: floored
    return pred, targ, var


# (name, uses variances, uses scale, extra kwargs)
CASES = [
    ("mse_fn", False, False, {}),
    ("pseudo_huber_fn", False, False, {"boundary_scale": 0.7}),
    ("cross_entropy_fn", False, False, {}),
    ("lool_fn", True, True, {}),
    ("lool_fn_unscaled", True, False, {}),
    ("looph_fn", True, True, {"boundary_scale": 2.0}),
    ("looph_fn_unscaled", True, False, {}),
]


@pytest.mark.parametrize("name,with_var,with_scale,kw", CASES)
def test_losses_match_jax(data, name, with_var, with_scale, kw):
    pred, targ, var = data
    if name == "cross_entropy_fn":
        targ = np.eye(2)[(targ[:, 0] > 0).astype(int)]
    extra = ([var] if with_var else []) + ([0.7] if with_scale else [])

    def jfn(p):
        return getattr(jl, name)(p, jnp.asarray(targ),
                                 *(jnp.asarray(e) for e in extra), **kw)

    v_ref, g_ref = jax.value_and_grad(jfn)(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    v = getattr(tl, name)(p, torch.as_tensor(targ),
                          *(torch.as_tensor(e) if np.ndim(e) else e
                            for e in extra), **kw)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-12)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_ref), rtol=1e-10)


def test_loss_functors_match_jax(data):
    """The predict-and-loss closures of each strategy (mean-only, and
    mean + variance + scale) on the same stand-in mean/var/scale fns."""
    pred, targ, var = data
    for name in ("mse_fn", "lool_fn", "looph_fn", "lool_fn_unscaled",
                 "pseudo_huber_fn"):
        jf, tf = getattr(jol, name), getattr(tol, name)
        assert tf.name == jf.name
        closures = []
        for mod, fn in ((jnp, jf), (torch, tf)):
            arr = mod.asarray if mod is jnp else torch.as_tensor
            closures.append(fn.make_predict_and_loss_fn(
                lambda K, Kc, nt, **k: K,      # mean
                lambda K, Kc, **k: Kc,         # variance
                lambda K, nt, **k: 0.7,        # scale
                None, arr(targ),
            ))
        ref = closures[0](jnp.asarray(pred), jnp.asarray(var))
        out = closures[1](torch.as_tensor(pred), torch.as_tensor(var))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-12)
        extra = {"lool_fn": [0.7], "looph_fn": [0.7]}.get(name, [])
        if "loo" in name:
            extra = [var] + extra
        np.testing.assert_allclose(
            float(tf(torch.as_tensor(pred), torch.as_tensor(targ),
                     *(torch.as_tensor(e) if np.ndim(e) else e
                       for e in extra))),
            float(jf(jnp.asarray(pred), jnp.asarray(targ),
                     *(jnp.asarray(e) for e in extra))),
            rtol=1e-12,
        )


def test_full_covariance_lool_not_ported(data, rng):
    """The full-covariance branch of lool, refused until the shear slice, is
    ported: residual^T C^{-1} residual + log det C over (b, r, r) blocks,
    value and gradients against the JAX package."""
    pred, targ, _ = data
    A = rng.standard_normal((40, 2, 2))
    cov = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(2)

    def jfn(p, c):
        return jl.lool_fn_unscaled(p, jnp.asarray(targ), c)

    v_ref, (gp_ref, gc_ref) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(cov)
    )
    p = torch.tensor(pred, requires_grad=True)
    c = torch.tensor(cov, requires_grad=True)
    v = tl.lool_fn_unscaled(p, torch.as_tensor(targ), c)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-12)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_ref), rtol=1e-10)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc_ref),
                               rtol=1e-9, atol=1e-12)
    # the scaled form multiplies the blocks
    np.testing.assert_allclose(
        float(tl.lool_fn(torch.as_tensor(pred), torch.as_tensor(targ),
                         torch.as_tensor(cov), 0.7)),
        float(jl.lool_fn(jnp.asarray(pred), jnp.asarray(targ),
                         jnp.asarray(cov), 0.7)),
        rtol=1e-12,
    )
    # by hand on one point
    res = pred[0] - targ[0]
    want = res @ np.linalg.solve(cov[0], res) + np.log(np.linalg.det(cov[0]))
    np.testing.assert_allclose(
        float(tl.lool_fn_unscaled(torch.as_tensor(pred[:1]),
                                  torch.as_tensor(targ[:1]),
                                  torch.as_tensor(cov[:1]))),
        want, rtol=1e-12,
    )
