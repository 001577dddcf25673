"""K2: the plain version of the fused LOO statistics against the TPU kernel
(muygpys_tpu.pallas.fused_train.fused_train_stats_bl, interpret mode) on
the same numpy inputs, row by row, in f64; and the wrapper's rules."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.pallas.fused_train import fused_train_stats_bl as jax_k2
from muygpys_tpu.pallas.matern_nu import matern_nu_coeffs as jax_coeffs
from muygpys_torch.gpu import _build
from muygpys_torch.gpu.fused_train import (
    fused_train_stats_bl,
    fused_train_stats_bl_plain,
)

B, N = 64, 10  # the JAX kernel test's size (tests/test_pallas_train.py)


def k2_inputs(seed, d_feat, r, metric_power, hetero, noise_free):
    """Batch-last K2 inputs from numpy: distances (isotropic; squared under
    F2) or per-feature differences (anisotropic) of 2-D neighborhoods."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(B, N, 2))
    q = rng.uniform(size=(B, 2))
    diff_p = pts[:, :, None, :] - pts[:, None, :, :]  # (B, n, n, 2)
    diff_c = q[:, None, :] - pts  # (B, n, 2)
    if d_feat:
        pw, cw = diff_p.transpose(1, 2, 3, 0), diff_c.transpose(1, 2, 0)
        ls = [0.43, 0.81]
    else:
        pw, cw = (diff_p**2).sum(-1), (diff_c**2).sum(-1)
        if metric_power == 1:
            pw, cw = np.sqrt(pw), np.sqrt(cw)
        pw, cw = pw.transpose(1, 2, 0), cw.T
        ls = [0.33]
    y = rng.standard_normal((N, r, B))
    params = np.array(ls + [2e-3 if noise_free else 1e-3, 1e-3])
    noise_nn = rng.uniform(1e-3, 1.1e-2, size=(N, B)) if hetero else None
    return pw, cw, y, params, noise_nn


# (smoothness, metric_power, noise_free, r, d_feat, heteroscedastic): every
# closed form, RBF on F2, noise free on and off, r = 1 and 2, anisotropic
# d = 2 and the per-neighbor nugget
CASES = [
    (0.5, 1, False, 1, 0, False),
    (1.5, 1, True, 1, 0, False),
    (2.5, 1, True, 2, 0, False),
    (math.inf, 1, False, 2, 0, False),
    ("rbf", 2, True, 1, 0, False),
    (1.5, 1, True, 1, 2, False),
    ("rbf", 2, False, 2, 2, False),
    (1.5, 1, False, 1, 0, True),
]


@pytest.mark.parametrize("smoothness,power,noise_free,r,d_feat,hetero", CASES)
def test_plain_matches_tpu_kernel_rows(smoothness, power, noise_free, r,
                                       d_feat, hetero):
    args = k2_inputs(CASES.index((smoothness, power, noise_free, r, d_feat,
                                  hetero)), d_feat, r, power, hetero,
                     noise_free)
    pw, cw, y, params, noise_nn = args
    kw = dict(smoothness=smoothness, metric_power=power,
              noise_free=noise_free, d_feat=d_feat)
    ref = np.asarray(jax_k2(
        jnp.asarray(pw), jnp.asarray(cw), jnp.asarray(y), jnp.asarray(params),
        noise_nn=None if noise_nn is None else jnp.asarray(noise_nn),
        batch_tile=B, interpret=True, **kw,
    ))
    T = torch.as_tensor
    out = fused_train_stats_bl_plain(
        T(pw), T(cw), T(y), T(params),
        None if noise_nn is None else T(noise_nn), **kw,
    ).numpy()
    G = d_feat if d_feat else 1
    assert out.shape == ref.shape == ((r + 2) + G * (r + 2) + (r + 1), B)
    # each row against its own scale: a wrong sign or factor in any one
    # derivative row fails
    for i in range(out.shape[0]):
        scale = np.abs(ref[i]).max()
        assert scale > 0
        np.testing.assert_allclose(
            out[i], ref[i], rtol=1e-8, atol=1e-10 * scale, err_msg=f"row {i}"
        )

    # the wrapper on the CPU is the plain version, and launches nothing
    _build.reset_launches()
    out_w = fused_train_stats_bl(*args, device="cpu", **kw)
    assert _build.launches["fused_train_stats"] == 0
    np.testing.assert_array_equal(out_w.numpy(), out)


# (nu, free nu, noise_free, r, d_feat, heteroscedastic): K2 under "gen", a
# fixed order without the tangent sets and a free one with the d/dnu rows,
# isotropic and anisotropic, homo- and heteroscedastic, the clamp zone
GEN_CASES = [
    (1.2, False, True, 1, 0, False),
    (1.2, True, True, 1, 0, False),
    (0.31, True, False, 2, 0, False),
    (4.8, True, True, 1, 2, False),
    (2.0, True, False, 1, 0, True),
    (1.37, True, False, 2, 2, True),
]


@pytest.mark.parametrize("nu,free,noise_free,r,d_feat,hetero", GEN_CASES)
def test_gen_plain_matches_tpu_kernel_rows(nu, free, noise_free, r, d_feat,
                                           hetero):
    """The same coefficient vector (JAX's f64 constructor, with the nu-tangent
    sets when nu is free) through the Pallas kernel and through the plain
    version, row by row; the d/dnu group comes after the noise rows."""
    args = k2_inputs(10 + GEN_CASES.index((nu, free, noise_free, r, d_feat,
                                           hetero)), d_feat, r, 1, hetero,
                     noise_free)
    pw, cw, y, params, noise_nn = args
    co = np.asarray(jax_coeffs(jnp.float64(nu), need_dnu=free))
    kw = dict(smoothness="gen", noise_free=noise_free, smoothness_free=free,
              d_feat=d_feat)
    ref = np.asarray(jax_k2(
        jnp.asarray(pw), jnp.asarray(cw), jnp.asarray(y), jnp.asarray(params),
        noise_nn=None if noise_nn is None else jnp.asarray(noise_nn),
        gen_coeffs=jnp.asarray(co), batch_tile=B, interpret=True, **kw,
    ))
    _build.reset_launches()
    out = fused_train_stats_bl(
        *args, gen_coeffs=co, device="cpu", **kw
    ).numpy()
    assert _build.launches["fused_train_stats"] == 0
    G = d_feat if d_feat else 1
    rows = (r + 2) + G * (r + 2) + (r + 1) + ((r + 2) if free else 0)
    assert out.shape == ref.shape == (rows, B)
    # at an exact integer the clamp leaves mu = 1e-7, and the coefficient
    # sets carry 1/mu-sized terms that cancel in the evaluator: the two
    # frameworks' roundings (fused multiply-adds or not) then differ by
    # ~1e-16 / 1e-7 relative instead of ~1e-16
    rtol = 1e-5 if nu == round(nu) else 1e-8
    for i in range(rows):
        scale = np.abs(ref[i]).max()
        assert scale > 0
        np.testing.assert_allclose(
            out[i], ref[i], rtol=rtol, atol=1e-2 * rtol * scale,
            err_msg=f"row {i}",
        )
    if free:
        # the leading rows do not depend on the tangent sets
        fixed = fused_train_stats_bl(
            *args, gen_coeffs=co[:139], device="cpu",
            **dict(kw, smoothness_free=False),
        ).numpy()
        np.testing.assert_array_equal(fixed, out[:rows - (r + 2)])


def test_wrapper_checks():
    pw, cw, y, params, noise_nn = k2_inputs(0, 0, 1, 1, True, False)
    co = np.zeros(207)
    with pytest.raises(ValueError, match="requires gen_coeffs"):
        fused_train_stats_bl(pw, cw, y, params, smoothness="gen", device="cpu")
    with pytest.raises(ValueError, match="pass any other order as 'gen'"):
        fused_train_stats_bl(pw, cw, y, params, smoothness=1.37, device="cpu")
    with pytest.raises(ValueError, match='smoothness_free requires smoothness="gen"'):
        fused_train_stats_bl(
            pw, cw, y, params, smoothness_free=True, device="cpu"
        )
    with pytest.raises(ValueError, match="requires the l2 metric"):
        fused_train_stats_bl(
            pw, cw, y, params, gen_coeffs=co, smoothness="gen",
            metric_power=2, device="cpu",
        )
    # a fixed order needs the d/dt sets, a free one the nu-tangent sets too
    with pytest.raises(ValueError, match="needs 139 coefficients"):
        fused_train_stats_bl(
            pw, cw, y, params, gen_coeffs=co[:73], smoothness="gen",
            device="cpu",
        )
    with pytest.raises(ValueError, match="needs 207 coefficients"):
        fused_train_stats_bl(
            pw, cw, y, params, gen_coeffs=co[:139], smoothness="gen",
            smoothness_free=True, device="cpu",
        )
    with pytest.raises(ValueError, match="never free"):
        fused_train_stats_bl(
            pw, cw, y, params, noise_nn, noise_free=True, device="cpu"
        )
    with pytest.raises(ValueError, match="metric_power"):
        fused_train_stats_bl(pw, cw, y, params, metric_power=3, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        fused_train_stats_bl(pw, cw[:, :5], y, params, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        fused_train_stats_bl(pw, cw, y, params[:2], device="cpu")
    with pytest.raises(ValueError, match="shapes"):  # isotropic pw as aniso
        fused_train_stats_bl(pw, cw, y, params, d_feat=2, device="cpu")


def test_wrapper_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pw, cw, y, params, _ = k2_inputs(0, 0, 1, 1, False, False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_train_stats_bl(pw, cw, y, params)
