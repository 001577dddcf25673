"""K2: the plain version of the fused LOO statistics against the TPU kernel
(muygpys_tpu.pallas.fused_train.fused_train_stats_bl, interpret mode) on
the same numpy inputs, row by row, in f64; and the wrapper's rules."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.pallas.fused_train import fused_train_stats_bl as jax_k2
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


def test_wrapper_checks():
    pw, cw, y, params, noise_nn = k2_inputs(0, 0, 1, 1, True, False)
    with pytest.raises(ValueError, match="general-smoothness slice"):
        fused_train_stats_bl(pw, cw, y, params, smoothness="gen", device="cpu")
    with pytest.raises(ValueError, match="general-smoothness slice"):
        fused_train_stats_bl(pw, cw, y, params, smoothness=1.37, device="cpu")
    with pytest.raises(ValueError, match="general-smoothness slice"):
        fused_train_stats_bl(
            pw, cw, y, params, smoothness_free=True, device="cpu"
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
