"""K1: the plain version of the fused coords solve against the TPU kernel
(muygpys_tpu.pallas.fused_predict.fused_predict_coords_bl, interpret mode)
on the same numpy inputs, in f64."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.pallas.fused_predict import fused_predict_coords_bl as jax_k1
from muygpys_torch.gpu import _build
from muygpys_torch.gpu.fused_predict import (
    fused_predict_coords_bl,
    fused_predict_coords_bl_plain,
)

N, B = 12, 128


def _inputs(seed, d, r, hetero):
    rng = np.random.default_rng(seed)
    nf = rng.uniform(size=(N, d, B))
    q = rng.uniform(size=(d, B))
    y = rng.standard_normal((N, r, B))
    params = np.concatenate([rng.uniform(0.4, 0.9, size=d), [1e-3]])
    noise_nn = rng.uniform(1e-4, 1e-2, size=(N, B)) if hetero else None
    return nf, q, y, params, noise_nn


# (smoothness, metric_power, d, r, heteroscedastic): every closed form,
# RBF on the F2 metric, and the per-neighbor nugget
CASES = [
    (0.5, 1, 2, 1, False),
    (1.5, 1, 2, 1, False),
    (2.5, 1, 3, 2, False),
    (math.inf, 1, 2, 2, False),
    ("rbf", 2, 3, 1, False),
    (1.5, 1, 3, 2, True),
    ("rbf", 2, 2, 1, True),
]


@pytest.mark.parametrize("smoothness,power,d,r,hetero", CASES)
def test_plain_matches_tpu_kernel(smoothness, power, d, r, hetero):
    nf, q, y, params, noise_nn = _inputs(len(str(smoothness)) + d + r, d, r, hetero)
    m0, v0 = jax_k1(
        jnp.asarray(nf), jnp.asarray(q), jnp.asarray(y), jnp.asarray(params),
        noise_nn=None if noise_nn is None else jnp.asarray(noise_nn),
        smoothness=smoothness, metric_power=power, batch_tile=128,
        interpret=True,
    )
    t = torch.as_tensor
    mean, var = fused_predict_coords_bl_plain(
        t(nf), t(q), t(y), t(params),
        None if noise_nn is None else t(noise_nn),
        smoothness=smoothness, metric_power=power,
    )
    assert mean.shape == (r, B) and var.shape == (B,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(m0), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(v0), rtol=1e-8, atol=1e-10)

    # the wrapper on the CPU is the plain version, and launches nothing
    _build.reset_launches()
    mean_w, var_w = fused_predict_coords_bl(
        nf, q, y[:, 0, :] if r == 1 else y, params, noise_nn,
        smoothness=smoothness, metric_power=power, device="cpu",
    )
    assert _build.launches["fused_predict_coords"] == 0
    torch.testing.assert_close(mean_w, mean, rtol=0, atol=0)
    torch.testing.assert_close(var_w, var, rtol=0, atol=0)


def test_wrapper_checks():
    nf, q, y, params, _ = _inputs(0, 2, 1, False)
    with pytest.raises(ValueError, match="general smoothness is not ported"):
        fused_predict_coords_bl(nf, q, y, params, smoothness="gen", device="cpu")
    with pytest.raises(ValueError, match="smoothness"):
        fused_predict_coords_bl(nf, q, y, params, smoothness=1.37, device="cpu")
    with pytest.raises(ValueError, match="metric_power"):
        fused_predict_coords_bl(nf, q, y, params, metric_power=3, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        fused_predict_coords_bl(nf, q[:, :5], y, params, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        fused_predict_coords_bl(nf, q, y, params[:2], device="cpu")


def test_wrapper_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nf, q, y, params, _ = _inputs(0, 2, 1, False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_predict_coords_bl(nf, q, y, params)
