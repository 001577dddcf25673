"""K1 and K1b: the plain versions of the fused coords solve and of the
distance-input solve against the TPU kernels
(muygpys_tpu.pallas.fused_predict.fused_predict_coords_bl and
fused_predict_bl, interpret mode) on the same numpy inputs, in f64, closed
forms and general smoothness ("gen", through K4's plain version)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.pallas.fused_predict import fused_predict_bl as jax_k1b
from muygpys_tpu.pallas.fused_predict import fused_predict_coords_bl as jax_k1
from muygpys_tpu.pallas.matern_nu import matern_nu_coeffs as jax_coeffs
from muygpys_torch.gpu import _build
from muygpys_torch.gpu.fused_predict import (
    fused_predict_bl,
    fused_predict_bl_plain,
    fused_predict_coords_bl,
    fused_predict_coords_bl_plain,
)
from muygpys_torch.gpu.matern_nu import matern_nu_coeffs

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


BG = 64  # interpret-mode gen is slow in JAX


def _gen_inputs(nu, d, r, hetero):
    nf, q, y, params, noise_nn = _inputs(int(nu * 100) + d + r, d, r, hetero)
    keep = (slice(None),) * 2 + (slice(BG),)
    return (nf[keep], q[:, :BG], y[keep], params,
            None if noise_nn is None else noise_nn[:, :BG])


# (nu, d, r, heteroscedastic): small and large orders, the clamp zone
GEN_CASES = [(0.31, 2, 1, False), (1.2, 2, 2, False), (2.0, 3, 1, True),
             (4.8, 2, 1, False)]


@pytest.mark.parametrize("nu,d,r,hetero", GEN_CASES)
def test_gen_plain_matches_tpu_kernel(nu, d, r, hetero):
    """K1 under "gen": the same coefficient vector (JAX's f64 constructor)
    through the Pallas kernel and through the plain version; and the port's
    own constructor gives the same posterior."""
    nf, q, y, params, noise_nn = _gen_inputs(nu, d, r, hetero)
    co = np.asarray(jax_coeffs(jnp.float64(nu)))
    m0, v0 = jax_k1(
        jnp.asarray(nf), jnp.asarray(q), jnp.asarray(y), jnp.asarray(params),
        noise_nn=None if noise_nn is None else jnp.asarray(noise_nn),
        gen_coeffs=jnp.asarray(co), smoothness="gen", batch_tile=BG,
        interpret=True,
    )
    _build.reset_launches()
    mean, var = fused_predict_coords_bl(
        nf, q, y, params, noise_nn, gen_coeffs=co, smoothness="gen",
        device="cpu",
    )
    assert _build.launches["fused_predict_coords"] == 0
    np.testing.assert_allclose(mean.numpy(), np.asarray(m0), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(var.numpy(), np.asarray(v0), rtol=1e-8, atol=1e-9)
    own = matern_nu_coeffs(torch.tensor(nu, dtype=torch.float64))
    mean2, var2 = fused_predict_coords_bl(
        nf, q, y, params, noise_nn, gen_coeffs=own, smoothness="gen",
        device="cpu",
    )
    # atol: in the clamp zone (nu = 2) the two coefficient sets differ
    # by their cancellation error, ~1e-8 on phi
    np.testing.assert_allclose(mean2.numpy(), mean.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(var2.numpy(), var.numpy(), rtol=1e-6, atol=1e-6)


def _dist_inputs(seed, r, power, batch):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(batch, N, 2))
    q = rng.uniform(size=(batch, 2))
    pw = ((pts[:, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1)
    cw = ((q[:, None, :] - pts) ** 2).sum(-1)
    if power == 1:
        pw, cw = np.sqrt(pw), np.sqrt(cw)
    y = rng.standard_normal((N, r, batch))
    return pw.transpose(1, 2, 0), cw.T, y, np.array([0.37, 1e-3])


# (smoothness, metric_power, r): K1b's closed forms, RBF on F2 and gen
K1B_CASES = [(0.5, 1, 1), (1.5, 1, 2), (2.5, 1, 1), (math.inf, 1, 1),
             ("rbf", 2, 2), (0.31, 1, 1), (1.2, 1, 2), (4.8, 1, 1)]


@pytest.mark.parametrize("smoothness,power,r", K1B_CASES)
def test_k1b_plain_matches_tpu_kernel(smoothness, power, r):
    gen = smoothness in (0.31, 1.2, 4.8)
    batch = BG if gen else B
    pw, cw, y, params = _dist_inputs(K1B_CASES.index((smoothness, power, r)),
                                     r, power, batch)
    co = np.asarray(jax_coeffs(jnp.float64(smoothness))) if gen else None
    kw = dict(smoothness="gen" if gen else smoothness, metric_power=power)
    m0, v0 = jax_k1b(
        jnp.asarray(pw), jnp.asarray(cw), jnp.asarray(y), jnp.asarray(params),
        gen_coeffs=None if co is None else jnp.asarray(co), batch_tile=batch,
        interpret=True, **kw,
    )
    t = torch.as_tensor
    mean, var = fused_predict_bl_plain(
        t(pw), t(cw), t(y), t(params), None if co is None else t(co), **kw
    )
    assert mean.shape == (r, batch) and var.shape == (batch,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(m0), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(var.numpy(), np.asarray(v0), rtol=1e-8, atol=1e-9)
    # the wrapper on the CPU is the plain version, and launches nothing
    _build.reset_launches()
    mean_w, var_w = fused_predict_bl(
        pw, cw, y[:, 0, :] if r == 1 else y, params, co, device="cpu", **kw
    )
    assert _build.launches["fused_predict"] == 0
    torch.testing.assert_close(mean_w, mean, rtol=0, atol=0)
    torch.testing.assert_close(var_w, var, rtol=0, atol=0)


def test_wrapper_checks():
    nf, q, y, params, _ = _inputs(0, 2, 1, False)
    co = np.zeros(73)
    with pytest.raises(ValueError, match="requires gen_coeffs"):
        fused_predict_coords_bl(nf, q, y, params, smoothness="gen", device="cpu")
    with pytest.raises(ValueError, match="smoothness"):
        fused_predict_coords_bl(nf, q, y, params, smoothness=1.37, device="cpu")
    with pytest.raises(ValueError, match="requires the l2 metric"):
        fused_predict_coords_bl(
            nf, q, y, params, gen_coeffs=co, smoothness="gen", metric_power=2,
            device="cpu",
        )
    with pytest.raises(ValueError, match="needs 73 coefficients"):
        fused_predict_coords_bl(
            nf, q, y, params, gen_coeffs=co[:5], smoothness="gen", device="cpu"
        )
    with pytest.raises(ValueError, match="metric_power"):
        fused_predict_coords_bl(nf, q, y, params, metric_power=3, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        fused_predict_coords_bl(nf, q[:, :5], y, params, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        fused_predict_coords_bl(nf, q, y, params[:2], device="cpu")


def test_k1b_wrapper_checks():
    pw, cw, y, params = _dist_inputs(0, 1, 1, 16)
    with pytest.raises(ValueError, match="requires gen_coeffs"):
        fused_predict_bl(pw, cw, y, params, smoothness="gen", device="cpu")
    with pytest.raises(ValueError, match="pass any other order as 'gen'"):
        fused_predict_bl(pw, cw, y, params, smoothness=1.37, device="cpu")
    with pytest.raises(ValueError, match="requires the l2 metric"):
        fused_predict_bl(
            pw, cw, y, params, np.zeros(73), smoothness="gen", metric_power=2,
            device="cpu",
        )
    with pytest.raises(ValueError, match="shapes"):
        fused_predict_bl(pw, cw[:, :5], y, params, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        fused_predict_bl(pw, cw, y, np.ones(3), device="cpu")


def test_wrapper_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nf, q, y, params, _ = _inputs(0, 2, 1, False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_predict_coords_bl(nf, q, y, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_predict_bl(*_dist_inputs(0, 1, 1, 16))


def test_f32_distance_workflow_floor_is_the_assembly_in_both_packages():
    """The f32 distance workflow (make_predict_tensors' distance assembly
    -> K1b) against the same workflow in f64, on dense 2-D neighbourhoods
    (20,000 points, squared distances ~1e-4).  The JAX package's f32 floor
    comes from its Gram-identity assembly: f32 K1b on distances assembled
    in f64 is 5x closer.  The port centres each neighbourhood before the
    identity (and takes crosswise distances by direct differences), so its
    f32 workflow sits at that closer floor, K1b's own."""
    import jax

    from muygpys_tpu.ops import tensors as jax_tensors
    from muygpys_torch.ops import tensors as port_tensors

    rng = np.random.default_rng(3)
    count, batch = 20_000, 64
    train = rng.uniform(size=(count, 2))
    q = rng.uniform(size=(batch, 2))
    y = rng.standard_normal((count, 1))
    idx = np.argsort(((q[:, None, :] - train[None]) ** 2).sum(-1), 1)[:, :N]
    params = np.array([0.5, 1e-3])

    def port(assemble, solve):
        tr, qq = (torch.as_tensor(a, dtype=assemble) for a in (train, q))
        ii = torch.as_tensor(idx)
        pw = port_tensors.safe_sqrt(port_tensors.pairwise_F2(tr, ii))
        cw = port_tensors.safe_sqrt(
            port_tensors.crosswise_F2(qq, tr, torch.arange(batch), ii)
        )
        mean, var = fused_predict_bl_plain(
            pw.permute(1, 2, 0).to(solve), cw.T.to(solve),
            torch.as_tensor(y, dtype=solve)[ii].permute(1, 2, 0),
            torch.as_tensor(params, dtype=solve), smoothness=1.5,
        )
        return mean.double().numpy(), var.double().numpy()

    def reference(dtype):
        tr, qq = jnp.asarray(train, dtype), jnp.asarray(q, dtype)
        ii = jnp.asarray(idx)
        pw = jax_tensors.safe_sqrt(jax_tensors.pairwise_F2(tr, ii))
        cw = jax_tensors.safe_sqrt(
            jax_tensors.crosswise_F2(qq, tr, jnp.arange(batch), ii)
        )
        mean, var = jax_k1b(
            pw.transpose(1, 2, 0), cw.T,
            jnp.asarray(y, dtype)[ii].transpose(1, 2, 0),
            jnp.asarray(params, dtype), smoothness=1.5, batch_tile=batch,
            interpret=True,
        )
        return np.asarray(mean, np.float64), np.asarray(var, np.float64)

    assert jax.config.jax_enable_x64
    m64, v64 = port(torch.float64, torch.float64)
    mj64, vj64 = reference(jnp.float64)
    np.testing.assert_allclose(m64, mj64, rtol=0, atol=1e-9)
    np.testing.assert_allclose(v64, vj64, rtol=0, atol=1e-12)
    err = {
        "port": [np.abs(a - b).max() for a, b in
                 zip(port(torch.float32, torch.float32), (m64, v64))],
        "jax": [np.abs(a - b).max() for a, b in
                zip(reference(jnp.float32), (m64, v64))],
        "f64 assembly": [np.abs(a - b).max() for a, b in
                         zip(port(torch.float64, torch.float32), (m64, v64))],
    }
    for k in (0, 1):  # mean, variance
        assert err["f64 assembly"][k] <= 0.2 * err["jax"][k], err
        assert err["port"][k] <= 1.5 * err["f64 assembly"][k], err
    assert 1e-3 < err["jax"][0] < 2e-2, err


@pytest.mark.parametrize(
    "n,r,dtype,smoothness,want",
    [
        (30, 1, torch.float32, 1.5, "registers"),
        (30, 1, torch.float32, "gen", "registers"),
        (30, 2, torch.float64, "rbf", "registers"),
        (32, 4, torch.float64, math.inf, "registers"),
        (1, 1, torch.float32, 0.5, "registers"),
        (33, 1, torch.float32, 1.5, "shared"),
        (30, 5, torch.float32, 1.5, "shared"),
        (30, 1, torch.float16, 1.5, "shared"),
    ],
)
def test_k1_design_rule(n, r, dtype, smoothness, want):
    from muygpys_torch.gpu.fused_predict import k1_design

    assert k1_design(n, r, dtype, smoothness) == want


def test_k1_design_rule_refuses_an_unknown_smoothness():
    from muygpys_torch.gpu.fused_predict import k1_design

    with pytest.raises(ValueError, match="smoothness"):
        k1_design(30, 1, torch.float32, 1.2)
