"""K4's Python side (muygpys_torch.gpu.matern_nu: the coefficient constructors
and matern_nu_eval, the plain version of csrc/matern_nu.cuh) against
muygpys_tpu.pallas.matern_nu on the same numpy inputs, in f64, and against
scipy's kv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from muygpys_tpu.pallas import matern_nu as jm
from muygpys_torch.gpu import matern_nu as tm
from muygpys_torch.ops import kernels as tops

NUS = [0.05, 0.31, 0.5, 1.2, 1.5, 2.5, 3.7, 4.8, 7.3, 10.0]
TS = np.concatenate(
    [[0.0], np.logspace(-3, np.log10(tm.TMAX - 0.1), 60), [45.0, 80.0]]
)


def phi_exact(nu, t):
    with np.errstate(all="ignore"):
        out = 2.0 ** (1 - nu) / scipy.special.gamma(nu) * t**nu * scipy.special.kv(nu, t)
    return np.where(t <= 0, 1.0, out)


def assert_coeffs_close(got, want, rtol):
    """Each coefficient set against its own largest magnitude: the sets span
    thirty orders of magnitude, and a set's small members are sums of its
    large ones (1e-14 absolute covers a set that is zero up to rounding: the
    tail fit at nu = 1/2)."""
    assert got.shape == want.shape
    for lo, hi in tm.COEFF_SETS.values():
        if lo >= got.size:
            break
        scale = np.abs(want[lo:hi]).max()
        np.testing.assert_allclose(
            got[lo:hi], want[lo:hi], rtol=rtol, atol=rtol * scale + 1e-14,
            err_msg=f"coefficients {lo}:{hi}",
        )


def test_layout_matches_jax():
    for name in ("T0", "TMAX", "KSM", "NTAIL", "NU_MIN", "NU_MAX", "_OFF_A",
                 "_OFF_B", "_OFF_C", "_LEN_VAL", "_OFF_AP", "_OFF_BP",
                 "_OFF_CP", "_LEN_DT", "_OFF_DA", "_OFF_DB", "_OFF_DC",
                 "_LEN_DNU"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert (tm._LEN_VAL, tm._LEN_DT, tm._LEN_DNU) == (73, 139, 207)


@pytest.mark.parametrize("need_dnu", [False, True])
@pytest.mark.parametrize("nu", NUS)
def test_coeffs_match_jax(nu, need_dnu):
    want = np.asarray(jm.matern_nu_coeffs(jnp.float64(nu), need_dnu=need_dnu))
    got = tm.matern_nu_coeffs(
        torch.tensor(nu, dtype=torch.float64), need_dnu=need_dnu
    )
    assert got.dtype == torch.float64
    assert_coeffs_close(got.numpy(), want, 1e-9)


@pytest.mark.parametrize("nu", NUS + [1.0, 2.0, 0.999])
def test_host_coeffs_equal_jax(nu):
    for dtype in (np.float64, np.float32):
        got = tm.matern_nu_coeffs_host(nu, dtype)
        want = jm.matern_nu_coeffs_host(nu, dtype)
        assert got.dtype == dtype
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_f32_coeffs_follow_their_input():
    """An f32 smoothness builds in f32 throughout (clamp 1e-2), tangents
    included, and lands on JAX's f32 vector."""
    nu = torch.tensor(1.2, dtype=torch.float32)
    got = tm.matern_nu_coeffs(nu, need_dnu=True)
    assert got.dtype == torch.float32
    want = np.asarray(jm.matern_nu_coeffs(jnp.float32(1.2), need_dnu=True))
    assert want.dtype == np.float32
    assert_coeffs_close(got.numpy(), want, 2e-4)
    # inside the f32 clamp zone mu is moved to the clamp
    near = tm.matern_nu_coeffs(torch.tensor(2.003, dtype=torch.float32))
    np.testing.assert_allclose(float(near[2]), 1e-2, rtol=1e-5)


@pytest.mark.parametrize("tail_terms", [tm.NTAIL, 28, 24])
@pytest.mark.parametrize("nu", [0.31, 1.2, 2.0, 4.8])
def test_eval_matches_jax(nu, tail_terms):
    """Value, d/dt and the partial d/dnu from ONE coefficient vector (JAX's),
    so only the evaluator is compared; truncated tails included."""
    co = np.asarray(jm.matern_nu_coeffs(jnp.float64(nu), need_dnu=True))
    want = jm.matern_nu_eval(
        jnp.asarray(TS), jnp.asarray(co), need_dt=True, need_dnu=True,
        tail_terms=tail_terms,
    )
    got = tm.matern_nu_eval(
        torch.as_tensor(TS), torch.tensor(co), need_dt=True, need_dnu=True,
        tail_terms=tail_terms,
    )
    for g, w, name in zip(got, want, ("phi", "dphi/dt", "dphi/dnu")):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=1e-11, atol=1e-14, err_msg=name
        )
    # the value alone, and value + dt alone, are the same numbers
    torch.testing.assert_close(
        tm.matern_nu_eval(torch.as_tensor(TS), torch.tensor(co),
                          tail_terms=tail_terms), got[0], rtol=0, atol=0,
    )


@pytest.mark.parametrize("nu", NUS + [1.0, 2.0])
def test_value_vs_scipy(nu):
    """The port's own constructor and evaluator against the function: <= 1e-8
    mixed error in f64 (1e-6 at exact integers, the clamp's floor), and
    <= 4e-6 for the serving configuration (host f64 constructor, f32
    evaluation, 28 tail terms)."""
    co = tm.matern_nu_coeffs(torch.tensor(nu, dtype=torch.float64))
    got = tm.matern_nu_eval(torch.as_tensor(TS), co).numpy()
    want = phi_exact(nu, TS)
    dom = TS <= tm.TMAX
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert err[dom].max() < (1e-6 if nu == round(nu) else 1e-8)
    assert np.abs(got - want)[~dom].max() < 1e-10
    co32 = torch.as_tensor(tm.matern_nu_coeffs_host(nu, np.float32))
    got32 = tm.matern_nu_eval(
        torch.as_tensor(TS, dtype=torch.float32), co32,
        tail_terms=tm.TAIL_TERMS_SERVE_F32,
    ).numpy().astype(float)
    assert (np.abs(got32 - want) / np.maximum(np.abs(want), 1e-4)).max() < 4e-6


def test_clamp_zone_tangent():
    """Exactly-integer nu: d mu_eff / d nu = 1 under FORWARD mode (the clamp
    offset carries no tangent), so the nu-tangent is the finite tangent at
    the clamped point, within a few percent of the true d phi / d nu."""
    nu = torch.tensor([2.0], dtype=torch.float64)
    delta = tm._clamp_offset(nu)
    assert float(delta) == pytest.approx(1e-7)
    co, dco = torch.func.jvp(
        lambda v: tm._build_value_coeffs(v, delta), (nu,), (torch.ones_like(nu),)
    )
    assert float(co[2]) == pytest.approx(1e-7) and float(dco[2]) == 1.0
    full = tm.matern_nu_coeffs(torch.tensor(2.0, dtype=torch.float64), need_dnu=True)
    tt = np.asarray([0.5, 1.0, 3.0, 10.0])
    _, dnu = tm.matern_nu_eval(torch.as_tensor(tt), full, need_dnu=True)
    h = 1e-5
    fd = (phi_exact(2.0 + h, tt) - phi_exact(2.0 - h, tt)) / (2 * h)
    assert np.all(np.abs(dnu.numpy() - fd) <= 0.05 * np.abs(fd) + 1e-6), (dnu, fd)


@pytest.mark.parametrize("nu", [0.31, 0.999, 1.5, 5.0001, 9.5])
def test_derivatives_vs_fd(nu):
    co = tm.matern_nu_coeffs(torch.tensor(nu, dtype=torch.float64), need_dnu=True)
    tt = TS[(TS > 1e-2) & (TS < tm.TMAX)]
    _, dt, dnu = tm.matern_nu_eval(
        torch.as_tensor(tt), co, need_dt=True, need_dnu=True
    )
    h = 1e-6
    fd_t = (phi_exact(nu, tt + h) - phi_exact(nu, tt - h)) / (2 * h)
    assert (np.abs(dt.numpy() - fd_t) / np.maximum(np.abs(fd_t), 1e-5)).max() < 5e-6
    h = 1e-5
    fd_nu = (phi_exact(nu + h, tt) - phi_exact(nu - h, tt)) / (2 * h)
    assert (np.abs(dnu.numpy() - fd_nu) / np.maximum(np.abs(fd_nu), 1e-4)).max() < 5e-6


def test_coeffs_differentiable_by_autograd():
    """Reverse mode through the constructor and evaluator matches JAX's."""
    nu = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    t = torch.tensor([0.7, 3.0], dtype=torch.float64)
    tm.matern_nu_eval(t, tm.matern_nu_coeffs(nu)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jm.matern_nu_eval(
        jnp.asarray([0.7, 3.0]), jm.matern_nu_coeffs(v))))(jnp.float64(1.7))
    np.testing.assert_allclose(float(nu.grad), float(want), rtol=1e-9)


def test_closed_forms_and_zero_distance():
    d = torch.as_tensor(np.linspace(0.0, 8.0, 100))
    for nu, closed in [(0.5, tops.matern_05_fn), (1.5, tops.matern_15_fn),
                       (2.5, tops.matern_25_fn)]:
        np.testing.assert_allclose(
            tm.matern_gen_surrogate(d, nu).numpy(), closed(d).numpy(),
            rtol=2e-8, atol=1e-10,
        )
    for nu in (0.31, 1.0, 4.2):
        out = tm.matern_nu_eval(
            torch.zeros(3, dtype=torch.float64), tm.matern_nu_coeffs(nu),
            need_dt=True, need_dnu=False,
        )
        assert (out[0] == 1.0).all() and (out[1] == 0.0).all()


def test_truncated_tail_derivative_is_its_own():
    """With 24 tail terms d phi/dt is the derivative of the TRUNCATED phi:
    its Chebyshev coefficients are re-derived from the truncated series."""
    co = tm.matern_nu_coeffs(torch.tensor(4.8, dtype=torch.float64))
    t = torch.tensor(np.linspace(2.5, 40.0, 30), requires_grad=True)
    phi, dt = tm.matern_nu_eval(t, co, need_dt=True, tail_terms=24)
    phi.sum().backward()
    np.testing.assert_allclose(dt.detach().numpy(), t.grad.numpy(), rtol=1e-10)
