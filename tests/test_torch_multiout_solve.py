"""K5's plain version (what device="cpu" runs) against the TPU kernel in
interpret mode and against the JAX lanes solver (f64), at
tests/test_multiout_solve.py's tolerance (rtol 1e-10, atol 1e-12): both
entries (batch-last and frontend), an odd batch, and a numerically singular
block, where the relative Gill-Murray pivot floor acts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.ops.lanes_solver import (
    multiout_serve_mean_and_variance as jax_lanes,
)
from muygpys_tpu.pallas.multiout_solve import multiout_serve_pallas
from muygpys_torch.gpu import _build
from muygpys_torch.gpu import multiout_solve as K5
from muygpys_torch.ops.lanes_solver import (
    multiout_frontend_bl,
    multiout_serve_mean_and_variance,
)

T, J = torch.as_tensor, jnp.asarray


def blocks(rng, B, I, n, O):
    """tests/test_multiout_solve.py's blocks: A A^T / 2m + I/2, symmetric
    only to rounding."""
    m = I * n
    A = rng.standard_normal((B, m, 2 * m))
    Kin = (A @ A.transpose(0, 2, 1) / (2 * m) + 0.5 * np.eye(m)).reshape(
        B, I, n, I, n
    )
    Kc = rng.standard_normal((B, I, n, O))
    y = rng.standard_normal((B, I, n))
    Kout = np.eye(O) * 1.3 + 0.1
    return Kin, Kc, Kout, y


def make_singular(Kin, b=3):
    """Duplicate two observation rows of block ``b`` exactly."""
    B = Kin.shape[0]
    m = Kin.shape[1] * Kin.shape[2]
    flat = np.array(Kin).reshape(B, m, m)
    flat[b, 5, :] = flat[b, 4, :]
    flat[b, :, 5] = flat[b, :, 4]
    return flat.reshape(Kin.shape)


def _close(got, want, rtol=1e-10, atol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "I,n,O,B", [(3, 8, 3, 12), (2, 7, 3, 24), (1, 12, 1, 32), (3, 8, 3, 7)],
    ids=["shear33", "shear23", "univariate", "odd-batch"],
)
def test_plain_matches_tpu_kernel_and_lanes(rng, I, n, O, B):
    Kin, Kc, Kout, y = blocks(rng, B, I, n, O)
    m_p, c_p = multiout_serve_pallas(J(Kin), J(Kc), J(Kout), J(y), interpret=True)
    m_l, c_l = jax_lanes(J(Kin), J(Kc), J(Kout), J(y))
    _build.reset_launches()
    mean, cov = K5.multiout_serve_cuda(T(Kin), T(Kc), T(Kout), T(y), device="cpu")
    # a CPU tensor takes the plain version: no launch is counted
    assert _build.launches["multiout_solve"] == 0
    assert mean.shape == (B, O) and cov.shape == (B, O, O)
    _close(mean, m_p)
    _close(cov, c_p)
    _close(mean, m_l)
    _close(cov, c_l)
    # the port's lanes engine gives the same numbers
    m_t, c_t = multiout_serve_mean_and_variance(T(Kin), T(Kc), T(Kout), T(y))
    _close(m_t, m_l)
    _close(c_t, c_l)


def test_batch_last_and_frontend_entries_agree(rng):
    Kin, Kc, Kout, y = blocks(rng, 10, 3, 8, 3)
    mean_f, cov_f = K5.multiout_serve_cuda(
        T(Kin), T(Kc), T(Kout), T(y), device="cpu"
    )
    Kin_bl, Kc_bl, y_bl = multiout_frontend_bl(T(Kin), T(Kc), T(y))
    assert Kin_bl.shape == (24, 24, 10) and Kc_bl.shape == (24, 3, 10)
    assert y_bl.shape == (24, 10)
    mean_b, cov_b = K5.fused_multiout_solve_bl(
        Kin_bl, Kc_bl, T(Kout), y_bl, device="cpu"
    )
    assert mean_b.shape == (3, 10) and cov_b.shape == (3, 3, 10)
    _close(mean_b.T, mean_f, rtol=0, atol=0)
    _close(cov_b.permute(2, 0, 1), cov_f, rtol=0, atol=0)
    # numpy in, and the inputs are left as they were
    before = Kin_bl.clone()
    mean_n, _ = K5.fused_multiout_solve_bl(
        Kin_bl.numpy(), Kc_bl.numpy(), Kout, y_bl.numpy(), device="cpu"
    )
    _close(mean_n, mean_b, rtol=0, atol=0)
    assert torch.equal(Kin_bl, before)


def test_singular_block_stays_finite_and_matches_jax(rng):
    """Where a pivot falls under the floor, row j is still divided by
    sqrt(floor) and enters mean and S: the singular block's numbers are
    huge (~1/floor) but finite, and the same in both packages.  Its
    tolerance: the floored pivot is 10 eps mean(diag) in both, so the blown
    up values agree to the rounding of the steps before it, rtol 1e-6 of
    values ~1e15; every other block agrees at rtol 1e-9."""
    Kin, Kc, Kout, y = blocks(rng, 8, 3, 8, 3)
    Kin = make_singular(Kin)
    m_p, c_p = multiout_serve_pallas(J(Kin), J(Kc), J(Kout), J(y), interpret=True)
    m_l, c_l = jax_lanes(J(Kin), J(Kc), J(Kout), J(y))
    mean, cov = K5.multiout_serve_cuda(T(Kin), T(Kc), T(Kout), T(y), device="cpu")
    m_t, c_t = multiout_serve_mean_and_variance(T(Kin), T(Kc), T(Kout), T(y))
    for got in (mean, cov, m_t, c_t):
        assert torch.isfinite(got).all()
    ok = [b for b in range(8) if b != 3]
    for got_m, got_c in ((mean, cov), (m_t, c_t)):
        _close(got_m[ok], np.asarray(m_p)[ok], rtol=1e-9, atol=1e-11)
        _close(got_c[ok], np.asarray(c_p)[ok], rtol=1e-9, atol=1e-11)
    assert float(mean[3].abs().max()) > 1e8  # the floor did act
    _close(mean[3], np.asarray(m_p)[3], rtol=1e-6, atol=0)
    _close(cov[3], np.asarray(c_p)[3], rtol=1e-6, atol=0)
    _close(m_t[3], np.asarray(m_l)[3], rtol=1e-6, atol=0)
    _close(c_t[3], np.asarray(c_l)[3], rtol=1e-6, atol=0)


def test_plain_version_reads_lower_column_and_upper_row(rng):
    """The contract takes any Kin: the column below the pivot comes from
    the lower triangle and the pivot row from the upper, as in the TPU
    kernel, so an unsymmetric Kin gives the TPU kernel's numbers too."""
    Kin, Kc, Kout, y = blocks(rng, 6, 2, 5, 3)
    Kin = Kin + 1e-3 * rng.standard_normal(Kin.shape)
    m_p, c_p = multiout_serve_pallas(J(Kin), J(Kc), J(Kout), J(y), interpret=True)
    mean, cov = K5.multiout_serve_cuda(T(Kin), T(Kc), T(Kout), T(y), device="cpu")
    _close(mean, m_p)
    _close(cov, c_p)


def test_shape_and_device_errors(rng, monkeypatch):
    Kin, Kc, Kout, y = (T(t) for t in blocks(rng, 4, 3, 4, 3))
    with pytest.raises(ValueError, match="multiout_serve_cuda takes Kin"):
        K5.multiout_serve_cuda(Kin.reshape(4, 12, 12), Kc, Kout, y, device="cpu")
    with pytest.raises(ValueError, match="multiout_serve_cuda shapes"):
        K5.multiout_serve_cuda(Kin, Kc[:, :2], Kout, y, device="cpu")
    Kin_bl, Kc_bl, y_bl = multiout_frontend_bl(Kin, Kc, y)
    with pytest.raises(ValueError, match="fused_multiout_solve_bl shapes"):
        K5.fused_multiout_solve_bl(Kin_bl, Kc_bl, Kout[:2], y_bl, device="cpu")
    with pytest.raises(ValueError, match="fused_multiout_solve_bl shapes"):
        K5.fused_multiout_solve_bl(Kin_bl, Kc_bl[:, 0], Kout, y_bl, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        K5.fused_multiout_solve_bl(Kin_bl, Kc_bl, Kout, y_bl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        K5.multiout_serve_cuda(Kin, Kc, Kout, y)


def test_shared_memory_rule():
    """One query per block: the augmented matrix and the pivot scales.  The
    shear shapes fit; the launcher refuses what does not, never shrinks."""
    assert K5.multiout_shared_bytes(90, 3, torch.float32) == 4 * (90 * 94 + 90)
    assert K5.multiout_shared_bytes(90, 3, torch.float64) == 8 * (90 * 94 + 90)
    for m, dtype, fits in (
        (90, torch.float32, True), (60, torch.float64, True),
        (238, torch.float32, True), (239, torch.float32, False),
        (167, torch.float64, True), (168, torch.float64, False),
    ):
        need = K5.multiout_shared_bytes(m, 3, dtype)
        assert (need <= K5.MAX_SHARED_BYTES) == fits, (m, dtype, need)
    # the refusal comes before any build or launch (a meta tensor stands in
    # for a CUDA one)
    Kin = torch.empty((2, 239, 239), device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        K5._launch(Kin, torch.empty((2, 239, 3), device="meta"),
                   torch.empty((2, 239), device="meta"), 239, 3, 2, False)
    with pytest.raises(ValueError, match="f32 or f64"):
        K5._launch(Kin.half(), None, None, 239, 3, 2, False)
