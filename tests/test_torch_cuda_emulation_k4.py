"""K4's coefficient constructor (csrc/matern_nu_coeffs.cu), run on the CPU
one thread per CUDA thread (``_cuda_emulation``), against its plain PyTorch
version and the JAX package's builder; its device digamma against
torch.special.digamma.  Skipped where ``g++`` lacks C++20 ``<barrier>``
(its ThreadSanitizer launch is in test_torch_cuda_emulation.py)."""

import numpy as np
import pytest
import torch

import _cuda_emulation as emu
from muygpys_torch.gpu import matern_nu as tm


@pytest.fixture(scope="module")
def k4_lib(tmp_path_factory):
    import ctypes

    path = str(tmp_path_factory.mktemp("cuda_emulation_k4"))
    why = emu.compiler_ready(path)
    if why:
        pytest.skip(f"the CUDA emulation needs g++ with C++20: {why}")
    return ctypes.CDLL(emu.build("matern_nu_coeffs", path))


def _assert_within(got, want, limits, what):
    err = (got - want).abs().double().numpy()
    worst = int(np.argmax(err / limits))
    assert (err <= limits).all(), (
        f"{what}: entry {worst} off by {err[worst]:.3e}, limit "
        f"{limits[worst]:.3e}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("need_dnu", [False, True], ids=["value", "dnu"])
@pytest.mark.parametrize("nu", tm.COEFFS_CHECK_NUS)
def test_k4_constructor_source_matches_plain(k4_lib, nu, need_dnu, dtype):
    """One launch of the constructor kernel gives matern_nu_coeffs_plain's
    vector (tangent sets included), in the dtype of nu."""
    t = torch.tensor([nu], dtype=dtype)
    got, _ = emu.coeffs_run(k4_lib, t, need_dnu)
    want = tm.matern_nu_coeffs_plain(t, need_dnu)
    assert got.shape == want.shape and torch.isfinite(got).all()
    limits = tm.coeffs_limits(want, tm.COEFFS_CHECK_RTOL[dtype])
    _assert_within(got, want, limits, f"nu={nu}")


@pytest.mark.parametrize("need_dnu", [False, True], ids=["value", "dnu"])
@pytest.mark.parametrize("nu", tm.COEFFS_CHECK_NUS[:10])
def test_k4_constructor_source_matches_jax(k4_lib, nu, need_dnu):
    """The constructor kernel in f64 against the JAX package's builder, at
    test_torch_matern_nu.py's bound."""
    import jax.numpy as jnp
    from muygpys_tpu.pallas import matern_nu as jm
    from test_torch_matern_nu import assert_coeffs_close

    got, _ = emu.coeffs_run(k4_lib, torch.tensor([nu], dtype=torch.float64),
                            need_dnu)
    want = np.asarray(jm.matern_nu_coeffs(jnp.float64(nu), need_dnu=need_dnu))
    assert_coeffs_close(got.numpy(), want, 1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nu", [0.31, 1.2, 2.0, 4.8])
def test_k4_constructor_source_tangent_is_the_jacobian(k4_lib, nu, dtype):
    """The tangent the launch writes for autograd is the plain version's
    forward-mode tangent of the whole value vector, ap, bp, cp and the
    scalars included."""
    t = torch.tensor([nu], dtype=dtype)
    _, dout = emu.coeffs_run(k4_lib, t, False, tangent=True)
    delta = tm._clamp_offset(t)
    _, want = torch.func.jvp(lambda v: tm._build_value_coeffs(v, delta),
                             (t,), (torch.ones_like(t),))
    _assert_within(dout, want, tm.coeffs_limits(want, tm.COEFFS_CHECK_RTOL[dtype]),
                   f"tangent at nu={nu}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k4_digamma_source_matches_torch(k4_lib, dtype):
    """The constructor's digamma (CUDA's math library has none) against
    torch.special.digamma: the recurrence's range, x = 10 exactly, the
    asymptotic series, and the reflection below 0."""
    x = torch.cat([torch.linspace(0.01, 30.0, 997, dtype=torch.float64),
                   torch.tensor([1.0, 9.999, 10.0, 10.001, 1e3, 1e6, -0.5,
                                 -2.25, -7.9], dtype=torch.float64)]).to(dtype)
    got = emu.digamma_run(k4_lib, x)
    want = torch.special.digamma(x)
    rtol = {torch.float64: 1e-14, torch.float32: 4e-6}[dtype]
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol)
