"""Kernel functions and kernel functors against the JAX package (f64):
muygpys_torch.ops.kernels and muygpys_torch.gp.kernels."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.gp import kernels as jk
from muygpys_tpu.gp.deformation import F2 as jF2
from muygpys_tpu.gp.deformation import Isotropy as jIso
from muygpys_tpu.gp.deformation import l2 as jl2
from muygpys_tpu.gp.hyperparameter import Parameter as jP
from muygpys_tpu.ops import kernels as jops
from muygpys_torch.gp import kernels as tk
from muygpys_torch.gp.deformation import F2, Isotropy, l2
from muygpys_torch.gp.hyperparameter import Parameter
from muygpys_torch.ops import kernels as tops

U = np.linspace(0.0, 4.0, 41)


@pytest.mark.parametrize(
    "name", ["rbf_fn", "matern_05_fn", "matern_15_fn", "matern_25_fn",
             "matern_inf_fn"],
)
def test_kernel_functions(name):
    np.testing.assert_allclose(
        getattr(tops, name)(torch.as_tensor(U)).numpy(),
        np.asarray(getattr(jops, name)(jnp.asarray(U))),
        rtol=1e-14, atol=0,
    )


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
def test_matern_functor(nu):
    dists = np.abs(np.random.default_rng(0).normal(size=(5, 6, 6)))
    jm = jk.Matern(
        smoothness=jP(nu), deformation=jIso(jl2, length_scale=jP(0.7))
    )
    tm = tk.Matern(
        smoothness=Parameter(nu),
        deformation=Isotropy(l2, length_scale=Parameter(0.7)),
    )
    np.testing.assert_allclose(
        tm(torch.as_tensor(dists)).numpy(), np.asarray(jm(jnp.asarray(dists))),
        rtol=1e-13,
    )
    assert tm.Kout() == float(jm.Kout())


def test_rbf_functor():
    d2 = np.abs(np.random.default_rng(1).normal(size=(4, 5)))
    jr = jk.RBF(deformation=jIso(jF2, length_scale=jP(1.3)))
    tr = tk.RBF(deformation=Isotropy(F2, length_scale=Parameter(1.3)))
    np.testing.assert_allclose(
        tr(torch.as_tensor(d2)).numpy(), np.asarray(jr(jnp.asarray(d2))),
        rtol=1e-13,
    )
    # default deformation is Isotropy(F2, 1.0), as in the JAX package
    assert tk.RBF().deformation.metric is F2


@pytest.mark.parametrize("nu", [0.31, 1.0, 1.2, 2.5, 4.8])
def test_matern_gen_fn(nu):
    """The exact Bessel path: values with k(0) = 1, and the gradients in the
    distances and in the smoothness, against the JAX package's."""
    import jax

    want = np.asarray(jops.matern_gen_fn(jnp.asarray(U), nu))
    d = torch.tensor(U, requires_grad=True)
    v = torch.tensor(nu, dtype=torch.float64, requires_grad=True)
    got = tops.matern_gen_fn(d, v)
    assert got[0] == 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10)
    w = np.cos(np.arange(U.size))
    (got * torch.as_tensor(w)).sum().backward()
    g_d, g_v = jax.grad(
        lambda dd, vv: jnp.sum(jops.matern_gen_fn(dd, vv) * w), argnums=(0, 1)
    )(jnp.asarray(U), jnp.float64(nu))
    # the zero distance is where JAX's and the port's guards sit: value 1,
    # gradient of the guarded branch
    np.testing.assert_allclose(d.grad.numpy()[1:], np.asarray(g_d)[1:], rtol=1e-9)
    np.testing.assert_allclose(float(v.grad), float(g_v), rtol=1e-9)
    # f32 follows its input
    assert tops.matern_gen_fn(torch.as_tensor(U, dtype=torch.float32), nu).dtype == torch.float32


@pytest.mark.parametrize("free", [False, True])
def test_matern_functor_general_smoothness(free):
    """A fixed non-closed-form smoothness and a free one go through
    matern_gen_fn, with the smoothness threaded as a keyword argument."""
    dists = np.abs(np.random.default_rng(3).normal(size=(4, 5, 5)))
    bounds = (0.1, 5.0) if free else "fixed"
    jm = jk.Matern(
        smoothness=jP(1.37, bounds), deformation=jIso(jl2, length_scale=jP(0.7))
    )
    tm = tk.Matern(
        smoothness=Parameter(1.37, bounds),
        deformation=Isotropy(l2, length_scale=Parameter(0.7)),
    )
    assert tm.get_opt_params()[0] == list(jm.get_opt_params()[0])
    assert tm.get_opt_params()[0] == (["smoothness"] if free else [])
    np.testing.assert_allclose(
        tm(torch.as_tensor(dists)).numpy(), np.asarray(jm(jnp.asarray(dists))),
        rtol=1e-10,
    )
    # a proposed value by name, for the smoothness and the length scale
    np.testing.assert_allclose(
        tm(torch.as_tensor(dists), smoothness=2.2, length_scale=0.4).numpy(),
        np.asarray(jm(jnp.asarray(dists), smoothness=2.2, length_scale=0.4)),
        rtol=1e-10,
    )
    # a free closed-form value still takes the general path, and agrees
    # with the closed form
    half = tk.Matern(smoothness=Parameter(1.5, (0.5, 2.5)))
    np.testing.assert_allclose(
        half(torch.as_tensor(dists)).numpy(),
        tops.matern_15_fn(torch.as_tensor(dists)).numpy(), rtol=1e-9,
    )


def test_general_smoothness_not_ported():
    """General smoothness IS ported for the functor (it builds and
    evaluates); what the fused kernel wrappers still refuse is a bare
    non-closed-form order: it goes in as "gen" with its coefficients."""
    from muygpys_torch.gpu.matern_nu import check_smoothness

    tk.Matern(smoothness=Parameter(1.37))
    tk.Matern(smoothness=Parameter(0.7, (0.1, 5.0)))
    with pytest.raises(ValueError, match="pass any other order as 'gen'"):
        check_smoothness("k", 1.37, None, 1, 73)
    with pytest.raises(ValueError, match="requires gen_coeffs"):
        check_smoothness("k", "gen", None, 1, 73)
    with pytest.raises(ValueError, match="requires the l2 metric"):
        check_smoothness("k", "gen", np.zeros(73), 2, 73)
    with pytest.raises(ValueError, match="needs 139 coefficients"):
        check_smoothness("k", "gen", np.zeros(73), 1, 139)
    assert check_smoothness("k", "gen", np.zeros(73), 1, 73) == 5


@pytest.mark.parametrize("nu", [1.5, 1.37, "free", "rbf"])
def test_kernel_of_scaled_dists(nu):
    """Every kernel evaluates already-scaled distances at its stored
    hyperparameters through one method: the call on raw distances with the
    length scale folded in."""
    ls = 0.6
    if nu == "rbf":
        kernel = tk.RBF(deformation=Isotropy(F2, length_scale=Parameter(ls)))
        scaled = lambda d: d / ls**2
    else:
        smoothness = Parameter(1.37, (0.3, 5.0)) if nu == "free" else Parameter(nu)
        kernel = tk.Matern(
            smoothness=smoothness,
            deformation=Isotropy(l2, length_scale=Parameter(ls)),
        )
        scaled = lambda d: d / ls
    dists = torch.as_tensor(
        np.random.default_rng(7).uniform(0.0, 2.0, size=(5, 6))
    )
    torch.testing.assert_close(
        kernel.of_scaled_dists(scaled(dists)), kernel(dists), rtol=1e-12,
        atol=1e-14,
    )
    with pytest.raises(NotImplementedError, match="of_scaled_dists"):
        tk.KernelFn(kernel.deformation).of_scaled_dists(dists)
