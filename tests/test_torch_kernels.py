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


def test_general_smoothness_not_ported():
    with pytest.raises(ValueError, match="general smoothness is not ported"):
        tk.Matern(smoothness=Parameter(1.37))
    with pytest.raises(ValueError, match="general smoothness is not ported"):
        tk.Matern(smoothness=Parameter(0.7, (0.1, 5.0)))
