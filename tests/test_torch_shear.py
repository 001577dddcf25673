"""The lensing shear family of the port against muygpys_tpu (f64): the block
functions of ops/shear.py, both kernel functors, ShearNoise33, the 5-D
homoscedastic perturbation and DifferenceIsotropy, at
tests/test_shear.py's tolerance (rtol 1e-10, atol 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.gp import deformation as jdef
from muygpys_tpu.gp.hyperparameter import Parameter as JParameter
from muygpys_tpu.gp.kernels import experimental as jexp
from muygpys_tpu.gp.noise import HomoscedasticNoise as JHomoscedastic
from muygpys_tpu.gp.noise import ShearNoise33 as JShearNoise33
from muygpys_tpu.ops import shear as js
from muygpys_torch.gp import deformation as tdef
from muygpys_torch.gp.hyperparameter import Parameter
from muygpys_torch.gp.kernels import experimental as texp
from muygpys_torch.gp.noise import HomoscedasticNoise, ShearNoise33
from muygpys_torch.ops import shear as ts

LS = 0.3
T, J = torch.as_tensor, jnp.asarray


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def diffs(rng):
    pts = rng.uniform(size=(40, 2))
    nn_idx = np.stack([rng.choice(40, 6, replace=False) for _ in range(5)])
    queries = rng.uniform(size=(5, 2))
    pw = pts[nn_idx][:, :, None, :] - pts[nn_idx][:, None, :, :]
    cw = queries[:, None, :] - pts[nn_idx]
    return pts, nn_idx, queries, pw, cw


BLOCK_FNS = ["shear_33_fn", "shear_Kin23_fn", "shear_Kcross23_fn"]


@pytest.mark.parametrize("name", BLOCK_FNS)
@pytest.mark.parametrize("which", ["pairwise", "crosswise"])
def test_block_functions_match_jax(diffs, name, which):
    _, _, _, pw, cw = diffs
    d = pw if which == "pairwise" else cw[:, :, None, :]
    got = getattr(ts, name)(T(d), length_scale=LS)
    want = getattr(js, name)(J(d), length_scale=LS)
    _close(got, want)
    rows = {"shear_33_fn": (3, 3), "shear_Kin23_fn": (2, 2),
            "shear_Kcross23_fn": (2, 3)}[name]
    if which == "pairwise":
        assert got.shape == (5, rows[0], 6, rows[1], 6)
    else:  # the unitary prediction axis is squeezed away
        assert got.shape == (5, rows[0], 6, rows[1])


def test_block_ingredients_match_jax(diffs):
    _, _, _, pw, _ = diffs
    got = ts._block_ingredients(T(pw), LS)
    want = js._block_ingredients(J(pw), LS)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _close(g, w)
    # every block is symmetric or antisymmetric-even in the differences, so
    # the pairwise image is symmetric term by term
    K = ts.shear_33_fn(T(pw), length_scale=LS).reshape(5, 18, 18)
    torch.testing.assert_close(K, K.transpose(1, 2), rtol=0, atol=0)


def test_assemble_squeezes_every_unit_axis():
    """jnp.squeeze drops EVERY size-1 axis: zero differences (1, 1, 2) give
    the (3, 3) prior, a crosswise (B, nn, 1, 2) gives (B, I, nn, O) -- and
    a batch of one loses its batch axis too, in both packages."""
    zero = np.zeros((1, 1, 2))
    _close(ts.shear_33_fn(T(zero), length_scale=LS),
           js.shear_33_fn(J(zero), length_scale=LS))
    assert ts.shear_33_fn(T(zero), length_scale=LS).shape == (3, 3)
    one = np.random.default_rng(0).normal(size=(1, 4, 1, 2))
    got = ts.shear_Kcross23_fn(T(one), length_scale=LS)
    assert got.shape == (2, 4, 3)
    _close(got, js.shear_Kcross23_fn(J(one), length_scale=LS))


def _pair(cls_name, ls=LS, bounds="fixed"):
    jk = getattr(jexp, cls_name)(deformation=jdef.DifferenceIsotropy(
        jdef.F2, length_scale=JParameter(ls, bounds)))
    tk = getattr(texp, cls_name)(deformation=tdef.DifferenceIsotropy(
        tdef.F2, length_scale=Parameter(ls, bounds)))
    return jk, tk


@pytest.mark.parametrize("cls_name", ["ShearKernel", "ShearKernel2in3out"])
def test_kernel_functors_match_jax(diffs, cls_name):
    _, _, _, pw, cw = diffs
    jk, tk = _pair(cls_name)
    _close(tk(T(pw)), jk(J(pw)))
    _close(tk(T(cw)), jk(J(cw)))  # the crosswise fix-up
    Kout = tk.Kout()
    assert Kout.shape == (3, 3) and Kout.dtype == torch.float64
    _close(Kout, jk.Kout())
    np.testing.assert_allclose(
        np.diag(Kout.numpy()), [2 / LS**2, 1 / LS**2, 1 / LS**2], rtol=1e-14
    )
    # a proposed length scale overrides the stored one
    _close(tk(T(pw), length_scale=0.2), jk(J(pw), length_scale=0.2))
    assert tk.get_opt_fn() == tk.__call__


def test_two_in_three_out_shapes_and_force_kcross(diffs):
    _, _, _, pw, cw = diffs
    jk, tk = _pair("ShearKernel2in3out")
    assert tk(T(pw)).shape == (5, 2, 6, 2, 6)
    assert tk(T(cw)).shape == (5, 2, 6, 3)
    # a square difference tensor is read as pairwise unless forced
    sq = cw[:, :, None, :] - cw[:, None, :, :]
    forced = tk(T(sq), force_Kcross=True)
    assert forced.shape == (5, 2, 6, 3, 6)
    _close(forced, jk(J(sq), force_Kcross=True))
    _close(tk(T(cw), adjust=False), jk(J(cw), adjust=False))


@pytest.mark.parametrize("cls_name", ["ShearKernel", "ShearKernel2in3out"])
def test_length_scale_gradient_matches_jax(diffs, cls_name):
    _, _, _, pw, cw = diffs
    jk, tk = _pair(cls_name, bounds=(0.05, 1.0))
    w_in = np.random.default_rng(1).normal(size=tuple(tk(T(pw)).shape))
    w_cr = np.random.default_rng(2).normal(size=tuple(tk(T(cw)).shape))

    def jf(ls):
        return (jnp.sum(jk(J(pw), length_scale=ls) * w_in)
                + jnp.sum(jk(J(cw), length_scale=ls) * w_cr))

    ls = torch.tensor(0.25, dtype=torch.float64, requires_grad=True)
    val = (torch.sum(tk(T(pw), length_scale=ls) * T(w_in))
           + torch.sum(tk(T(cw), length_scale=ls) * T(w_cr)))
    val.backward()
    v_ref, g_ref = jax.value_and_grad(jf)(0.25)
    np.testing.assert_allclose(float(val.detach()), float(v_ref), rtol=1e-10)
    np.testing.assert_allclose(float(ls.grad), float(g_ref), rtol=1e-9)
    assert tk.get_opt_params() == (["length_scale"], [LS], [(0.05, 1.0)])
    assert tk.get_opt_params()[0] == list(jk.get_opt_params()[0])


@pytest.mark.parametrize("cls_name", ["ShearKernel", "ShearKernel2in3out"])
def test_kernels_refuse_other_deformations(cls_name):
    cls = getattr(texp, cls_name)
    with pytest.raises(ValueError, match="difference isotropic"):
        cls(deformation=tdef.Isotropy(tdef.F2, length_scale=Parameter(1.0)))
    default = cls()
    assert isinstance(default.deformation, tdef.DifferenceIsotropy)
    assert default.deformation.metric.name == "F2"
    assert default.deformation.length_scale() == 1.0


def test_shear_noise33_matches_jax(rng):
    Kin = rng.normal(size=(2, 3, 4, 3, 4))
    jn, tn = JShearNoise33(0.25), ShearNoise33(0.25)
    _close(tn.perturb(T(Kin)), jn.perturb(J(Kin)))
    _close(tn.perturb(T(Kin), noise=0.4), jn.perturb(J(Kin), noise=0.4))
    diag = np.concatenate([0.5 * np.ones(4), 0.25 * np.ones(8)])
    _close(tn.perturb(T(Kin)),
           (Kin.reshape(2, 12, 12) + np.diag(diag)).reshape(Kin.shape))
    # it stays a named, trainable homoscedastic parameter
    free = ShearNoise33(1e-3, (1e-5, 1e-1))
    names, params, bounds = [], [], []
    free.append_lists(names, params, bounds)
    assert (names, params, bounds) == (["noise"], [1e-3], [(1e-5, 1e-1)])
    # the proposed noise reaches the solve through perturb_fn, under autograd
    noise = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    torch.sum(free.perturb_fn(lambda K: K)(T(Kin), noise=noise)).backward()
    assert float(noise.grad) == 2 * (2 * 4 + 2 * 4)


@pytest.mark.parametrize(
    "shape", [(2, 2, 4, 2, 4), (2, 12, 12), (2, 3, 4, 2, 4)]
)
def test_shear_noise33_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match=r"requires \(b, 3, nn, 3, nn\)"):
        ShearNoise33(0.1).perturb(torch.zeros(shape))


def test_homoscedastic_5d_matches_jax(rng):
    Kin = rng.normal(size=(4, 3, 5, 3, 5))
    _close(HomoscedasticNoise(0.5).perturb(T(Kin)),
           JHomoscedastic(0.5).perturb(J(Kin)))
    _close(HomoscedasticNoise(0.5).perturb(T(Kin)),
           (Kin.reshape(4, 15, 15) + 0.5 * np.eye(15)).reshape(Kin.shape))


def test_difference_isotropy_matches_jax(diffs):
    pts, nn_idx, queries, pw, cw = diffs
    jd = jdef.DifferenceIsotropy(jdef.F2, length_scale=JParameter(LS))
    td = tdef.DifferenceIsotropy(tdef.F2, length_scale=Parameter(LS))
    assert isinstance(td, tdef.Isotropy)
    got_pw = td.pairwise_tensor(T(pts), T(nn_idx))
    got_cw = td.crosswise_tensor(T(queries), T(pts), torch.arange(5), T(nn_idx))
    _close(got_pw, jd.pairwise_tensor(J(pts), nn_idx))
    _close(got_cw, jd.crosswise_tensor(J(queries), J(pts), np.arange(5), nn_idx))
    _close(got_pw, pw)
    _close(got_cw, cw)
    # the call collapses differences scaled by the length scale
    _close(td(got_pw), jd(J(pw)))
    _close(td(got_pw, length_scale=0.7), jd(J(pw), length_scale=0.7))
