"""muygpys_torch.gp.deformation (metrics, Isotropy, Anisotropy) against
the JAX package (f64), including the pairwise / crosswise tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.gp import deformation as jd
from muygpys_tpu.gp.hyperparameter import Parameter as jP
from muygpys_tpu.gp.hyperparameter import VectorParameter as jV
from muygpys_torch.gp import deformation as td
from muygpys_torch.gp.hyperparameter import Parameter, VectorParameter


@pytest.fixture(scope="module")
def data(rng):
    x = rng.uniform(size=(50, 2))
    nn = np.stack([rng.choice(50, 6, replace=False) for _ in range(10)])
    bi = np.arange(10)
    return x, nn, bi


def _close(a, b):
    # the Gram identity leaves ~eps |x|^2 residues where a distance is 0,
    # which the l2 sqrt lifts to ~sqrt(eps) |x| ~ 1e-8 in either package
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-7)


@pytest.mark.parametrize("metric", ["l2", "F2"])
def test_isotropy(data, metric):
    x, nn, bi = data
    jdef = jd.Isotropy(getattr(jd, metric), length_scale=jP(0.6))
    tdef = td.Isotropy(getattr(td, metric), length_scale=Parameter(0.6))
    T, J = torch.as_tensor, jnp.asarray
    pw_t = tdef.pairwise_tensor(T(x), T(nn))
    pw_j = jdef.pairwise_tensor(J(x), J(nn))
    cw_t = tdef.crosswise_tensor(T(x), T(x), T(bi), T(nn))
    cw_j = jdef.crosswise_tensor(J(x), J(x), J(bi), J(nn))
    _close(pw_t, pw_j)
    _close(cw_t, cw_j)
    _close(tdef(pw_t), jdef(pw_j))
    _close(tdef(cw_t), jdef(cw_j))


@pytest.mark.parametrize("metric", ["l2", "F2"])
def test_anisotropy(data, metric):
    x, nn, bi = data
    jdef = jd.Anisotropy(getattr(jd, metric), jV(jP(0.4), jP(0.9)))
    tdef = td.Anisotropy(
        getattr(td, metric), VectorParameter(Parameter(0.4), Parameter(0.9))
    )
    T, J = torch.as_tensor, jnp.asarray
    pw_t = tdef.pairwise_tensor(T(x), T(nn))
    pw_j = jdef.pairwise_tensor(J(x), J(nn))
    cw_t = tdef.crosswise_tensor(T(x), T(x), T(bi), T(nn))
    cw_j = jdef.crosswise_tensor(J(x), J(x), J(bi), J(nn))
    assert pw_t.shape == (10, 6, 6, 2) and cw_t.shape == (10, 6, 2)
    _close(tdef(pw_t), jdef(pw_j))
    _close(tdef(cw_t), jdef(cw_j))
    np.testing.assert_array_equal(
        tdef.length_scale(), np.asarray(jdef.length_scale())
    )


def test_deformation_errors(data):
    x, nn, _ = data
    with pytest.raises(ValueError, match="Parameter"):
        td.Isotropy(td.l2, length_scale=0.5)
    with pytest.raises(ValueError, match="VectorParameter"):
        td.Anisotropy(td.l2, Parameter(0.5))
    tdef = td.Anisotropy(td.l2, VectorParameter(Parameter(0.4)))
    with pytest.raises(ValueError, match="final dimension"):
        tdef(td.l2.pairwise_differences(torch.as_tensor(x), torch.as_tensor(nn)))
