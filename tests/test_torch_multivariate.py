"""muygpys_torch.gp.MultivariateMuyGPS against muygpys_tpu's (f64): every
method on the same numpy inputs, the model built in each package from the
same numbers (the port's through convert.mmuygps_from_arrays), and the
DeprecationWarning.

Tolerance: rtol 1e-10, atol 1e-12 (atol 1e-9 on fast coefficients, and
on the fast means built from them, whose Gram-identity Kin rounds
differently in the two packages).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muygpys_torch.convert import arrays_from_mmuygps, mmuygps_from_arrays
from muygpys_torch.gp import MultivariateMuyGPS
from muygpys_torch.ops.tensors import fast_nn_update

CLOSE = dict(rtol=1e-10, atol=1e-12)
TRAIN, TEST, NN = 200, 30, 8
SPECS = [
    dict(length_scale=0.3, noise=1e-3, smoothness=1.5, scale="analytic"),
    dict(length_scale=0.2, noise=1e-2, smoothness=2.5, scale="analytic",
         scale_kwargs=dict(iteration_count=3)),
]


def _jax_mmuygps(specs, free=False):
    from muygpys_tpu.gp import MultivariateMuyGPS as JaxMM
    from muygpys_tpu.gp.deformation import Isotropy, l2
    from muygpys_tpu.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_tpu.gp.kernels import Matern
    from muygpys_tpu.gp.noise import HomoscedasticNoise

    args = []
    for i, s in enumerate(specs):
        bounds = (0.05, 1.0) if free and i == 1 else "fixed"
        args.append({
            "kernel": Matern(
                smoothness=Parameter(s["smoothness"]),
                deformation=Isotropy(
                    l2, length_scale=Parameter(s["length_scale"], bounds)
                ),
            ),
            "noise": HomoscedasticNoise(s["noise"]),
            "scale": AnalyticScale(**s.get("scale_kwargs", {})),
        })
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return JaxMM(*args)


def _port_mmuygps(specs, free=False):
    specs = [dict(s) for s in specs]
    if free:
        specs[1]["length_scale_bounds"] = (0.05, 1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return mmuygps_from_arrays(specs)


@pytest.fixture(scope="module")
def problem(rng):
    train = rng.uniform(size=(TRAIN, 2))
    test = rng.uniform(size=(TEST, 2))
    y = np.stack([
        np.sin(5 * train[:, 0]) + 0.05 * rng.standard_normal(TRAIN),
        np.cos(3 * train[:, 1]) * train[:, 0],
    ], axis=1)
    d = np.linalg.norm(train[:, None] - train[None], axis=-1)
    train_nn = np.argsort(d, axis=1)[:, 1:NN + 1]
    dt = np.linalg.norm(test[:, None] - train[None], axis=-1)
    test_nn = np.argsort(dt, axis=1)[:, :NN]
    return train, test, y, train_nn, test_nn


@pytest.fixture(scope="module")
def pair():
    return _jax_mmuygps(SPECS), _port_mmuygps(SPECS)


@pytest.fixture(scope="module")
def tensors(problem, pair):
    """(port, JAX) predict and train tensors of both models."""
    train, test, y, train_nn, test_nn = problem
    jm, tm = pair
    j_pred = jm.make_predict_tensors(
        np.arange(TEST), test_nn, jnp.asarray(test), jnp.asarray(train),
        jnp.asarray(y),
    )
    t_pred = tm.make_predict_tensors(
        torch.arange(TEST), torch.as_tensor(test_nn), torch.as_tensor(test),
        torch.as_tensor(train), torch.as_tensor(y),
    )
    batch = np.arange(0, TRAIN, 3)
    j_train = jm.make_train_tensors(
        batch, train_nn[batch], jnp.asarray(train), jnp.asarray(y)
    )
    t_train = tm.make_train_tensors(
        batch, train_nn[batch], torch.as_tensor(train), torch.as_tensor(y)
    )
    return t_pred, j_pred, t_train, j_train


def test_construction_warns_and_reads_back():
    with pytest.warns(DeprecationWarning, match="deprecated"):
        mm = mmuygps_from_arrays(SPECS)
    from muygpys_torch.gp.kernels import Matern

    with pytest.warns(DeprecationWarning, match="MultivariateMuyGPS"):
        MultivariateMuyGPS({"kernel": Matern()})
    assert len(mm.models) == 2
    back = arrays_from_mmuygps(mm)
    assert [b["smoothness"] for b in back] == [1.5, 2.5]
    assert [b["length_scale"] for b in back] == [0.3, 0.2]
    assert mm.models[1].scale.iteration_count == 3


def test_fixed_matches_jax():
    assert _port_mmuygps(SPECS).fixed() == _jax_mmuygps(SPECS).fixed() is True
    assert (_port_mmuygps(SPECS, free=True).fixed()
            == _jax_mmuygps(SPECS, free=True).fixed() is False)


def test_tensor_factories_match_jax(tensors):
    t_pred, j_pred, t_train, j_train = tensors
    for t, j in zip(t_pred + t_train, j_pred + j_train):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-7)  # Gram-identity distances
        assert tuple(t.shape) == np.asarray(j).shape


def test_posterior_mean_and_variance_match_jax(pair, tensors):
    jm, tm = pair
    (tc, tp, tnt), (jc, jp, jnt) = tensors[0], tensors[1]
    # both packages on the JAX distances, so only the solves are compared
    tc, tp = torch.as_tensor(np.array(jc)), torch.as_tensor(np.array(jp))
    mean = tm.posterior_mean(tp, tc, tnt)
    np.testing.assert_allclose(
        mean.numpy(), np.asarray(jm.posterior_mean(jp, jc, jnt)), **CLOSE
    )
    var = tm.posterior_variance(tp, tc)
    np.testing.assert_allclose(
        var.numpy(), np.asarray(jm.posterior_variance(jp, jc)), **CLOSE
    )
    assert mean.shape == var.shape == (TEST, 2)


def test_optimize_scale_matches_jax(tensors):
    jm, tm = _jax_mmuygps(SPECS), _port_mmuygps(SPECS)
    _, _, _, j_bnt = tensors[3]
    j_pw = tensors[3][1]
    tm.optimize_scale(torch.as_tensor(np.array(j_pw)),
                      torch.as_tensor(np.array(j_bnt)))
    jm.optimize_scale(j_pw, j_bnt)
    for t, j in zip(tm.models, jm.models):
        assert isinstance(t.scale(), float) and t.scale.trained
        np.testing.assert_allclose(t.scale(), float(np.asarray(j.scale())),
                                   **CLOSE)


def test_fast_coefficients_and_mean_match_jax(problem, pair):
    train, test, y, train_nn, test_nn = problem
    jm, tm = pair
    nn_fast = fast_nn_update(torch.as_tensor(train_nn))
    deformation = tm.models[0].kernel.deformation
    pw = deformation.pairwise_tensor(torch.as_tensor(train), nn_fast)
    jdef = jm.models[0].kernel.deformation
    jpw = jdef.pairwise_tensor(jnp.asarray(train), jnp.asarray(nn_fast))
    coeffs = tm.fast_coefficients(pw, torch.as_tensor(y)[nn_fast])
    jcoeffs = jm.fast_coefficients(jpw, jnp.asarray(y)[np.asarray(nn_fast)])
    assert coeffs.shape == (TRAIN, NN, 2)
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(jcoeffs),
                               rtol=1e-10, atol=1e-9)
    closest = test_nn[:, 0]
    cw = deformation.crosswise_tensor(
        torch.as_tensor(test), torch.as_tensor(train), torch.arange(TEST),
        nn_fast[closest],
    )
    jcw = jdef.crosswise_tensor(
        jnp.asarray(test), jnp.asarray(train), np.arange(TEST),
        np.asarray(nn_fast)[closest],
    )
    # the serve step on the JAX coefficients and distances: the contraction
    # alone
    mean = tm.fast_posterior_mean(
        torch.as_tensor(np.array(jcw)),
        torch.as_tensor(np.array(jcoeffs))[closest],
    )
    want = np.asarray(jm.fast_posterior_mean(jcw, jcoeffs[closest]))
    assert mean.shape == want.shape == (TEST, 2)
    np.testing.assert_allclose(mean.numpy(), want, **CLOSE)
    # end to end on the port's own tensors
    np.testing.assert_allclose(
        tm.fast_posterior_mean(cw, coeffs[closest]).numpy(), want,
        rtol=1e-9, atol=1e-9,
    )


def test_fast_multivariate_workflow_matches_jax(problem, pair):
    """``examples.fast_posterior_mean.make_fast_multivariate_regressor`` and
    the serve step through an exact NN_Wrapper against the JAX package's
    ``make_fast_multivariate_regressor`` and
    ``fast_posterior_mean_from_indices``."""
    from muygpys_tpu.examples.fast_posterior_mean import (
        make_fast_multivariate_regressor as jax_make,
    )
    from muygpys_tpu.examples.from_indices import (
        fast_posterior_mean_from_indices,
    )
    from muygpys_tpu.neighbors import NN_Wrapper as JaxNN
    from muygpys_torch.examples.fast_posterior_mean import (
        fast_posterior_mean_serve,
        make_fast_multivariate_regressor,
    )
    from muygpys_torch.neighbors import NN_Wrapper

    train, test, y, _, test_nn = problem
    jm, tm = pair
    jcoeffs, jnn = jax_make(jm, JaxNN(train, NN), train, y)
    closest = test_nn[:, 0]
    want = np.asarray(fast_posterior_mean_from_indices(
        jm, np.arange(TEST), jnn[closest], test, train, closest, jcoeffs))

    nbrs = NN_Wrapper(train, NN, device="cpu")
    coeffs, nn_fast = make_fast_multivariate_regressor(
        tm, nbrs, train, y, device="cpu")
    np.testing.assert_array_equal(nn_fast.numpy(), np.asarray(jnn))
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(jcoeffs),
                               rtol=1e-10, atol=1e-9)
    mean, near = fast_posterior_mean_serve(
        tm, nbrs, test, torch.as_tensor(train), nn_fast, coeffs)
    np.testing.assert_array_equal(near, closest)
    assert mean.shape == want.shape == (TEST, 2)
    np.testing.assert_allclose(mean.numpy(), want, rtol=1e-9, atol=1e-9)
