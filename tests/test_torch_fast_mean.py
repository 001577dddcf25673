"""The fast posterior mean of muygpys_torch against muygpys_tpu (f64): the
tensor and solve ops, the squeeze cases, MuyGPS.fast_coefficients /
fast_posterior_mean, a failed factorization, and the whole workflow
(examples.fast_posterior_mean) through an exact NN_Wrapper.

Tolerance: rtol 1e-10 (atol 1e-12) on coefficients and means; atol 1e-9
on coefficients solved from each package's own Gram-identity Kin; index
and difference tensors exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_models import carried, jax_model

from muygpys_tpu.ops import solve as jsolve
from muygpys_tpu.ops import tensors as jt
from muygpys_torch.gp import tensors as gp_tensors
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.ops import solve as tsolve
from muygpys_torch.ops import tensors as tt

CLOSE = dict(rtol=1e-10, atol=1e-12)
TRAIN, TEST, NN = 300, 40, 10


@pytest.fixture(scope="module")
def problem(rng):
    train = rng.uniform(size=(TRAIN, 2))
    test = rng.uniform(size=(TEST, 2))
    y = (np.sin(6 * train[:, 0]) * np.cos(4 * train[:, 1])
         + 0.05 * rng.standard_normal(TRAIN))[:, None]
    y2 = np.concatenate([y, np.cos(5 * train[:, :1]) * train[:, 1:]], 1)
    d = np.linalg.norm(train[:, None] - train[None], axis=-1)
    train_nn = np.argsort(d, axis=1)[:, 1:NN + 1]  # self dropped
    return train, test, y, y2, train_nn


@pytest.fixture(scope="module")
def models():
    jm = jax_model(nu=1.5, ls=0.3, noise=1e-3, scale=1.0)
    return jm, carried(jm)


@pytest.fixture(scope="module")
def jax_fast(problem, models):
    """The JAX package's coefficients and fast means, computed once."""
    train, test, y, y2, train_nn = problem
    jm, _ = models
    nn_fast = jt.fast_nn_update(jnp.asarray(train_nn))
    pw = jm.kernel.deformation.pairwise_tensor(jnp.asarray(train), nn_fast)
    Kin = jm.kernel(pw)
    coeffs = jm.fast_coefficients(Kin, jnp.asarray(y)[nn_fast])
    coeffs2 = jm.fast_coefficients(Kin, jnp.asarray(y2)[nn_fast])
    closest = np.argsort(
        np.linalg.norm(test[:, None] - train[None], axis=-1), axis=1
    )[:, 0]
    closest_set = np.asarray(nn_fast)[closest]
    cw = jm.kernel.deformation.crosswise_tensor(
        jnp.asarray(test), jnp.asarray(train), np.arange(TEST), closest_set
    )
    Kcross = jm.kernel(cw)
    mean = jm.fast_posterior_mean(Kcross, coeffs[closest])
    mean2 = jm.fast_posterior_mean(Kcross, coeffs2[closest])
    return dict(
        nn_fast=np.array(nn_fast), Kin=np.array(Kin),
        coeffs=np.array(coeffs), coeffs2=np.array(coeffs2),
        closest=closest, closest_set=closest_set, Kcross=np.array(Kcross),
        mean=np.array(mean), mean2=np.array(mean2),
    )


def test_fast_tensor_ops_match_jax(problem, jax_fast):
    train, test, y, _, train_nn = problem
    nn_t = tt.fast_nn_update(torch.as_tensor(train_nn))
    np.testing.assert_array_equal(nn_t.numpy(), jax_fast["nn_fast"])
    assert nn_t.dtype == torch.int64
    assert torch.equal(nn_t[:, 0], torch.arange(TRAIN))
    pw_t, nt_t = tt.make_fast_predict_tensors(
        torch.as_tensor(train_nn), torch.as_tensor(train), torch.as_tensor(y)
    )
    pw_j, nt_j = jt.make_fast_predict_tensors(
        jnp.asarray(train_nn), jnp.asarray(train), jnp.asarray(y)
    )
    np.testing.assert_array_equal(pw_t.numpy(), np.asarray(pw_j))
    np.testing.assert_array_equal(nt_t.numpy(), np.asarray(nt_j))
    assert pw_t.shape == (TRAIN, NN, NN, 2)
    idx = np.arange(0, TRAIN, 7)
    for fn in (tt.batch_features_tensor, gp_tensors.batch_features_tensor):
        np.testing.assert_array_equal(
            fn(torch.as_tensor(train), torch.as_tensor(idx)).numpy(),
            np.asarray(jt.batch_features_tensor(jnp.asarray(train), idx)),
        )
    np.testing.assert_array_equal(  # a 1-D feature gains its axis
        tt.batch_features_tensor(torch.as_tensor(train[:, 0]), idx).numpy(),
        np.asarray(jt.batch_features_tensor(jnp.asarray(train[:, 0]), idx)),
    )
    assert gp_tensors.fast_nn_update is tt.fast_nn_update
    assert gp_tensors.make_fast_predict_tensors is tt.make_fast_predict_tensors


@pytest.mark.parametrize("shape", [(7,), (7, 2), (3, 7, 2)])
def test_point_set_differences_match_jax(rng, shape):
    pts = rng.standard_normal(shape)
    np.testing.assert_array_equal(
        tt.pairwise_differences(torch.as_tensor(pts)).numpy(),
        np.asarray(jt.pairwise_differences(jnp.asarray(pts))),
    )
    if len(shape) < 3:
        loc = rng.standard_normal((4,) + shape[1:])
        np.testing.assert_array_equal(
            tt.crosswise_differences(
                torch.as_tensor(loc), torch.as_tensor(pts)
            ).numpy(),
            np.asarray(jt.crosswise_differences(
                jnp.asarray(loc), jnp.asarray(pts)
            )),
        )


def test_pairwise_differences_rejects_four_axes():
    with pytest.raises(ValueError, match="not supported"):
        tt.pairwise_differences(torch.zeros((2, 2, 2, 2)))


def test_solve_ops_match_jax(rng, jax_fast, problem):
    _, _, y, y2, _ = problem
    nn_fast = jax_fast["nn_fast"]
    Kin = jax_fast["Kin"] + 1e-3 * np.eye(NN)
    for targets in (y[nn_fast][:, :, 0], y[nn_fast], y2[nn_fast]):
        np.testing.assert_allclose(
            tsolve.fast_posterior_mean_precompute(
                torch.as_tensor(Kin), torch.as_tensor(targets)
            ).numpy(),
            np.asarray(jsolve.fast_posterior_mean_precompute(
                jnp.asarray(Kin), jnp.asarray(targets)
            )),
            **CLOSE,
        )
    Kcross = jax_fast["Kcross"]
    for coeffs in (jax_fast["coeffs"], jax_fast["coeffs2"]):
        c = coeffs[jax_fast["closest"]]
        np.testing.assert_allclose(
            tsolve.fast_posterior_mean(
                torch.as_tensor(Kcross), torch.as_tensor(c)
            ).numpy(),
            np.asarray(jsolve.fast_posterior_mean(
                jnp.asarray(Kcross), jnp.asarray(c)
            )),
            **CLOSE,
        )
    Kc3 = rng.standard_normal((TEST, NN, 2))
    c3 = rng.standard_normal((TEST, NN, 2))
    out = tsolve.mmuygps_fast_posterior_mean(
        torch.as_tensor(Kc3), torch.as_tensor(c3)
    )
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(jsolve.mmuygps_fast_posterior_mean(
            jnp.asarray(Kc3), jnp.asarray(c3)
        )),
        **CLOSE,
    )
    assert out.shape == (TEST, 2)


@pytest.mark.parametrize(
    "kc_shape,c_shape",
    [((1, 5), (1, 5)), ((1, 5), (1, 5, 3)), ((4, 5), (4, 5, 1)),
     ((1, 5), (1, 5, 1)), ((4, 5), (4, 5))],
)
def test_fast_mean_squeezes_every_unit_axis(rng, kc_shape, c_shape):
    """``jnp.squeeze`` drops every unit axis: one query gives a 0-d mean
    (one response) or ``(r,)``; one response gives ``(b,)``."""
    Kc = rng.standard_normal(kc_shape)
    c = rng.standard_normal(c_shape)
    got = tsolve.fast_posterior_mean(torch.as_tensor(Kc), torch.as_tensor(c))
    want = np.asarray(jsolve.fast_posterior_mean(jnp.asarray(Kc),
                                                 jnp.asarray(c)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CLOSE)


@pytest.mark.parametrize(
    "batch,r", [(1, None), (1, 1), (1, 3), (4, 1), (4, None)]
)
def test_precompute_squeezes_every_unit_axis(rng, batch, r):
    """A batch of one neighborhood gives ``(n,)`` coefficients (or
    ``(n, r)``); one response column gives ``(b, n)``."""
    A = rng.standard_normal((batch, 5, 5))
    Kin = A @ A.transpose(0, 2, 1) + 5 * np.eye(5)
    y = rng.standard_normal((batch, 5) if r is None else (batch, 5, r))
    got = tsolve.fast_posterior_mean_precompute(
        torch.as_tensor(Kin), torch.as_tensor(y)
    )
    want = np.asarray(jsolve.fast_posterior_mean_precompute(
        jnp.asarray(Kin), jnp.asarray(y)
    ))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CLOSE)


def test_model_fast_methods_match_jax(problem, models, jax_fast):
    train, test, y, y2, train_nn = problem
    _, tm = models
    nn_fast = tt.fast_nn_update(torch.as_tensor(train_nn))
    pw = tm.kernel.deformation.pairwise_tensor(torch.as_tensor(train), nn_fast)
    Kin = tm.kernel(pw)
    np.testing.assert_allclose(Kin.numpy(), jax_fast["Kin"], rtol=1e-10,
                               atol=1e-7)  # Gram-identity distance floor
    for targets, key in ((y, "coeffs"), (y2, "coeffs2")):
        coeffs = tm.fast_coefficients(
            torch.as_tensor(jax_fast["Kin"]), torch.as_tensor(targets)[nn_fast]
        )
        np.testing.assert_allclose(coeffs.numpy(), jax_fast[key], **CLOSE)
        mean = tm.fast_posterior_mean(
            torch.as_tensor(jax_fast["Kcross"]),
            coeffs[torch.as_tensor(jax_fast["closest"])],
        )
        np.testing.assert_allclose(
            mean.numpy(), jax_fast["mean" if key == "coeffs" else "mean2"],
            **CLOSE,
        )
    assert jax_fast["mean"].shape == (TEST,)
    assert jax_fast["mean2"].shape == (TEST, 2)


def test_failed_factorization_gives_nan_coefficients(rng, models):
    """A neighborhood that is not positive definite gets NaN coefficients
    in both packages, the others their values, and nothing raises."""
    jm, tm = models
    A = rng.standard_normal((4, 6, 6))
    Kin = A @ A.transpose(0, 2, 1) + 6 * np.eye(6)
    Kin[2] = -np.eye(6)  # -I + nugget: not positive definite
    y = rng.standard_normal((4, 6))
    got = tm.fast_coefficients(torch.as_tensor(Kin), torch.as_tensor(y))
    want = np.asarray(jm.fast_coefficients(jnp.asarray(Kin), jnp.asarray(y)))
    assert np.isnan(want[2]).all() and np.isnan(got[2].numpy()).all()
    keep = [0, 1, 3]
    assert np.isfinite(got[keep].numpy()).all()
    np.testing.assert_allclose(got[keep].numpy(), want[keep], **CLOSE)


def test_fast_workflow_through_nn_wrapper_matches_jax(problem, models):
    """``examples.fast_posterior_mean``: ``make_fast_regressor`` (train-side
    neighbours -> self-inclusive sets -> the deformation's pairwise tensor
    -> coefficients) and ``fast_posterior_mean_serve`` (query neighbours ->
    the closest point's set -> crosswise tensor -> fast mean), against
    ``muygpys_tpu.examples.fast_posterior_mean.fast_posterior_mean_any``
    (fast_nn_update applied once in both)."""
    from muygpys_tpu.examples.fast_posterior_mean import (
        fast_posterior_mean_any,
    )
    from muygpys_tpu.neighbors import NN_Wrapper as JaxNN
    from muygpys_torch.examples.fast_posterior_mean import (
        fast_posterior_mean_serve,
        make_fast_regressor,
    )

    train, test, y, _, train_nn = problem
    jm, tm = models
    want, want_coeffs, _ = fast_posterior_mean_any(
        jm, test, train, JaxNN(train, NN), y
    )

    nbrs = NN_Wrapper(train, NN, device="cpu")
    coeffs, nn_fast = make_fast_regressor(tm, nbrs, train, y, device="cpu")
    assert coeffs.device.type == "cpu" and coeffs.shape == (TRAIN, NN)
    np.testing.assert_array_equal(
        np.sort(nn_fast[:, 1:].numpy(), 1), np.sort(train_nn[:, :-1], 1))
    mean, closest = fast_posterior_mean_serve(
        tm, nbrs, test, torch.as_tensor(train), nn_fast, coeffs
    )
    # each package's own Gram-identity Kin: their f64 rounding differs,
    # and the solve multiplies that by the conditioning (3.3e-11 measured)
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(want_coeffs),
                               rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(mean.numpy(), want, **CLOSE)
    assert mean.shape == (TEST,) and np.isfinite(mean.numpy()).all()
    np.testing.assert_array_equal(
        closest, np.argmin(np.linalg.norm(
            test[:, None] - train[None], axis=-1), axis=1))
    # tensors stay on their device; the serve step takes tensor queries
    coeffs_t, _ = make_fast_regressor(tm, nbrs, torch.as_tensor(train),
                                      torch.as_tensor(y))
    assert torch.equal(coeffs_t, coeffs)
    mean_t, _ = fast_posterior_mean_serve(
        tm, nbrs, torch.as_tensor(test), train, nn_fast, coeffs)
    assert torch.equal(mean_t, mean)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_fast_workflow_places_host_arrays_on_the_card(problem, models):
    """Numpy features go on the card unless the caller passes
    ``device="cpu"``: without one, the precompute raises instead of falling
    back to the CPU."""
    from muygpys_torch.examples.fast_posterior_mean import (
        make_fast_regressor,
    )

    train, _, y, _, _ = problem
    nbrs = NN_Wrapper(train, NN, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fast_regressor(models[1], nbrs, train, y)
