"""muygpys_torch.examples against muygpys_tpu.examples (mirrors
tests/test_examples.py), f64 on the CPU.

The sine data lie on a grid, where a query's neighbors at equal distances
are ties: each package's exact search resolves them by the rounding of its
own Gram identity, so the regression workflows here share one host index
(``nn_method="sklearn"``, deterministic on equal inputs) and hold the
workflow, not the tie-breaking, to JAX.  The half-moon data have no ties
and use the default exact search.
"""

import warnings

import numpy as np
import pytest

import muygpys_tpu.examples.classify as jax_classify
import muygpys_tpu.examples.regress as jax_regress
import muygpys_tpu.examples.two_class_classify_uq as jax_uq
import muygpys_tpu.gp.deformation as jdef
import muygpys_tpu.gp.hyperparameter as jhyp
import muygpys_tpu.gp.kernels as jker
import muygpys_tpu.gp.noise as jnoise
import muygpys_tpu.optimize as jopt
import muygpys_torch.gp.deformation as tdef
import muygpys_torch.gp.hyperparameter as thyp
import muygpys_torch.gp.kernels as tker
import muygpys_torch.gp.noise as tnoise
import muygpys_torch.optimize as topt
from muygpys_torch.examples import classify, regress, two_class_classify_uq
from muygpys_torch.examples.from_indices import (
    fast_posterior_mean_from_indices,
    optimize_from_indices,
    posterior_variance_from_indices,
)

from test_examples import _sine_data, _two_class_data

SK = {"nn_method": "sklearn"}


def _matern_kwargs(pkg, ls=1.0, ls_bounds="fixed", noise_bounds="fixed"):
    d, h, k, n = pkg
    return {
        "kernel": k.Matern(
            smoothness=h.Parameter(1.5),
            deformation=d.Isotropy(d.l2, length_scale=h.Parameter(
                ls, ls_bounds)),
        ),
        "noise": n.HomoscedasticNoise(1e-2, noise_bounds),
        "scale": h.AnalyticScale(),
    }


def _rbf_kwargs(pkg):
    d, h, k, n = pkg
    return {
        "kernel": k.RBF(deformation=d.Isotropy(
            d.F2, length_scale=h.Parameter(0.5, (0.05, 2.0)))),
        "noise": n.HomoscedasticNoise(1e-3),
    }


JAX = (jdef, jhyp, jker, jnoise)
PORT = (tdef, thyp, tker, tnoise)


@pytest.fixture(scope="module")
def sine():
    return _sine_data(np.random.default_rng(0))


@pytest.fixture(scope="module")
def moons():
    return _two_class_data(np.random.default_rng(7))


def test_do_regress_fixed(sine):
    xtr, ytr, xte, yte = sine
    ref = jax_regress.do_regress(
        xte, xtr, ytr, nn_count=30, nn_kwargs=SK,
        k_kwargs=_matern_kwargs(JAX), rng=np.random.default_rng(1),
    )
    model, nbrs, mean, var = regress.do_regress(
        xte, xtr, ytr, nn_count=30, nn_kwargs=SK,
        k_kwargs=_matern_kwargs(PORT), rng=np.random.default_rng(1),
        device="cpu",
    )
    assert isinstance(mean, np.ndarray) and mean.shape == (len(xte), 1)
    np.testing.assert_allclose(mean, ref[2], rtol=0, atol=1e-8)
    np.testing.assert_allclose(var, ref[3], rtol=0, atol=1e-8)
    assert np.mean((mean[:, 0] - yte) ** 2) < 0.01
    assert model.scale.trained
    assert nbrs.nn_method == "sklearn"


def test_do_regress_optimized(sine):
    """L_BFGS_B_optimize on the full batch: JAX's parameters within 1e-5."""
    xtr, ytr, xte, yte = sine
    kw = dict(nn_count=30, batch_count=400, nn_kwargs=SK)
    ref = jax_regress.do_regress(
        xte, xtr, ytr, opt_fn=jopt.L_BFGS_B_optimize, loss_fn=jopt.lool_fn,
        k_kwargs=_matern_kwargs(JAX, 2.0, (0.1, 10.0), (1e-4, 1e-1)),
        rng=np.random.default_rng(1), **kw,
    )
    model, _, mean, _ = regress.do_regress(
        xte, xtr, ytr, opt_fn=topt.L_BFGS_B_optimize, loss_fn=topt.lool_fn,
        k_kwargs=_matern_kwargs(PORT, 2.0, (0.1, 10.0), (1e-4, 1e-1)),
        rng=np.random.default_rng(1), device="cpu", **kw,
    )
    np.testing.assert_allclose(model.get_opt_params()[1],
                               ref[0].get_opt_params()[1], rtol=1e-5)
    assert np.mean((mean[:, 0] - yte) ** 2) < 0.02


def test_do_regress_bayes(sine):
    """The default chassis, Bayes_optimize, with one random_state: JAX's
    parameters and predictions."""
    xtr, ytr, xte, _ = sine
    kw = dict(nn_count=30, batch_count=150, nn_kwargs=SK,
              opt_kwargs={"init_points": 3, "n_iter": 4, "random_state": 2})
    ref = jax_regress.do_regress(
        xte, xtr, ytr, k_kwargs=_matern_kwargs(JAX, 2.0, (0.1, 10.0)),
        rng=np.random.default_rng(5), **kw,
    )
    model, _, mean, var = regress.do_regress(
        xte, xtr, ytr, k_kwargs=_matern_kwargs(PORT, 2.0, (0.1, 10.0)),
        rng=np.random.default_rng(5), device="cpu", **kw,
    )
    np.testing.assert_allclose(model.get_opt_params()[1],
                               ref[0].get_opt_params()[1], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(mean, ref[2], rtol=0, atol=1e-8)
    np.testing.assert_allclose(var, ref[3], rtol=0, atol=1e-8)


def test_do_regress_multivariate(sine):
    xtr, ytr, xte, yte = sine
    ytr2 = np.concatenate([ytr, np.cos(xtr)], axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = jax_regress.do_regress(
            xte, xtr, ytr2, nn_count=30, nn_kwargs=SK,
            k_kwargs=[_matern_kwargs(JAX) for _ in range(2)],
            rng=np.random.default_rng(1),
        )
    with pytest.warns(DeprecationWarning):
        _, _, mean, var = regress.do_regress(
            xte, xtr, ytr2, nn_count=30, nn_kwargs=SK,
            k_kwargs=[_matern_kwargs(PORT) for _ in range(2)],
            rng=np.random.default_rng(1), device="cpu",
        )
    assert mean.shape == var.shape == (len(xte), 2)
    np.testing.assert_allclose(mean, ref[2], rtol=0, atol=1e-8)
    np.testing.assert_allclose(var, ref[3], rtol=0, atol=1e-8)
    assert np.mean((mean[:, 1] - np.cos(xte[:, 0])) ** 2) < 0.02


def test_exact_search_differs_from_jax_only_among_ties(sine):
    """On the sine grid the default exact search gives JAX's distances;
    where the index sets differ, the distances at the differing slots are
    equal (ties)."""
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_tpu.neighbors import NN_Wrapper as JaxNN

    xtr, _, xte, _ = sine
    i_t, d_t = NN_Wrapper(xtr, 30, device="cpu").get_nns(xte)
    i_j, d_j = JaxNN(xtr, 30).get_nns(xte)
    np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-12, atol=1e-14)
    assert (i_t == np.asarray(i_j)).mean() > 0.9


def test_do_classify(moons):
    xtr, ytr, xte, yte = moons
    kw = dict(nn_count=20,
              opt_kwargs={"init_points": 3, "n_iter": 5, "random_state": 0})
    ref = jax_classify.do_classify(xte, xtr, ytr, k_kwargs=_rbf_kwargs(JAX),
                                   rng=np.random.default_rng(3), **kw)
    model, _, preds = classify.do_classify(
        xte, xtr, ytr, k_kwargs=_rbf_kwargs(PORT),
        rng=np.random.default_rng(3), device="cpu", **kw,
    )
    np.testing.assert_allclose(model.get_opt_params()[1],
                               ref[0].get_opt_params()[1], rtol=0, atol=1e-8)
    np.testing.assert_allclose(preds, ref[2], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(np.argmax(preds, 1), np.argmax(ref[2], 1))
    assert np.mean(np.argmax(preds, 1) == np.argmax(yte, 1)) > 0.85


def test_do_classify_uq(moons):
    """The same cutoffs (1999-value grid search) and masks as JAX."""
    xtr, ytr, xte, yte = moons
    kw = dict(nn_count=20, opt_batch_count=150, uq_batch_count=300,
              opt_kwargs={"init_points": 3, "n_iter": 5, "random_state": 0})
    ref = jax_uq.do_classify_uq(xte, xtr, ytr, k_kwargs=_rbf_kwargs(JAX),
                                rng=np.random.default_rng(11), **kw)
    model, nbrs, preds, masks = two_class_classify_uq.do_classify_uq(
        xte, xtr, ytr, k_kwargs=_rbf_kwargs(PORT),
        rng=np.random.default_rng(11), device="cpu", **kw,
    )
    assert masks.shape == (5, len(xte))
    np.testing.assert_allclose(preds, ref[2], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(masks, ref[3])
    accuracy, uq = two_class_classify_uq.do_uq(preds, yte, masks)
    assert (accuracy, uq.tolist()) == (
        jax_uq.do_uq(ref[2], yte, ref[3])[0],
        jax_uq.do_uq(ref[2], yte, ref[3])[1].tolist(),
    )
    assert accuracy > 0.85
    # the cutoffs themselves, on one calibration batch
    labels = 2 * np.argmax(ytr, axis=1) - 1
    bi, bnn = topt.get_balanced_batch(nbrs, labels, 300,
                                      rng=np.random.default_rng(2))
    cut = two_class_classify_uq.train_two_class_interval(
        model, bi, bnn, xtr, ytr, labels,
        two_class_classify_uq.example_lambdas, device="cpu",
    )
    jcut = jax_uq.train_two_class_interval(
        ref[0], bi, bnn, xtr, ytr, labels, jax_uq.example_lambdas,
    )
    np.testing.assert_array_equal(cut, jcut)
    np.testing.assert_array_equal(
        two_class_classify_uq.make_masks(preds, cut, np.ones(len(xte)), 0.0),
        jax_uq.make_masks(ref[2], jcut, np.ones(len(xte)), 0.0),
    )


def test_from_indices_glue(sine):
    """The index glue the workflows do not call: variance alone, the fast
    mean against precomputed coefficients, the optimize entry point."""
    import jax.numpy as jnp
    import torch

    import muygpys_tpu.examples.from_indices as jax_glue

    from muygpys_tpu.gp import MuyGPS as JaxMuyGPS

    from muygpys_torch.gp import MuyGPS

    xtr, ytr, xte, _ = sine

    jm = JaxMuyGPS(**_matern_kwargs(JAX))
    tm = MuyGPS(**_matern_kwargs(PORT))
    idx = np.arange(20)
    nn = np.stack([(np.arange(8) + 3 * i) % len(xtr) for i in range(20)])
    np.testing.assert_allclose(
        posterior_variance_from_indices(tm, idx, nn, xte, xtr, ytr,
                                        device="cpu").numpy(),
        np.asarray(jax_glue.posterior_variance_from_indices(
            jm, idx, nn, xte, xtr, ytr)), rtol=1e-10,
    )
    coeffs = np.random.default_rng(0).standard_normal((len(xtr), 8, 1))
    closest = np.arange(20) % 7
    np.testing.assert_allclose(
        fast_posterior_mean_from_indices(
            tm, idx, nn, xte, xtr, closest, torch.as_tensor(coeffs),
            device="cpu").numpy(),
        np.asarray(jax_glue.fast_posterior_mean_from_indices(
            jm, idx, nn, xte, xtr, closest, jnp.asarray(coeffs))),
        rtol=1e-10,
    )
    bounded = dict(_matern_kwargs(PORT, 2.0, (0.1, 10.0)))
    jbounded = dict(_matern_kwargs(JAX, 2.0, (0.1, 10.0)))
    opt_kw = dict(init_points=2, n_iter=2, random_state=1)
    port = optimize_from_indices(MuyGPS(**bounded), idx, nn, xtr, ytr,
                                 device="cpu", **opt_kw)
    ref = jax_glue.optimize_from_indices(JaxMuyGPS(**jbounded), idx, nn,
                                         xtr, ytr, **opt_kw)
    np.testing.assert_allclose(port.get_opt_params()[1],
                               ref.get_opt_params()[1], rtol=0, atol=1e-8)


# --- the fast-mean workflows (tests/test_examples.py:181,
# tests/test_multivariate.py:77) ---


def test_do_fast_posterior_mean(sine):
    """The whole workflow (Bayes_optimize, lool) on a fixed model over one
    shared index: JAX's means, its bar and its four timing keys."""
    from muygpys_tpu.examples import fast_posterior_mean as jfast
    from muygpys_torch.examples import fast_posterior_mean as tfast

    xtr, ytr, xte, yte = sine
    ref = jfast.do_fast_posterior_mean(
        xte, xtr, ytr, nn_count=30, nn_kwargs=SK,
        k_kwargs=_matern_kwargs(JAX),
    )
    model, nbrs, mean, coeffs, timing = tfast.do_fast_posterior_mean(
        xte, xtr, ytr, nn_count=30, nn_kwargs=SK,
        k_kwargs=_matern_kwargs(PORT), device="cpu",
    )
    assert isinstance(mean, np.ndarray) and mean.shape == ref[2].shape
    np.testing.assert_allclose(mean, ref[2], rtol=0, atol=1e-8)
    # each package assembles the grid's distances by its own Gram rounding
    # (centred in the port), so coefficients agree to the largest one's
    c_ref = np.asarray(ref[3])
    np.testing.assert_allclose(coeffs.numpy(), c_ref, rtol=0,
                               atol=1e-8 * np.abs(c_ref).max())
    assert np.mean((mean.reshape(-1) - yte) ** 2) < 0.02
    assert set(timing) == {"precompute", "agree", "nn", "pred"}
    assert timing["agree"] == 0.0 and min(timing.values()) >= 0.0
    assert nbrs.nn_method == "sklearn"


def test_fast_posterior_mean_any_multivariate():
    """A MultivariateMuyGPS through ``fast_posterior_mean_any`` on JAX's
    multivariate problem: JAX's means and coefficients."""
    from muygpys_tpu.examples import fast_posterior_mean as jfast
    from muygpys_tpu.gp import MultivariateMuyGPS as JM
    from muygpys_tpu.neighbors import NN_Wrapper as JaxNN
    from muygpys_torch.examples import fast_posterior_mean as tfast
    from muygpys_torch.gp import MultivariateMuyGPS as TM
    from muygpys_torch.neighbors import NN_Wrapper

    rng = np.random.default_rng(3)
    train = rng.uniform(size=(150, 3))
    test = rng.uniform(size=(40, 3))
    y = rng.standard_normal((150, 2))

    def args(pkg, nu):
        d, h, k, n = pkg
        return {
            "kernel": k.Matern(smoothness=h.Parameter(nu), deformation=d.Isotropy(
                d.l2, length_scale=h.Parameter(0.4))),
            "noise": n.HomoscedasticNoise(1e-4),
            "scale": h.AnalyticScale(),
        }

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jm = JM(args(JAX, 1.5), args(JAX, 2.5))
        tm = TM(args(PORT, 1.5), args(PORT, 2.5))
    m0, c0, _ = jfast.fast_posterior_mean_any(
        jm, test, train, JaxNN(train, 12), y
    )
    mean, coeffs, timing = tfast.fast_posterior_mean_any(
        tm, test, train, NN_Wrapper(train, 12, device="cpu"), y,
        device="cpu",
    )
    assert mean.shape == (40, 2) and coeffs.shape == (150, 12, 2)
    np.testing.assert_allclose(mean, np.asarray(m0), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(c0), rtol=1e-8,
                               atol=1e-10)
    assert set(timing) == {"precompute", "agree", "nn", "pred"}
