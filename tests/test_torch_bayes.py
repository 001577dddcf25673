"""muygpys_torch.optimize.bayes and Bayes_optimize against muygpys_tpu."""

import numpy as np
import pytest
import torch

import muygpys_tpu.optimize as jopt
from muygpys_torch.optimize import Bayes_optimize, lool_fn
from muygpys_torch.optimize.bayes import BayesianOptimization
from muygpys_tpu.optimize.bayes import BayesianOptimization as JaxBayes



def _branin(x, y):
    return -((y - 5.1 / (4 * np.pi**2) * x**2 + 5 / np.pi * x - 6) ** 2
             + 10 * (1 - 1 / (8 * np.pi)) * np.cos(x) + 10)


@pytest.mark.parametrize("random_state", [0, 3])
def test_probe_history_matches_jax(random_state):
    """One random_state: the same probes, in order, and the same maximum
    on a closed-form function (the surrogate's own draws included)."""
    bounds = {"x": (-5.0, 10.0), "y": (0.0, 15.0)}
    runs = []
    for cls in (BayesianOptimization, JaxBayes):
        opt = cls(f=_branin, pbounds=bounds, random_state=random_state)
        opt.probe({"x": 1.0, "y": 2.0}, lazy=True)
        opt.maximize(init_points=4, n_iter=8)
        runs.append(opt)
    port, ref = runs
    assert len(port.res) == len(ref.res) == 13
    for a, b in zip(port.res, ref.res):
        assert a["target"] == b["target"]
        assert a["params"] == b["params"]
    assert port.max == ref.max


def test_non_finite_probe_scores_the_penalty():
    opt = BayesianOptimization(f=lambda x: np.nan, pbounds={"x": (0, 1)},
                               random_state=0)
    opt.maximize(init_points=2, n_iter=0)
    assert [r["target"] for r in opt.res] == [-1e12, -1e12]


def _models():
    from muygpys_tpu.gp import MuyGPS as JaxMuyGPS
    from muygpys_tpu.gp.deformation import Isotropy as JI, l2 as jl2
    from muygpys_tpu.gp.hyperparameter import (
        AnalyticScale as JA,
        Parameter as JP,
    )
    from muygpys_tpu.gp.kernels import Matern as JM
    from muygpys_tpu.gp.noise import HomoscedasticNoise as JN

    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise

    jm = JaxMuyGPS(
        kernel=JM(smoothness=JP(1.5),
                  deformation=JI(jl2, length_scale=JP(0.7, (0.1, 3.0)))),
        noise=JN(1e-2, (1e-4, 0.1)), scale=JA(),
    )
    tm = MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=Parameter(0.7, (0.1, 3.0)))),
        noise=HomoscedasticNoise(1e-2, (1e-4, 0.1)), scale=AnalyticScale(),
    )
    return jm, tm


def test_bayes_optimize_matches_jax_on_a_loo_objective(rng):
    """Bayes_optimize on the lool objective of one batch of real
    neighbourhoods: the same probes, JAX's parameters within 1e-8."""
    import jax.numpy as jnp

    from muygpys_tpu.neighbors import NN_Wrapper as JaxNN
    from muygpys_tpu.optimize import sample_batch

    x = rng.uniform(size=(600, 2))
    y = (np.sin(6 * x[:, 0]) * np.cos(4 * x[:, 1])
         + 0.05 * rng.standard_normal(600))[:, None]
    bi, bnn = sample_batch(JaxNN(x, 16), 96, 600,
                           rng=np.random.default_rng(4))
    bi, bnn = np.array(bi), np.array(bnn)
    jm, tm = _models()
    jb = jm.make_train_tensors(bi, bnn, jnp.asarray(x), jnp.asarray(y))
    tb = tm.make_train_tensors(bi, bnn, torch.as_tensor(x),
                               torch.as_tensor(y))
    kw = dict(init_points=3, n_iter=6, random_state=5)
    jref = jopt.Bayes_optimize(jm, jb[2], jb[3], jb[0], jb[1],
                               loss_fn=jopt.lool_fn, **kw)
    port = Bayes_optimize(tm, tb[2], tb[3], tb[0], tb[1], loss_fn=lool_fn,
                          **kw)
    names, tv, _ = port.get_opt_params()
    assert names == ["length_scale", "noise"]
    _, jv, _ = jref.get_opt_params()
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-8)
    assert not np.allclose(tv, [0.7, 1e-2])


def test_bayes_optimize_scores_a_failed_cholesky_as_jax_scores_nan(rng):
    """A probe whose Cholesky fails is scored -1e12 (in JAX the factor is
    NaN); the optimization carries on."""
    from muygpys_torch.optimize.chassis import scalar_objective

    def broken(**params):
        raise torch.linalg.LinAlgError("not positive definite")

    assert np.isnan(scalar_objective(broken)(length_scale=0.5))
    opt = BayesianOptimization(f=scalar_objective(broken),
                               pbounds={"length_scale": (0.1, 1.0)},
                               random_state=0)
    opt.maximize(init_points=2, n_iter=1)
    assert [r["target"] for r in opt.res] == [-1e12] * 3
