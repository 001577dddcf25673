"""muygpys_torch.optimize.experimental (the mini-batch chassis) against
muygpys_tpu.optimize.experimental, f64 on the CPU."""

import numpy as np
import pytest
import torch

import muygpys_tpu.gp as jgp
import muygpys_tpu.gp.deformation as jdef
import muygpys_tpu.gp.hyperparameter as jhyp
import muygpys_tpu.gp.kernels as jker
import muygpys_tpu.gp.noise as jnoise
import muygpys_torch.gp as tgp
import muygpys_torch.gp.deformation as tdef
import muygpys_torch.gp.hyperparameter as thyp
import muygpys_torch.gp.kernels as tker
import muygpys_torch.gp.noise as tnoise
from muygpys_torch.optimize.experimental import (
    optimize_from_tensors_mini_batch,
)
from muygpys_tpu.optimize.experimental import (
    optimize_from_tensors_mini_batch as jax_mini_batch,
)


def _model(pkg, aniso=False):
    gp, d, h, k, n = pkg
    if aniso:
        deformation = d.Anisotropy(d.l2, length_scale=h.VectorParameter(
            h.Parameter(0.5, (0.05, 2.0)), h.Parameter(0.5, (0.05, 2.0))))
    else:
        deformation = d.Isotropy(d.l2, length_scale=h.Parameter(
            0.5, (0.05, 2.0)))
    return gp.MuyGPS(
        kernel=k.Matern(smoothness=h.Parameter(1.5), deformation=deformation),
        noise=n.HomoscedasticNoise(1e-3, (1e-5, 0.1)),
        scale=h.AnalyticScale(),
    )


JAX = (jgp, jdef, jhyp, jker, jnoise)
PORT = (tgp, tdef, thyp, tker, tnoise)


@pytest.fixture(scope="module")
def field(rng):
    x = rng.uniform(size=(800, 2))
    y = (np.sin(6 * x[:, 0]) * np.cos(4 * x[:, 1])
         + 0.05 * rng.standard_normal(800))[:, None]
    return x, y


def _both(field, engine, aniso=False, **kw):
    x, y = field
    args = (x, y, 16, 128, 800)
    ref = jax_mini_batch(_model(JAX, aniso), *args, engine=engine,
                         rng=np.random.default_rng(1), **kw)
    port = optimize_from_tensors_mini_batch(
        _model(PORT, aniso), *args, engine=engine,
        rng=np.random.default_rng(1), device="cpu", **kw,
    )
    return port, ref


@pytest.mark.parametrize("keep_state,probe_previous",
                         [(False, False), (True, True)])
def test_bayes_engine_matches_jax(field, keep_state, probe_previous):
    """One rng and random_state: the same batches and probes, so the same
    parameters, probe and step counts, and scale."""
    port, ref = _both(field, "bayes", num_epochs=3, keep_state=keep_state,
                      probe_previous=probe_previous, init_points=3, n_iter=3,
                      random_state=0)
    np.testing.assert_allclose(port[0].get_opt_params()[1],
                               ref[0].get_opt_params()[1], rtol=0, atol=1e-8)
    assert port[3:] == ref[3:]
    assert float(port[0].scale()) == pytest.approx(float(ref[0].scale()),
                                                   rel=1e-8)


@pytest.mark.parametrize("keep_state", [False, True])
def test_device_lbfgs_engine_matches_jax(field, keep_state):
    """One make_device_trainer trajectory an epoch (the same batches):
    parameters within 1e-6 of JAX's, the same L-BFGS step count."""
    port, ref = _both(field, "device-lbfgs", num_epochs=3,
                      keep_state=keep_state)
    np.testing.assert_allclose(port[0].get_opt_params()[1],
                               ref[0].get_opt_params()[1], rtol=1e-6)
    assert port[4] == ref[4] > 0 and port[3] == ref[3] == 0


def test_anisotropic_rebuild_matches_jax(field):
    """Under Anisotropy the index is rebuilt on the features divided by the
    learned length scales: the last epoch's index equals JAX's."""
    port, ref = _both(field, "bayes", aniso=True, num_epochs=2,
                      init_points=2, n_iter=2, random_state=3)
    np.testing.assert_allclose(port[0].get_opt_params()[1],
                               ref[0].get_opt_params()[1], rtol=0, atol=1e-8)
    np.testing.assert_allclose(port[1].train, np.asarray(ref[1].train),
                               rtol=1e-12)
    assert not np.allclose(port[1].train, field[0])


def test_hierarchical_batch_features_are_derived_per_epoch(rng):
    """batch_features=True trains a hierarchical length scale: each epoch's
    features are train_features[batch_indices], as in JAX."""
    from muygpys_tpu.gp.hyperparameter.experimental import (
        HierarchicalParameter as JaxHier,
    )

    from muygpys_torch.gp.hyperparameter.experimental import (
        HierarchicalParameter,
    )

    x = rng.uniform(size=(300, 1))
    y = np.sin(8 * x) + 0.05 * rng.standard_normal((300, 1))
    knots = np.array([[0.25], [0.75]])

    def model(pkg, hier):
        gp, d, h, k, n = pkg
        return gp.MuyGPS(
            kernel=k.Matern(smoothness=h.Parameter(1.5), deformation=d.Isotropy(
                d.l2, length_scale=hier(knots, h.VectorParameter(
                    h.Parameter(0.3, (0.05, 1.0)),
                    h.Parameter(0.3, (0.05, 1.0))), k.RBF()))),
            noise=n.HomoscedasticNoise(1e-3), scale=h.AnalyticScale(),
        )

    kw = dict(num_epochs=2, batch_features=True)
    ref = jax_mini_batch(model(JAX, JaxHier), x, y, 12, 64, 300,
                         engine="device-lbfgs",
                         rng=np.random.default_rng(4), **kw)
    port = optimize_from_tensors_mini_batch(
        model(PORT, HierarchicalParameter), torch.as_tensor(x),
        torch.as_tensor(y), 12, 64, 300, engine="device-lbfgs",
        rng=np.random.default_rng(4), **kw,
    )
    np.testing.assert_allclose(port[0].get_opt_params()[1],
                               ref[0].get_opt_params()[1], rtol=1e-6)


def test_refusals(field):
    x, y = field
    for kw, match in ((dict(obj_method="other"), "objective method"),
                      (dict(engine="adam"), "unknown engine")):
        with pytest.raises(ValueError, match=match):
            optimize_from_tensors_mini_batch(_model(PORT), x, y, 16, 128,
                                             800, device="cpu", **kw)
    from muygpys_torch.optimize import cross_entropy_fn

    with pytest.raises(ValueError, match="use engine='bayes'"):
        optimize_from_tensors_mini_batch(
            _model(PORT), x, y, 16, 128, 800, engine="device-lbfgs",
            loss_fn=cross_entropy_fn, device="cpu",
        )
