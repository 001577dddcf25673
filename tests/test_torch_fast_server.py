"""``FastServer(engine="fast_mean")`` on the CPU (f64, the kernels' plain
versions, eager): Fast MuyGPs served through the port's serving endpoint.

Held to ``examples.fast_posterior_mean.fast_posterior_mean_serve`` on the
same index and fast state, to the benchmark's plain reference
(``gpbench/reference/fastmean.py``) and to the JAX package's
``fast_posterior_mean_any``; requests of any size, a two-response
``MultivariateMuyGPS``, the chunked precompute bit for bit against the
whole, the engine's refusals, its spans and counter, and the benchmark's
readers of the ``sky2d-fastmean-serve`` cell.

Tolerances: the serve function contracts with ``einsum`` and the server
with a product and a sum, so the two add the same 30 terms in another
order: coefficients of up to ~1e2 (noise 1e-3) cancel into means of ~1,
so the order moves a mean by up to ~1e-13 (atol 1e-11).  The reference
takes its pairwise distances by direct differences where the port uses
the centred Gram identity, and JAX by its own Gram rounding: the kernel matrices differ by ~1e-16 relative, which
the solve at noise 1e-3 (condition ~1e4) lifts to ~1e-12 on the
coefficients, far under the 1e-9 allowed on the means.
"""

import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from muygpys_torch.convert import muygps_from_arrays
from muygpys_torch.examples import fast_posterior_mean as tfast
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.serve import FastServer

ROOT = Path(__file__).resolve().parents[1]
TRAIN, NN, BUCKET = 3000, 30, 256


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(17)
    x = rng.uniform(size=(TRAIN, 2))
    y = (np.sin(6 * x[:, :1]) * np.cos(4 * x[:, 1:])
         + 0.05 * rng.standard_normal((TRAIN, 1)))
    q = rng.uniform(size=(700, 2))
    return x, y, q


@pytest.fixture(scope="module")
def model():
    return muygps_from_arrays(0.3, noise=1e-3, smoothness=1.5, scale=1.0)


@pytest.fixture(scope="module")
def nbrs(field):
    return NN_Wrapper(field[0], NN, nn_method="exact", device="cpu")


@pytest.fixture(scope="module")
def server(field, model, nbrs):
    x, y, _ = field
    return FastServer(model, nbrs, x, y, bucket=BUCKET, engine="fast_mean",
                      device="cpu")


@pytest.fixture(scope="module")
def served(server, field):
    return server.predict(field[2])


def test_fast_mean_equals_the_serve_function(field, model, nbrs, served):
    """The same index's fast state served by the workflow's serve step:
    the same nearest points, the same means up to the contraction's
    order."""
    x, y, q = field
    coeffs, nn_fast = tfast.make_fast_regressor(
        model, nbrs, torch.as_tensor(x), torch.as_tensor(y), device="cpu")
    want, _ = tfast.fast_posterior_mean_serve(model, nbrs, q, x, nn_fast,
                                              coeffs)
    mean, variance = served
    assert variance is None and mean.shape == (700, 1)
    np.testing.assert_allclose(mean[:, 0], want.numpy(), rtol=0,
                               atol=1e-11)


def test_fast_mean_equals_the_plain_reference(field, served):
    from gpbench.reference import fastmean as ref

    x, y, q = (torch.as_tensor(a) for a in field)
    sets, row = ref.neighbourhoods(x, q, NN)
    want = ref.posterior_mean(x, y[:, 0], q, sets, row, 0.3, 1e-3, 1.5)
    np.testing.assert_allclose(served[0][:, 0], want.numpy(), rtol=0,
                               atol=1e-9)


def test_fast_mean_equals_jax_fast_posterior_mean_any(field, served):
    from _torch_models import jax_model
    from muygpys_tpu.examples import fast_posterior_mean as jfast
    from muygpys_tpu.neighbors import NN_Wrapper as JaxNN

    x, y, q = field
    jm = jax_model(nu=1.5, ls=0.3, noise=1e-3, scale=1.0)
    want, _, _ = jfast.fast_posterior_mean_any(jm, q, x, JaxNN(x, NN), y)
    np.testing.assert_allclose(served[0][:, 0],
                               np.asarray(want).reshape(-1), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("count", [1, BUCKET - 1, 5 * BUCKET // 2])
def test_requests_of_any_size(server, field, served, count):
    """One query, a bucket less one (padded), two and a half buckets:
    each query's mean as in the 700-query request, the counter's buckets
    and padding."""
    before = dict(server.stats)
    mean, variance = server.predict(field[2][:count])
    assert variance is None and mean.shape == (count, 1)
    np.testing.assert_allclose(mean, served[0][:count], rtol=1e-13,
                               atol=1e-15)
    buckets = -(-count // BUCKET)
    assert server.stats["buckets"] - before["buckets"] == buckets
    assert server.stats["padded"] - before["padded"] == (buckets * BUCKET
                                                         - count)


def test_two_response_multivariate_model(field, nbrs):
    """A two-response MultivariateMuyGPS (Matérn 3/2 and 5/2 over one
    deformation): the workflow's fast means of both responses."""
    import muygpys_torch.gp.deformation as d
    import muygpys_torch.gp.hyperparameter as h
    import muygpys_torch.gp.kernels as k
    import muygpys_torch.gp.noise as n
    from muygpys_torch.gp import MultivariateMuyGPS

    x, y, q = field
    y2 = np.concatenate([y, np.cos(5 * x[:, :1]) * x[:, 1:]], axis=1)

    def args(nu):
        return {"kernel": k.Matern(smoothness=h.Parameter(nu),
                                   deformation=d.Isotropy(
                                       d.l2, length_scale=h.Parameter(0.3))),
                "noise": n.HomoscedasticNoise(1e-3)}

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mm = MultivariateMuyGPS(args(1.5), args(2.5))
    server = FastServer(mm, nbrs, x, y2, bucket=BUCKET, engine="fast_mean",
                        device="cpu")
    mean, variance = server.predict(q)
    want, coeffs, _ = tfast.fast_posterior_mean_any(mm, q, x, nbrs, y2,
                                                    device="cpu")
    assert variance is None and mean.shape == (700, 2)
    assert coeffs.shape == (TRAIN, NN, 2)
    np.testing.assert_allclose(mean, want, rtol=0, atol=1e-11)
    with pytest.raises(ValueError, match="fast_mean engine"):
        FastServer(mm, nbrs, x, y2, engine="lanes", device="cpu")


@pytest.mark.parametrize("chunk", [2, 7, 1000, TRAIN - 1])
def test_chunked_precompute_is_bit_equal(field, model, nbrs, chunk,
                                         monkeypatch):
    """Chunks of neighbourhoods (7 leaves a part of 4 rows, 1000 none,
    ``TRAIN - 1`` one row, which joins the part before it) give the
    coefficients and sets of all the rows at once bit for bit, for the
    model and for a two-response multivariate model."""
    from muygpys_torch.gp import MultivariateMuyGPS

    x, y, _ = (torch.as_tensor(a) for a in field)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mm = MultivariateMuyGPS({"kernel": model.kernel,
                                 "noise": model.noise},
                                {"kernel": model.kernel,
                                 "noise": model.noise})
    y2 = torch.cat([y, 2 * y], dim=1)
    runs = []
    for size in (TRAIN, chunk):
        monkeypatch.setattr(tfast, "CHUNK", size)
        runs.append((tfast.make_fast_regressor(model, nbrs, x, y),
                     tfast.make_fast_multivariate_regressor(mm, nbrs, x, y2)))
    (whole, whole2), (parts, parts2) = runs
    assert whole[0].shape == (TRAIN, NN) and whole2[0].shape == (TRAIN, NN, 2)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1],
                                                           parts[1])
    assert torch.equal(whole2[0], parts2[0])


def _shear():
    return muygps_from_arrays(0.05, noise=1e-3 * 2 / 0.05**4, kernel="shear",
                              noise_model="shear33")


@pytest.mark.parametrize("case,match", [
    ("shear", "shear models serve through"),
    ("mesh", "takes no mesh"),
    ("rerank", "rerank=True only"),
    ("hetero", "homoscedastic noise only"),
    ("measurement_noise", "homoscedastic noise only"),
])
def test_refusals_name_their_reason(field, model, nbrs, case, match):
    x, y, _ = field
    kwargs = dict(bucket=BUCKET, engine="fast_mean", device="cpu")
    if case == "shear":
        model, y = _shear(), np.zeros((TRAIN, 3))
    elif case == "rerank":
        kwargs["rerank"] = False
    elif case == "mesh":
        kwargs["mesh"] = object()  # refused before the mesh is read
    elif case == "hetero":
        model = muygps_from_arrays(0.3, smoothness=1.5,
                                   measurement_noise=np.full(TRAIN, 1e-3))
    else:
        kwargs["measurement_noise"] = np.full(TRAIN, 1e-3)
    with pytest.raises(ValueError, match=match):
        FastServer(model, nbrs, x, y, **kwargs)


def test_precompute_spans_and_counter(field, model, nbrs):
    """``muygpys.fast.precompute`` encloses the neighbours' span and each
    chunk's tensors and factor spans; the counter holds the points, no
    failed neighbourhood and the precompute's seconds."""
    x, y, _ = field
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server = FastServer(model, nbrs, x, y, bucket=BUCKET,
                            engine="fast_mean", device="cpu")
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("muygpys.fast.")]
    by_name = {}
    for e in events:
        by_name.setdefault(e[0], []).append(e)
    assert {k: len(v) for k, v in by_name.items()} == {
        "muygpys.fast.precompute": 1, "muygpys.fast.neighbours": 1,
        "muygpys.fast.tensors": 1, "muygpys.fast.factor": 1}
    (outer,) = by_name["muygpys.fast.precompute"]
    for name, start, end in events:
        assert outer[1] <= start and end <= outer[2], name
    assert server.precompute["points"] == TRAIN
    assert server.precompute["failed"] == 0
    assert server.precompute["seconds"] > 0
    fused = FastServer(model, nbrs, x, y, bucket=BUCKET, engine="fused",
                       device="cpu")
    assert fused.precompute is None


def test_counter_counts_failed_neighbourhoods():
    """Noise 0 over a field of repeated points: a neighbourhood holding
    one point twice is singular, its coefficients NaN, and counted."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(200, 2))
    x = np.concatenate([x, x[:20]])
    y = rng.standard_normal((220, 1))
    model = muygps_from_arrays(0.3, noise=0.0, smoothness=1.5)
    server = FastServer(model, NN_Wrapper(x, 8, device="cpu"), x, y,
                        bucket=16, engine="fast_mean", device="cpu")
    assert 20 <= server.precompute["failed"] < 220
    assert server.precompute["points"] == 220


# --- the benchmark's cell and readers ---


def _ops(*names_and_times):
    from gpbench.harness.tracing import DeviceOp

    return [DeviceOp(name=n, start=s, end=e, graph=True, spans=())
            for n, s, e in names_and_times]


# two buckets: the stage's copy, the search's glue and kernels, the serve
# step after the re-rank's top-k, the readback's copy
BUCKETS = _ops(
    ("Memcpy HtoD (Pinned -> Device)", 0.0, 0.1),
    ("elementwise_kernel", 0.1, 0.2),  # Morton codes: the search's glue
    ("knn_select_kernel", 0.2, 0.5),
    ("elementwise_kernel", 0.5, 0.6),  # bounds: glue before the top-k
    ("gatherTopK", 0.6, 0.7),
    ("index_elementwise_kernel", 0.7, 0.8),
    ("reduce_kernel", 0.8, 1.0),
    ("Memcpy DtoH (Device -> Pageable)", 1.0, 1.1),
    ("Memcpy HtoD (Pinned -> Device)", 2.0, 2.1),
    ("knn_select_kernel", 2.1, 2.4),
    ("gatherTopK", 2.4, 2.5),
    ("index_elementwise_kernel", 2.5, 2.8),
    ("Memcpy DtoH (Device -> Pageable)", 2.8, 2.9),
)


def _run(ops, sizes=(8192, 8192)):
    from gpbench.harness.tracing import Trace
    from gpbench.harness.traffic import Call

    trace = (None if ops is None else
             Trace(ops=ops, spans={}, host=[], lo=0.0, hi=4.0, window_s=4.0))
    return SimpleNamespace(
        trace=trace, calls=[Call(0.0, 1.0, s, True) for s in sizes],
        cell={"server": {"bucket": 8192}},
        config={"nn_count": 30, "dim": 2}, entry=None)


def _reader(name):
    from gpbench.harness import core

    return core.metric_reader(name)


def test_contraction_is_what_follows_the_last_search_kernel():
    from gpbench.harness import contraction

    ops, buckets = contraction.contraction_ops(_run(BUCKETS).trace)
    assert buckets == 2
    assert [(o.name, o.start) for o in ops] == [
        ("index_elementwise_kernel", 0.7), ("reduce_kernel", 0.8),
        ("index_elementwise_kernel", 2.5)]
    run = _run(BUCKETS)
    assert _reader("contract_device_ms.fastmean")(run) == pytest.approx(
        1e3 * 0.6 / 2)
    from gpbench.roofline import fastmean_counts as fc
    from gpbench.roofline import peaks

    bound = peaks.bound_s(fc.ops_per_query(30, 2, 1) * 8192,
                          fc.bytes_per_query(30, 2, 1) * 8192)
    assert _reader("contract_roofline.fastmean")(run) == pytest.approx(
        100 * 2 * bound / 0.6)
    assert _reader("mfu.fastmean")(run) == pytest.approx(
        100 * fc.ops_per_query(30, 2, 1) * 16384 / (4.0 * 67e12))
    # a memset inside the serve step is part of it: only the readback's
    # device-to-host copy ends a bucket's run
    memset = _ops(("Memset (Device)", 0.75, 0.78))
    ops, buckets = contraction.contraction_ops(_run(BUCKETS + memset).trace)
    assert buckets == 2
    assert [(o.name, o.start) for o in ops] == [
        ("index_elementwise_kernel", 0.7), ("Memset (Device)", 0.75),
        ("reduce_kernel", 0.8), ("index_elementwise_kernel", 2.5)]


@pytest.mark.parametrize("name", ["contract_device_ms.fastmean",
                                  "contract_roofline.fastmean",
                                  "mfu.fastmean", "precompute_s.fastmean"])
def test_fast_readers_read_nothing_where_nothing_is(name):
    """An untraced run, a trace with no search kernel (no bucket of this
    cell's), a server without the precompute's counter: no reading."""
    assert _reader(name)(_run(None)) is None
    copies = [o for o in BUCKETS if "Memcpy" in o.name]
    if name != "mfu.fastmean":
        assert _reader(name)(_run(copies)) is None


def test_frozen_counts_at_the_cells_shape():
    from gpbench.roofline import fastmean_counts as fc

    # 30 x (3 x 2 + 1) distances, 30 x 6 evaluations, 2 x 30 contraction
    assert fc.ops_per_query(30, 2, 1) == 210 + 180 + 60
    # ids, coordinates, coefficients, the query, the mean
    assert fc.bytes_per_query(30, 2, 1) == (30 + 60 + 30 + 2 + 1) * 4


def test_traced_cpu_run_of_the_fast_mean_cell():
    """A traced run of ``sky2d-fastmean-serve`` on the CPU at the
    benchmark tests' small size: correct, the precompute's seconds read
    from the server's counter, the stage read from the spans, and the
    readers that need device activity read nothing."""
    from gpbench.harness import core

    result = core.run_cell(ROOT, "sky2d-fastmean-serve", 2**31 + 43, 0.5,
                           True, device="cpu", overrides={"points": 4096})
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["precompute_s.fastmean"]["value"] > 0
    assert metrics["stage_ms.serve"]["value"] > 0
    for name in ("contract_device_ms.fastmean", "contract_roofline.fastmean",
                 "mfu.fastmean", "idle_share.serve"):
        assert name not in metrics
