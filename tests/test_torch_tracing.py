"""The port's spans and serving counters on the CPU, and the benchmark's
readers of them.

A span (``muygpys_torch.tracing.span``) is a kineto ``cpu_op`` event while
a ``torch.profiler`` session records and a shared null context otherwise;
``FastServer.predict`` and ``NN_Wrapper.get_nns`` mark their stretches with
spans nested by time, and ``FastServer.stats`` counts what a server did.
The readers of ``gpbench/metrics/`` that read the spans are held to traces
built by hand and to a traced CPU run of the small-request cell.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from muygpys_torch import tracing
from muygpys_torch.convert import muygps_from_arrays
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.serve import FastServer

ROOT = Path(__file__).resolve().parents[1]
SERVE = ("muygpys.serve.stage", "muygpys.serve.replay",
         "muygpys.serve.readback")
SEARCH = ("muygpys.nn.candidates", "muygpys.nn.refine")


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(11)
    xtr = rng.uniform(size=(2048, 2))
    ytr = rng.standard_normal((2048, 1))
    xte = rng.uniform(size=(8, 2))
    return xtr, ytr, xte


def _server(field, engine, bucket=4):
    xtr, ytr, _ = field
    model = muygps_from_arrays(0.3, noise=1e-3, smoothness=1.5, scale=1.0)
    return FastServer(model, NN_Wrapper(xtr, 12, device="cpu"), xtr, ytr,
                      bucket=bucket, engine=engine, device="cpu")


def _events(prof):
    """The profiler's ``muygpys.*`` events: (name, activity type, start,
    end)."""
    return [(e.name(), e.activity_type(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("muygpys.")]


def _inside(child, parent):
    return parent[2] <= child[2] and child[3] <= parent[3]


def test_span_is_the_shared_null_context_without_a_profiler():
    assert tracing.span("muygpys.serve.predict") is tracing._NULL
    assert tracing.span("muygpys.nn.get_nns") is tracing._NULL
    with tracing.span("muygpys.serve.stage"):
        pass


def test_span_is_a_cpu_op_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = tracing.span("muygpys.serve.predict")
        assert span is not tracing._NULL
        with span:
            torch.ones(3).sum()
    (event,) = _events(prof)
    assert event[:2] == ("muygpys.serve.predict", "cpu_op")
    assert tracing.span("muygpys.serve.predict") is tracing._NULL


@pytest.mark.parametrize("engine", ["fused", "kernel", "lanes"])
def test_predict_spans_once_a_request_and_bucket_nested(field, engine):
    """Requests of 3 and 5 queries at bucket 4: two requests, three
    buckets; every span a ``cpu_op``, each bucket's spans inside their
    request's, the search's inside ``get_nns`` inside the request's."""
    server = _server(field, engine)
    xte = field[2]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.predict(xte[:3])
        server.predict(xte[3:])
    events = _events(prof)
    assert {kind for _, kind, _, _ in events} == {"cpu_op"}
    by_name = {}
    for e in events:
        by_name.setdefault(e[0], []).append(e)
    searched = engine != "fused"
    want = {"muygpys.serve.predict": 2, **{n: 3 for n in SERVE}}
    if searched:
        want.update({"muygpys.nn.get_nns": 2, **{n: 2 for n in SEARCH}})
    assert {k: len(v) for k, v in by_name.items()} == want
    requests = by_name["muygpys.serve.predict"]
    for name in SERVE + (("muygpys.nn.get_nns",) if searched else ()):
        for child in by_name[name]:
            assert sum(_inside(child, r) for r in requests) == 1, name
    for name in SEARCH if searched else ():
        for child in by_name[name]:
            assert sum(_inside(child, s)
                       for s in by_name["muygpys.nn.get_nns"]) == 1, name
    for request, sizes in zip(sorted(requests, key=lambda e: e[2]),
                              ([3], [4, 1])):
        stages = [s for s in by_name["muygpys.serve.stage"]
                  if _inside(s, request)]
        assert len(stages) == len(sizes)


@pytest.mark.parametrize("method", ["exact", "kernel"])
def test_get_nns_spans_every_search(field, method):
    """``get_nns`` and ``get_batch_nns`` are one ``get_nns`` span each,
    with the candidate search and the re-rank inside it."""
    xtr, _, xte = field
    nbrs = NN_Wrapper(xtr, 12, nn_method=method, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nbrs.get_nns(xte)
        nbrs.get_batch_nns(np.arange(5))
    events = _events(prof)
    outer = [e for e in events if e[0] == "muygpys.nn.get_nns"]
    assert len(outer) == 2
    for name in SEARCH:
        inner = [e for e in events if e[0] == name]
        assert len(inner) == 2
        assert all(sum(_inside(i, o) for o in outer) == 1 for i in inner)
    assert {kind for _, kind, _, _ in events} == {"cpu_op"}


@pytest.mark.parametrize("engine", ["fused", "kernel", "lanes"])
def test_stats_count_requests_queries_buckets_and_padding(field, engine):
    server = _server(field, engine)
    assert server.stats == {"requests": 0, "queries": 0, "buckets": 0,
                            "padded": 0}
    xte = field[2]
    server.predict(xte[:3])
    server.predict(xte[3:])
    assert server.stats == {"requests": 2, "queries": 8, "buckets": 3,
                            "padded": 4}
    server.predict(xte[:4])
    assert server.stats == {"requests": 3, "queries": 12, "buckets": 4,
                            "padded": 4}


def test_stats_count_a_shear_server():
    rng = np.random.default_rng(5)
    pts = rng.uniform(size=(600, 2))
    targets = rng.standard_normal((600, 3))
    model = muygps_from_arrays(0.05, noise=1e-3 * 2 / 0.05**4,
                               kernel="shear", noise_model="shear33")
    server = FastServer(model, NN_Wrapper(pts, 12, device="cpu"), pts,
                        targets, bucket=16, engine="kernel", device="cpu")
    server.predict(rng.uniform(size=(20, 2)))
    assert server.stats == {"requests": 1, "queries": 20, "buckets": 2,
                            "padded": 12}


# --- the benchmark's readers of the spans, on traces built by hand ---


def _trace(ops, host, lo=0.0, hi=10.0):
    from gpbench.harness.tracing import DeviceOp, Trace

    return Trace(
        ops=[DeviceOp(name="k", start=s, end=e, graph=False, spans=())
             for s, e in ops],
        spans={}, host=host, lo=lo, hi=hi, window_s=hi - lo)


def _run(trace, sizes, bucket=4):
    from gpbench.harness.traffic import Call

    calls = [Call(0.0, 1.0, size, True) for size in sizes]
    return SimpleNamespace(trace=trace, calls=calls,
                           cell={"server": {"bucket": bucket}})


def _reader(name):
    from gpbench.harness import core

    return core.metric_reader(name)


# device busy over [1, 2] and [4, 6]; idle over [0, 1], [2, 4], [6, 10]
OPS = [(1.0, 2.0), (4.0, 6.0)]
HOST = [
    (0.5, 3.0, "muygpys.nn.get_nns"),
    (0.6, 0.7, "cudaLaunchKernel"),
    (0.8, 0.9, "cuLaunchKernel"),
    (2.5, 2.6, "cudaLaunchKernelExC"),
    (2.7, 2.8, "cudaMemcpyAsync"),
    (3.5, 3.6, "cudaLaunchKernel"),  # outside every span
    (5.0, 7.0, "muygpys.nn.get_nns"),
    (5.5, 5.6, "cudaGraphLaunch"),  # a replay, not a kernel launch
    (6.5, 6.6, "cudaLaunchKernel"),
    (7.0, 7.5, "muygpys.serve.stage"),
    (8.0, 8.25, "muygpys.serve.stage"),
    (8.5, 9.5, "muygpys.serve.readback"),
]


def test_program_helpers_on_a_trace_built_by_hand():
    from gpbench.harness import program

    trace = _trace(OPS, HOST)
    searches = program.spans(trace, "muygpys.nn.get_nns")
    assert searches == [(0.5, 3.0), (5.0, 7.0)]
    # idle inside: [0.5, 1] + [2, 3] + [6, 7]
    assert program.idle_inside(trace, searches) == pytest.approx(2.5)
    assert program.idle_inside(trace, [(0.0, 10.0)]) == pytest.approx(7.0)
    assert program.idle_inside(trace, [(1.2, 1.8)]) == 0.0
    assert program.launch_calls_inside(trace, searches) == 4
    assert program.spans(trace, "muygpys.serve.replay") == []
    assert program.idle_inside(trace, []) == 0.0
    assert program.launch_calls_inside(trace, []) == 0


def test_span_readers_on_a_trace_built_by_hand():
    run = _run(_trace(OPS, HOST), [3, 2])
    assert _reader("stage_ms.serve")(run) == pytest.approx(1e3 * 0.75 / 2)
    assert _reader("readback_idle_ms.serve")(run) == pytest.approx(500.0)
    assert _reader("padding_share.serve")(run) == pytest.approx(
        100 * (1 - 5 / 8))
    assert _reader("search_launches.serve")(run) == 2.0
    assert _reader("search_idle_ms.serve")(run) == pytest.approx(1250.0)


READERS = ["stage_ms.serve", "readback_idle_ms.serve", "padding_share.serve",
           "search_launches.serve", "search_idle_ms.serve"]


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_without_their_span(name):
    """A program without the spans (the harness's own spans only) gives
    no reading, and neither does an untraced run."""
    host = [(0.0, 10.0, "gpbench.window"), (1.0, 2.0, "cudaLaunchKernel")]
    assert _reader(name)(_run(_trace(OPS, host), [3])) is None
    assert _reader(name)(_run(None, [3])) is None


@pytest.mark.parametrize("name", ["readback_idle_ms.serve",
                                  "search_launches.serve",
                                  "search_idle_ms.serve"])
def test_device_readers_read_nothing_without_device_activity(name):
    assert _reader(name)(_run(_trace([], HOST), [3])) is None


def test_traced_cpu_run_of_the_small_cell_reads_its_padding():
    """A traced run of ``sky2d-serve-small`` on the CPU at the benchmark
    tests' small size: ``padding_share.serve`` is the share computed from
    the sizes of the requests the window sent (the pool in turn, one
    bucket of 256 each), ``stage_ms.serve`` reads, and the readers that
    need device activity give nothing."""
    from gpbench.harness import core, traffic

    seed = 2**31 + 41
    result = core.run_cell(ROOT, "sky2d-serve-small", seed, 1.0, True,
                           device="cpu", overrides={"points": 4096})
    assert result["correct"], result["checks"]
    cell = core.load_json("workloads", "sky2d-serve-small")
    mix = traffic.load(cell["traffic"])
    pool = traffic.kind(mix).pool(mix, seed, 4096, torch.device("cpu"))
    sizes = [len(pool[i % len(pool)]) for i in range(result["attempted"])]
    bucket = cell["server"]["bucket"]
    assert all(size <= bucket for size in sizes)
    want = 100.0 * (1.0 - sum(sizes) / (len(sizes) * bucket))
    metrics = result["metrics"]
    assert metrics["padding_share.serve"]["value"] == pytest.approx(want)
    assert metrics["stage_ms.serve"]["value"] > 0
    for name in ("readback_idle_ms.serve", "idle_share.serve",
                 "search_device_ms.serve", "mfu.serve"):
        assert name not in metrics
