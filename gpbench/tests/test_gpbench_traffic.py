"""The traffic kinds' pools and the data are deterministic per seed, and
the closed loop drives an entry as the window does."""

import json
from pathlib import Path

import numpy as np
import pytest

from gpbench.harness import data, traffic

ROOT = Path(__file__).resolve().parents[2]
MIXES = [w["traffic"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
BIG = 2**31 + 987_654


@pytest.mark.parametrize("mix", MIXES)
def test_pool_is_deterministic_per_seed(mix):
    spec = dict(traffic.load(mix))
    if "pool" in spec:
        spec["pool"] = 4
    kind = traffic.kind(spec)
    a = kind.pool(spec, BIG, 50_000, "cpu")
    b = kind.pool(spec, BIG, 50_000, "cpu")
    c = kind.pool(spec, BIG + 1, 50_000, "cpu")
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not all(np.array_equal(u, v) for u, v in zip(a, c))
    for request in a:
        assert request.dtype == np.float32
        assert request.min() >= 0.0 and request.max() <= 1.0


def pool_of(mix, seed):
    spec = traffic.load(mix)
    return traffic.kind(spec).pool(spec, seed, 1000, "cpu")


def test_every_seed_sends_the_same_sizes():
    a = [len(r) for r in pool_of("closed-16to256-cluster", 3)]
    b = [len(r) for r in pool_of("closed-16to256-cluster", 4)]
    assert sorted(a) == sorted(b) == list(range(16, 257)) and a != b


def test_cluster_side():
    for request in pool_of("closed-16to256-cluster", 5)[:20]:
        assert np.all(np.ptp(request, axis=0) <= 0.01 + 1e-6)


class Clock:
    """A clock that each call of the entry moves by one second."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class Entry:
    def __init__(self, clock, fail_at=()):
        self.clock, self.fail_at, self.sent = clock, set(fail_at), []

    def call(self, request):
        self.clock.now += 1.0
        self.sent.append(request)
        if len(self.sent) in self.fail_at:
            raise RuntimeError("planted")
        return request * 2


def test_closed_loop_cycles_the_pool_until_the_window_closes():
    from gpbench.harness.tracing import Tracer

    spec = traffic.load("closed-8192-uniform")
    kind = traffic.kind(spec)
    pool = [np.full((n, 2), n, np.float32) for n in (3, 5)]
    clock = Clock()
    entry = Entry(clock, fail_at={2})
    answered = []
    calls, window_s, failures = kind.drive(
        entry, pool, 4.5, 1 << 62, lambda r, o: answered.append((r, o)),
        Tracer(False), clock)
    assert window_s == 5.0 and len(calls) == 5 and len(failures) == 1
    assert [c.size for c in calls] == [3, 5, 3, 5, 3]
    assert [c.ok for c in calls] == [True, False, True, True, True]
    assert all(c.seconds == 1.0 for c in calls)
    assert len(answered) == 4 and np.array_equal(answered[0][1], pool[0] * 2)
    calls, _, _ = kind.drive(Entry(Clock()), pool, 1e9, 3, lambda r, o: None,
                             Tracer(False), Clock())
    assert len(calls) == 3


def test_unknown_kind_is_refused():
    with pytest.raises(FileNotFoundError):
        traffic.kind({"kind": "no-such-kind"})


@pytest.mark.parametrize("name", ["matern32-sky2d-1m", "shear33-sky2d-1m"])
def test_data_is_deterministic_per_seed(name):
    cfg = dict(json.loads((ROOT / "gpbench" / "configs" / f"{name}.json")
                          .read_text()), points=1000)
    x1, y1 = data.make(cfg, BIG, "cpu")
    x2, y2 = data.make(cfg, BIG, "cpu")
    x3, _ = data.make(cfg, BIG + 1, "cpu")
    assert x1.equal(x2) and y1.equal(y2) and not x1.equal(x3)
    assert y1.shape[0] == 1000


def test_streams_are_independent():
    assert len({data.derive(BIG, s) for s in range(4)}) == 4
    assert data.derive(-1, 0) == data.derive(2**64 - 1, 0)
