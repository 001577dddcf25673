"""Closed loop: ``clients`` (1) client sends the pool's requests in turn,
each when the last is answered, until the window's seconds have passed;
the window runs from the first send to the last answer, and a request's
latency is its call alone (nothing queues)."""

from __future__ import annotations

import traceback

from gpbench.harness import traffic


def pool(spec, seed, points, device):
    if spec.get("clients", 1) != 1:
        raise ValueError("the closed loop drives one client")
    return traffic.queries(spec, seed, device)


def drive(entry, pool, seconds, max_calls, answered, tracer, clock):
    calls, failures = [], []
    start = clock()
    i = 0
    while True:
        request = pool[i % len(pool)]
        with tracer.span("call"):
            t0 = clock()
            try:
                out = entry.call(request)
                ok = True
            except Exception:  # a failed call is counted and reported
                ok, out = False, None
                failures.append(traceback.format_exc(limit=4))
            t1 = clock()
        calls.append(traffic.Call(t0, t1, len(request), ok))
        if ok:
            answered(request, out)
        i += 1
        if t1 - start >= seconds or i >= max_calls:
            break
    return calls, t1 - start, failures
