"""Helpers the readers of the program's own spans share.

The program marks its serving and search paths with spans named
``muygpys.<layer>.<what>`` (``muygpys_torch/tracing.py``).  They are host
operations of the trace (``Trace.host``) on the profiler's clock, the
clock of the device activities, so a span's interval can be set against
the device's idle stretches and the host's kernel launches.  A program
without such a span gives no intervals, and each reader then reports
nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple

from gpbench.roofline import busy

LAUNCHES = ("cudaLaunch", "cuLaunch")


def spans(trace, name) -> List[Tuple[float, float]]:
    """The ``(start, end)`` intervals of the host operations named
    ``name``, in order."""
    return sorted((s, e) for s, e, n in trace.host if n == name)


def idle_inside(trace, intervals) -> float:
    """Seconds of the window in which no device activity ran, inside the
    union of ``intervals``."""
    inside = busy.merged(intervals, trace.lo, trace.hi)
    gaps = busy.gaps(((o.start, o.end) for o in trace.ops), trace.lo,
                     trace.hi)
    total, j = 0.0, 0
    for start, end in gaps:
        while j < len(inside) and inside[j][1] <= start:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < end:
            total += min(end, inside[k][1]) - max(start, inside[k][0])
            k += 1
    return total


def launch_calls_inside(trace, intervals) -> int:
    """Host calls that launch a kernel (``cudaLaunch*``, ``cuLaunch*``)
    and start inside the union of ``intervals``."""
    inside = busy.merged(intervals)
    starts = [s for s, _ in inside]
    count = 0
    for start, _, name in trace.host:
        if not name.startswith(LAUNCHES):
            continue
        j = bisect.bisect_right(starts, start) - 1
        if j >= 0 and start <= inside[j][1]:
            count += 1
    return count
