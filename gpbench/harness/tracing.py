"""The ``--trace 1`` run's profiler trace, reduced to what the per-layer
readers and the breakdown need.

The harness marks its own calls into the program with
``torch.profiler.record_function`` spans named ``gpbench.<what>`` (the
window, each request, the neighbour search handed to a server).  A
device activity is attributed to the host call that launched it through
the profiler's correlation id: a kernel of a replayed CUDA graph to
``cudaGraphLaunch``, an eager kernel to the span its launch fell in.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

from gpbench.roofline import busy

SPAN_PREFIX = "gpbench."
GRAPH_LAUNCH = "cudaGraphLaunch"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float  # seconds, the profiler's clock
    end: float
    graph: bool  # launched by a replay of a captured CUDA graph
    spans: Tuple[str, ...]  # the harness spans open at its launch

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    """One traced window: its device activities, the harness's spans and
    the host's operations, on the profiler's clock, and the window's
    length on the host clock."""

    ops: List[DeviceOp]
    spans: Dict[str, List[Tuple[float, float]]]
    host: List[Tuple[float, float, str]]
    lo: float
    hi: float
    window_s: float

    def busy_s(self, ops: Optional[List[DeviceOp]] = None) -> float:
        ops = self.ops if ops is None else ops
        return busy.union_s(((o.start, o.end) for o in ops), self.lo, self.hi)

    def select(self, names=(), graph=None, span=None) -> List[DeviceOp]:
        """The device activities whose name holds one of ``names`` (any
        name where empty, compared in lower case), launched by a graph
        replay or not (``graph``), or inside the harness span ``span``."""
        keys = tuple(n.lower() for n in names)
        out = []
        for op in self.ops:
            if keys and not any(k in op.name.lower() for k in keys):
                continue
            if graph is not None and op.graph != graph:
                continue
            if span is not None and span not in op.spans:
                continue
            out.append(op)
        return out

    def top_ops(self, count=10) -> List[list]:
        totals: Dict[str, float] = {}
        for op in self.ops:
            totals[op.name] = totals.get(op.name, 0.0) + op.seconds
        return [[k, v] for k, v in
                sorted(totals.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count=10) -> List[list]:
        """The device's idle stretches inside the window, summed by what
        the host was doing at their start: the innermost host operation
        open then, under the innermost harness span."""
        totals: Dict[str, float] = {}
        host = sorted(self.host)
        active: List[Tuple[float, float, str]] = []
        i = 0
        for start, end in busy.gaps(((o.start, o.end) for o in self.ops),
                                    self.lo, self.hi):
            while i < len(host) and host[i][0] <= start:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] > start]
            label = _label(active)
            totals[label] = totals.get(label, 0.0) + (end - start)
        return [[k, v] for k, v in
                sorted(totals.items(), key=lambda kv: -kv[1])[:count]]


def _label(active) -> str:
    """The innermost harness span and host operation among those open."""
    spans = [h for h in active if h[2].startswith(SPAN_PREFIX)]
    ops = [h for h in active if not h[2].startswith(SPAN_PREFIX)]
    inner = lambda hs: min(hs, key=lambda h: h[1] - h[0])[2] if hs else None
    return " > ".join([inner(spans) or "outside any span",
                       inner(ops) or "python"])[:120]


def _short(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").split("(")[0][:96]


class Tracer:
    """``with tracer.window(): ...`` profiles the window; ``tracer.trace``
    is the reduced :class:`Trace` afterwards.  ``span(name)`` marks a
    harness call inside it (a no-op when not tracing)."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled, self.cuda = enabled, cuda
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def window(self, clock):
        """Profile the block; ``clock()`` is the host clock whose reading
        around the block gives the window's length."""
        if not self.enabled:
            yield
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)

        def sync():
            if self.cuda:
                torch.cuda.synchronize()

        # the first profiling session pays the tracer's start-up
        with torch.profiler.profile(activities=acts):
            sync()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(SPAN_PREFIX + "window"):
                t0 = clock()
                yield
                sync()
                window_s = clock() - t0
        self.trace = reduce(prof, window_s)


def reduce(prof, window_s: float) -> Trace:
    """The profiler's events as a :class:`Trace`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    host, spans, launches = [], {}, {}
    device = []
    for e in events:
        start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        name = e.name()
        if e.device_type() == cuda:
            # the harness's spans show on the device's timeline too
            if not name.startswith(SPAN_PREFIX):
                device.append((start, end, name, e.correlation_id()))
            continue
        host.append((start, end, name))
        if name.startswith(SPAN_PREFIX):
            spans.setdefault(name[len(SPAN_PREFIX):], []).append((start, end))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = (start, name)
    lo, hi = spans["window"][0]
    # a kind of span never overlaps itself: each is searched by bisection
    starts = {k: [s for s, _ in sorted(v)] for k, v in spans.items()
              if k != "window"}
    ordered = {k: sorted(v) for k, v in spans.items() if k != "window"}

    def open_at(t):
        out = []
        for k, st in starts.items():
            j = bisect.bisect_right(st, t) - 1
            if j >= 0 and ordered[k][j][1] >= t:
                out.append(k)
        return tuple(out)

    ops = []
    for start, end, name, corr in device:
        launch = launches.get(corr)
        ops.append(DeviceOp(
            name=_short(name), start=start, end=end,
            graph=bool(launch) and launch[1] == GRAPH_LAUNCH,
            spans=open_at(launch[0] if launch else start),
        ))
    return Trace(ops=ops, spans=spans, host=host, lo=lo, hi=hi,
                 window_s=window_s)
