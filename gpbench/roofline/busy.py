"""Interval arithmetic of the device's busy and idle time.

A frozen copy of ``chip_smoke.py:device_trace``'s sum: only device
activities (kernels, copies, sets) count, never the host calls that
launched them, so nothing counts twice, and busy time is the union of their
intervals.  Unlike that function the idle share divides by the traced
window's own length on the host clock, not by a separate run's."""

from __future__ import annotations

from typing import Iterable, List, Tuple


def merged(intervals: Iterable[Tuple[float, float]],
           lo: float = float("-inf"),
           hi: float = float("inf")) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def union_s(intervals, lo=float("-inf"), hi=float("inf")) -> float:
    """Seconds covered by the union of the intervals inside ``[lo, hi]``."""
    return sum(end - start for start, end in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, reach = [], lo
    for start, end in merged(intervals, lo, hi):
        if start > reach:
            out.append((reach, start))
        reach = max(reach, end)
    if hi > reach:
        out.append((reach, hi))
    return out


def idle_share(busy_s: float, window_s: float) -> float:
    """The share of the window in which no device activity ran."""
    return 1.0 - busy_s / window_s
