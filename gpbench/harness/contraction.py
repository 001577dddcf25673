"""The fast-mean bucket's contraction in a traced window, for its readers.

Inside the captured bucket every kernel after the search's last (the
re-rank's top-k) belongs to the serve step: the nearest point's id, its
neighbourhood's ids, coordinates and coefficients gathered, the crosswise
distances, the kernel and the contraction.  The kernels before it that the
kernel-name table does not name (the queries' Morton codes, the tiles'
bounds, the norms) are the search's own glue.  So a bucket's contraction
is the run of device activities from its last search kernel to the
device-to-host copy that reads its outputs back, memsets and copies on the
device inside it included; the names of those kernels, generic
elementwise, index and reduction kernels, say nothing by themselves.
"""

from __future__ import annotations

from typing import List, Tuple

from gpbench.harness import readings


def contraction_ops(trace) -> Tuple[List, int]:
    """``(ops, buckets)``: the device activities that follow each bucket's
    last search kernel up to the next device-to-host copy, and how many
    buckets showed such a run."""
    search = {id(op) for op in readings.search_ops(trace)}
    out, pending, armed, buckets = [], [], False, 0
    for op in sorted(trace.ops, key=lambda o: o.start):
        if id(op) in search:
            pending, armed = [], True
        elif _is_readback(op):
            if armed and pending:
                out.extend(pending)
                buckets += 1
            pending, armed = [], False
        elif armed:
            pending.append(op)
    return out, buckets


def _is_readback(op) -> bool:
    return readings.is_copy(op) and "dtoh" in op.name.lower()
