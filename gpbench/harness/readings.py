"""Helpers the metric readers share: the traced window's calls, the
kernel-name tables, the frozen counts at the run's shapes."""

from __future__ import annotations

from gpbench.roofline import counts, peaks

# kernels of the neighbour search by name, where a captured bucket holds
# the search with the rest: the candidate kernel K3 (both variants), the
# sorts (the queries' Morton order), the top-k selections (the exact
# search's and the re-rank's) and the exact search's matrix products
SEARCH_KERNELS = ("knn_", "sort", "topk", "gemm", "bitonic")
K1_KERNELS = ("fused_predict_coords",)
K5_KERNELS = ("multiout",)
COPIES = ("memcpy", "memset")


def traced_calls(run):
    """The calls answered inside the traced window."""
    return [c for c in run.calls if c.ok]


def search_ops(trace):
    """The neighbour search's device activities: those launched inside the
    harness's ``search`` span (an index's own searches) and those whose
    kernel the table names."""
    ids = {id(op) for op in trace.select(names=SEARCH_KERNELS)}
    ids |= {id(op) for op in trace.select(span="search")}
    return [op for op in trace.ops if id(op) in ids]


def is_copy(op) -> bool:
    return any(k in op.name.lower() for k in COPIES)


def roofline_share(trace, names, ops, nbytes):
    """100 x the bound of the named kernel's launches (each of ``ops``
    operations and ``nbytes`` bytes) over their traced time; None where the
    trace holds none."""
    launched = trace.select(names=names)
    seconds = sum(op.seconds for op in launched)
    if not launched or seconds <= 0:
        return None
    return 100.0 * len(launched) * peaks.bound_s(ops, nbytes) / seconds


def k1_shape(run):
    """(n, d, r, bucket) of the serving cell's K1 launches."""
    cfg = run.config
    return cfg["nn_count"], cfg["dim"], 1, run.cell["server"]["bucket"]


def k5_shape(run):
    """(m, o, bucket) of the shear cell's K5 launches."""
    cfg = run.config
    return 3 * cfg["nn_count"], 3, run.cell["server"]["bucket"]


def serve_ops_per_query(run):
    """The GP work of one served query by the frozen counts: K5's for the
    shear model, K1's otherwise."""
    if run.config["kernel"] == "shear":
        m, o, _ = k5_shape(run)
        return counts.k5_flops_per_query(m, o)
    n, d, r, _ = k1_shape(run)
    return counts.k1_ops_per_query(n, d, r)

