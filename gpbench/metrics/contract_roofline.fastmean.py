"""The fast-mean serve step's share of its roofline: the bound of each
traced bucket (the frozen operation and byte counts of a query, times the
bucket, over the H100's peaks) over the traced time of the buckets'
serve steps (``gpbench.harness.contraction``)."""

from gpbench.harness import contraction
from gpbench.roofline import fastmean_counts, peaks


def read(run):
    if run.trace is None:
        return None
    ops, buckets = contraction.contraction_ops(run.trace)
    seconds = run.trace.busy_s(ops)
    if not buckets or seconds <= 0:
        return None
    cfg, bucket = run.config, run.cell["server"]["bucket"]
    n, d, r = cfg["nn_count"], cfg["dim"], 1
    bound = peaks.bound_s(fastmean_counts.ops_per_query(n, d, r) * bucket,
                          fastmean_counts.bytes_per_query(n, d, r) * bucket)
    return 100.0 * buckets * bound / seconds
