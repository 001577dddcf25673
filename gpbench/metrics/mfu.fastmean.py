"""The whole request's share of the chip's float32 peak under the fast
mean: the frozen operation count of a query's serve step (the search not
counted, as in ``mfu.serve``) times the queries answered, over the traced
window's seconds and 67 TFLOP/s."""

from gpbench.harness import readings
from gpbench.roofline import fastmean_counts, peaks


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not run.trace.ops or not calls:
        return None
    cfg = run.config
    ops = fastmean_counts.ops_per_query(cfg["nn_count"], cfg["dim"], 1)
    return (100.0 * ops * sum(c.size for c in calls)
            / (run.trace.window_s * peaks.FP32_FLOPS))
