"""The whole request's share of the chip's float32 peak under a general
Matérn order: the GP work every implementation must do for the queries
answered (the frozen count of K1 under ``"gen"`` a query,
``roofline/k1gen_counts.py``; the neighbour search not counted) over the
traced window's seconds and 67 TFLOP/s."""

from gpbench.harness import readings
from gpbench.roofline import k1gen_counts, peaks


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not run.trace.ops or not calls:
        return None
    n, d, r, _ = readings.k1_shape(run)
    ops = k1gen_counts.k1gen_ops_per_query(n, d, r) * sum(
        c.size for c in calls)
    return 100.0 * ops / (run.trace.window_s * peaks.FP32_FLOPS)
