"""The whole request's share of the chip's float32 peak: the GP work every
implementation must do for the queries answered (the frozen K1 count a
query, K5's for the shear model; the neighbour search not counted) over
the traced window's seconds and 67 TFLOP/s."""

from gpbench.harness import readings
from gpbench.roofline import peaks


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not run.trace.ops or not calls:
        return None
    ops = readings.serve_ops_per_query(run) * sum(c.size for c in calls)
    return 100.0 * ops / (run.trace.window_s * peaks.FP32_FLOPS)
