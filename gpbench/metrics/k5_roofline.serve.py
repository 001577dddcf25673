"""K5's share of its roofline: the bound of each traced launch (the frozen
operation and byte counts at the bucket, over the H100's peaks) over K5's
traced time."""

from gpbench.harness import readings
from gpbench.roofline import counts


def read(run):
    if run.trace is None:
        return None
    m, o, bucket = readings.k5_shape(run)
    return readings.roofline_share(
        run.trace, readings.K5_KERNELS,
        counts.k5_flops_per_query(m, o) * bucket,
        counts.k5_bytes(m, o, bucket))
