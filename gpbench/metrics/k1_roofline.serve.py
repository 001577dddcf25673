"""K1's share of its roofline: the bound of each traced launch (the frozen
operation and byte counts at the bucket, over the H100's peaks) over K1's
traced time."""

from gpbench.harness import readings
from gpbench.roofline import counts


def read(run):
    if run.trace is None:
        return None
    n, d, r, bucket = readings.k1_shape(run)
    return readings.roofline_share(
        run.trace, readings.K1_KERNELS,
        counts.k1_ops_per_query(n, d, r) * bucket,
        counts.k1_bytes(n, d, r, bucket))
