"""K1's share of its roofline under a general Matérn order: the bound of
each traced launch (the frozen operation count of K1 under ``"gen"`` at the
cell's branch shares, ``roofline/k1gen_counts.py``, and K1's bytes with the
coefficient vector, over the H100's peaks) over K1's traced time."""

from gpbench.harness import readings
from gpbench.roofline import k1gen_counts


def read(run):
    if run.trace is None:
        return None
    n, d, r, bucket = readings.k1_shape(run)
    return readings.roofline_share(
        run.trace, readings.K1_KERNELS,
        k1gen_counts.k1gen_ops_per_query(n, d, r) * bucket,
        k1gen_counts.k1gen_bytes(n, d, r, bucket))
