"""Device milliseconds a request in the fast-mean bucket's serve step:
the union of the device activities from each bucket's last search kernel
to its readback (``gpbench.harness.contraction``: the gathers, the
crosswise distances, the kernel, the contraction), over the traced
requests."""

from gpbench.harness import contraction, readings


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not calls:
        return None
    ops, _ = contraction.contraction_ops(run.trace)
    if not ops:
        return None
    return 1e3 * run.trace.busy_s(ops) / len(calls)
