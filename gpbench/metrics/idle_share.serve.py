"""The share of the traced window (host clock) in which no device
activity ran: 100 x (1 - union of device activities / window)."""

from gpbench.roofline import busy


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * busy.idle_share(run.trace.busy_s(), run.trace.window_s)
