"""Device milliseconds a request in the neighbour search: the union of
the search's device activities (the harness's ``search`` span and the
kernel table of ``gpbench.harness.readings``) over the traced requests."""

from gpbench.harness import readings


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not calls:
        return None
    ops = readings.search_ops(run.trace)
    if not ops:
        return None
    return 1e3 * run.trace.busy_s(ops) / len(calls)
