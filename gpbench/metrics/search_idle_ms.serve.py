"""Device-idle milliseconds a request inside the program's
``muygpys.nn.get_nns`` spans (the neighbour index's searches), over the
traced requests."""

from gpbench.harness import program, readings


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not run.trace.ops or not calls:
        return None
    searches = program.spans(run.trace, "muygpys.nn.get_nns")
    if not searches:
        return None
    return 1e3 * program.idle_inside(run.trace, searches) / len(calls)
