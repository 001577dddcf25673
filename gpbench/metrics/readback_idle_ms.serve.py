"""Device-idle milliseconds a request inside the program's
``muygpys.serve.readback`` spans (each bucket's outputs copied back to the
host, the wait for the device included), over the traced requests."""

from gpbench.harness import program, readings


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not run.trace.ops or not calls:
        return None
    readbacks = program.spans(run.trace, "muygpys.serve.readback")
    if not readbacks:
        return None
    return 1e3 * program.idle_inside(run.trace, readbacks) / len(calls)
