"""Host milliseconds a request in the program's ``muygpys.serve.stage``
spans: each bucket's slice, edge pad and copy to the card, over the
traced requests."""

from gpbench.harness import program, readings


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not calls:
        return None
    stages = program.spans(run.trace, "muygpys.serve.stage")
    if not stages:
        return None
    return 1e3 * sum(e - s for s, e in stages) / len(calls)
