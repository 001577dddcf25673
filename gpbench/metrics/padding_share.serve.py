"""The share of the traced window's bucket slots that the edge pad filled:
100 x (1 - queries answered / (the program's ``muygpys.serve.stage``
spans x the bucket))."""

from gpbench.harness import program, readings


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not calls:
        return None
    stages = program.spans(run.trace, "muygpys.serve.stage")
    if not stages:
        return None
    slots = len(stages) * run.cell["server"]["bucket"]
    return 100.0 * (1.0 - sum(c.size for c in calls) / slots)
