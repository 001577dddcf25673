"""Device milliseconds a request in the kernels that are neither the
neighbour search's nor K5 (the shear blocks, the nugget, the gathers),
copies left out, over the traced requests."""

from gpbench.harness import readings


def read(run):
    calls = readings.traced_calls(run)
    if run.trace is None or not calls:
        return None
    search = {id(op) for op in readings.search_ops(run.trace)}
    k5 = {id(op) for op in run.trace.select(names=readings.K5_KERNELS)}
    ops = [op for op in run.trace.ops if id(op) not in search
           and id(op) not in k5 and not readings.is_copy(op)]
    if not ops:
        return None
    return 1e3 * run.trace.busy_s(ops) / len(calls)
