"""Seconds from the start of the process to the first timed call: imports,
the card's context, the data, the index and server (and on a checkout's
first run the kernels' build), the warm-up."""


def read(run):
    return run.setup_s
