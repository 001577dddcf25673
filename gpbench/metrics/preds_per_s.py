"""Queries answered in the window over the window's seconds; a failed
request answers none."""


def read(run):
    answered = sum(c.size for c in run.calls if c.ok)
    return answered / run.window_s
