"""The 95th percentile of every request of the window, from the call of
``predict`` to the outputs in hand as numpy; a failed request counts as
missing every limit."""

import math

import numpy as np


def read(run):
    ms = [c.seconds * 1e3 if c.ok else math.inf for c in run.calls]
    return float(np.percentile(ms, 95))
