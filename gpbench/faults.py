"""Faults planted underneath the timed path, to show that the comparison
that decides ``correct`` catches them.  Each is ``plant(entry)``, handed
to :func:`gpbench.harness.core.run_cell` as ``fault=``; it breaks the
entry it is given and nothing else.

- ``answer``: an answer altered where it is produced: each request's first
  mean moved by 1.0, the field's amplitude;
- ``half``: half of the batch left out: a request's second half answered
  with its first half's answers.
"""

from __future__ import annotations

import numpy as np


def answer(entry):
    call = entry.call

    def altered(request):
        out = call(request)
        mean = np.array(out[0], copy=True)
        mean[0] += 1.0
        return (mean,) + tuple(out[1:])

    entry.call = altered


def half(entry):
    call = entry.call

    def halved(request):
        out = call(request)
        k = (len(request) + 1) // 2
        return tuple(np.concatenate([o[:k], o[:len(o) - k]]) for o in out)

    entry.call = halved


FAULTS = {"answer": answer, "half": half}
