"""Operations and bytes of one query of the fast posterior mean's serve
step, counted from shapes: frozen here, so that no change to how the
program gathers, evaluates or contracts moves the yardstick.

A query with its nearest training point's neighbourhood of ``n`` points
in ``d`` dimensions and ``r`` responses: ``n`` crosswise distances
(``3d + 1`` operations each: the differences, their squares and sum, the
square root), ``n`` Matérn evaluations (6 each, a closed form, as
``counts.k1_ops_per_query`` counts one) and the contraction against the
coefficients (``2nr``).  Bytes count each input read once and each output
written once, in float32 (ids in 4 bytes): the ``n`` neighbour ids, their
``n d`` coordinates, the ``n r`` coefficients, the query's ``d``
coordinates and the ``r`` means.  The search for the nearest point is not
counted, as ``mfu.serve`` leaves out the search.
"""

from __future__ import annotations

F32_BYTES = 4
EVAL_OPS = 6


def ops_per_query(n, d, r):
    return n * (3 * d + 1) + n * EVAL_OPS + 2 * n * r


def bytes_per_query(n, d, r):
    return (n + n * d + n * r + d + r) * F32_BYTES
