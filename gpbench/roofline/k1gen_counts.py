"""Operations of K1 under ``"gen"`` (a general Matérn order through K4's
coefficients), counted from ``muygpys_torch/gpu/csrc/matern_nu.cuh`` and
frozen here, so that no change to the program moves the yardstick.

One kernel value is ``matern_nu::eval(co[0] * u, ...)`` on one of three
branches (operations as ``counts.py`` counts them: each add, subtract,
multiply, divide, exp and log one; comparisons and selects none):

- ``t <= 0`` (a neighbourhood's diagonal): the multiply ``co[0] * u``, 1;
- ``0 < t <= T0``, the series: that multiply 1, ``w = t^2 / 4`` 2, ``log``
  1, ``mu L`` 1, ``expm1`` as ``exp(z) - 1`` 2 (its 4-term series runs
  only where ``|mu L| < 1e-2``), ``w^n = exp(n L)`` 2, two Horner chains
  of 14 coefficients 2 x 26, ``P + Em w^n Q`` 3: 64;
- ``t > T0``, the tail: that multiply 1, ``s = (t - S_MID) / S_HALF`` 2,
  Clenshaw over the 28 terms f32 serving keeps (``2 s`` once, 27 steps of
  3, then 3) 85, ``- t`` and ``exp`` 2: 90.

K1 evaluates, per query of ``n`` neighbours, the ``n`` diagonal entries,
the ``n (n - 1) / 2`` pairs below it and the ``n`` crosswise entries.  The
shares of pairs and crosswise entries past T0 are the ``sky2d-serve-nu12``
cell's, frozen from the calibration run on the card (the reference's
exact neighbourhoods of the 4 checked requests, 32,768 queries, of each of
3 seeds; the figures beside them).
"""

from __future__ import annotations

from gpbench.roofline import counts

DIAGONAL_OPS = 1
SERIES_OPS = 64
TAIL_OPS = 90
# the calibration run's shares past T0, the mean of three seeds (H100 80GB
# HBM3, seeds 2147484648-50, 32,768 queries each): pairs 0.5474-0.5482,
# crosswise 0.3045-0.3061
PAIR_TAIL_SHARE = 0.5478
CROSS_TAIL_SHARE = 0.3051
# K4's coefficient vector K1 reads, float32 values
COEFF_VALUES = 73


def eval_ops(n: int) -> float:
    """The mean operations of one of K1's ``n (n + 1) / 2 + n`` kernel
    values at the frozen shares."""
    def branch(tail_share):
        return tail_share * TAIL_OPS + (1.0 - tail_share) * SERIES_OPS

    pairs = n * (n - 1) // 2
    total = (n * DIAGONAL_OPS + pairs * branch(PAIR_TAIL_SHARE)
             + n * branch(CROSS_TAIL_SHARE))
    return total / (n * (n + 1) // 2 + n)


def k1gen_ops_per_query(n, d, r):
    return counts.k1_ops_per_query(n, d, r, eval_ops=eval_ops(n))


def k1gen_bytes(n, d, r, batch):
    """``counts.k1_bytes`` and the coefficient vector, read once a launch."""
    return counts.k1_bytes(n, d, r, batch) + COEFF_VALUES * counts.F32_BYTES
