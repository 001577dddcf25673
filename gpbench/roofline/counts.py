"""Operations and bytes of the kernels the cells time, counted from shapes.

A frozen copy of the arithmetic of ``chip_smoke.py`` (``k1_ops_per_query``,
``k2_ops_per_point``, ``k5_flops_per_query`` and the byte rules beside
them), kept here so that no change to the program moves the yardstick.
Operations are float32 operations, exp, log and sqrt counted as one each;
bytes count each input read once and each output written once, whatever
the kernel reads again.  ``tests/test_gpbench_roofline.py`` holds these
functions equal to the originals at the cells' shapes.
"""

from __future__ import annotations

F32_BYTES = 4


def k1_ops_per_query(n, d, r, eval_ops=6.0, coords=True):
    """Operations of one K1 query (the coordinates solve): the symmetric
    kernel matrix's n(n+1)/2 entries and the n crosswise ones, each
    assembled from coordinates and evaluated (6 operations for a closed
    form), the elimination of the augmented ``[K | kc | y]`` system, and
    the mean and variance."""
    m = n + 1 + r
    kernel_entries = n * (n + 1) // 2 + n
    assembly = kernel_entries * ((3 * d + 1 if coords else 1) + eval_ops)
    elimination = sum(
        (m - j) + (n - 1 - j) + 2 * (n - 1 - j) * (m - 1 - j) + 1
        for j in range(n)
    )
    return assembly + elimination + 2 * n * (r + 1)


def k1_bytes(n, d, r, batch):
    """Bytes of one K1 launch over ``batch`` queries: the neighbours'
    coordinates and targets, the query, the mean and variance written, and
    the parameter vector."""
    return (n * d + d + n * r + r + 1) * F32_BYTES * batch + (d + 1) * F32_BYTES


def k2_ops_per_point(n, d_feat, r, noise_free, eval_ops=9.0, nu_free=False):
    """Operations of one K2 point: ``n(n+1)/2 + n`` evaluations of the
    kernel and its derivative fields, the Cholesky factor, the solves, the
    statistics, a second factorization when the noise is free (the stored
    noise's), and the derivative contractions of each group."""
    dd = d_feat or 1
    scale = 3 * d_feat + 1 if d_feat else 1
    evaluation = scale + eval_ops + (4 * dd if d_feat else 2)
    chol = sum((n - j) * 2 * j + (n - j) for j in range(n)) + 2 * n
    solves = 2 * (1 + r) * n * n
    stats = 2 * n * (2 * r + 1)
    second = (chol + 2 * r * n * n + 2 * n * r) if noise_free else 0
    per_group = 2 * n * n + 4 * n * r + 4 * n + r * (2 * n * n + 2 * n)
    noise_rows = 2 * n * (r + 1)
    return ((n * (n + 1) // 2 + n) * evaluation + chol + solves + stats
            + second + (dd + nu_free) * per_group + noise_rows)


def k2_rows(r, ls_groups=1, noise_free=True, nu_free=False):
    """Rows K2 writes per point: mean (r), var and q; each length-scale
    group's (r + 2); the noise's (r + 1) when it is free; the smoothness's
    (r + 2) when it is free."""
    return (r + 2 + ls_groups * (r + 2) + (r + 1 if noise_free else 0)
            + (r + 2 if nu_free else 0))


def k2_bytes(n, r, batch, rows):
    """Bytes of one K2 launch over ``batch`` points from distances: the
    symmetric pairwise distances (n(n+1)/2 rows), the crosswise ones, the
    neighbours' targets, the ``rows`` output rows and the three
    parameters."""
    return ((n * (n + 1) // 2 + n + n * r + rows) * batch + 3) * F32_BYTES


def k5_flops_per_query(m, o):
    """Operations of one K5 query: per pivot the sqrt and reciprocal, the
    scaled row and column, a multiply and a subtract over the trailing
    block of the augmented matrix; then the o + o^2 dot products."""
    W = m + o + 1
    elimination = sum(
        2 + (W - j) + (m - 1 - j) + 2 * (m - 1 - j) * (W - 1 - j)
        for j in range(m)
    )
    return elimination + 2 * m * (o + o * o) + m


def k5_bytes(m, o, batch):
    """Bytes of one K5 launch over ``batch`` queries: the (m, m) block
    matrix, the (m, o) crosswise block, the m targets, the mean and the
    (o, o) covariance written."""
    return (m * m + m * o + m + o + o * o) * F32_BYTES * batch
