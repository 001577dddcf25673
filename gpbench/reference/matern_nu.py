"""Plain reference of a Matérn Gaussian process of any smoothness ν over
nearest neighbours: the correlation from its Bessel-function definition,
and the posterior mean and variance of each query from its neighbourhood.

    φ_ν(t) = 2^{1-ν} / Γ(ν) · t^ν · K_ν(t),   t = √(2ν) · d / ℓ,   φ(0) = 1

with the modified Bessel function of the second kind taken from its
integral representation (DLMF 10.32.9)

    K_ν(t) = ∫_0^∞ exp(-t cosh s) cosh(ν s) ds

by the trapezoid rule on ``s = 0, h, 2h, ..., S``.  The integrand is even
and analytic in the strip |Im s| < π/2, where it still decays, so the rule
converges geometrically in 1/h: its relative error is about
exp(-2π δ / h + t (1 - cos δ)) (cos δ)^{-ν} for any 0 < δ < π/2, which
at ``STEP`` h = 0.1 and δ = 1 is below 1e-19 for every t ≤ 40 and ν ≤ 4.
The integrand is evaluated as t^ν cosh(ν s) exp(-t cosh s) =
exp(E(s)) (1 + e^{-2ν s}) / 2 with E(s) = ν (ln t + s) - t cosh s, whose
largest value, at sinh s* = ν / t, is below (2ν / e)^ν whatever t is, so
neither precision overflows.  Past s* + Δ, E has fallen by at least
ν (sinh Δ - Δ) + t (cosh Δ - 1), and falls faster after; at
Δ = ln(200/ν + 20) that is more than 80, so the rule stops at
S = asinh(ν / t) + Δ (the smallest t of each chunk of elements sets it),
and the terms it leaves out are below e^-80 of the largest.  For
t ≥ ``T_MIN`` = 1e-13 and ν in [0.05, 10] S stays under 37; a smaller
nonzero t is refused rather than misjudged.  Distinct float32 points of
the unit square lie at least 2^-24 apart, so at the cells' length scales
t stays above 1e-5; coincident points (a neighbourhood's diagonal) are
exactly ``φ(0) = 1``.

Nothing of the program's own mathematics is used: no series, recurrence or
continued fraction of a Bessel function, no Chebyshev fit.  The posterior
is ``reference/matern.py``'s, with this correlation: distances by direct
differences (its ``_dist``), ``K + noise I`` (its ``nugget``) factored by
a dense Cholesky solve per neighbourhood, in blocks of queries; under the
control's precision the factorisation runs in float32 and every operand of
the solve's products is read as TF32's products read it
(``reference/precision.py``).
"""

from __future__ import annotations

import math

import torch

from gpbench.reference.matern import _dist, nugget
from gpbench.reference.precision import matmul_operand as op

STEP = 0.1
T_MIN = 1e-13
# elements of t evaluated at once: the (elements, nodes) exponent is the
# largest temporary, at most 2^18 x 371 float64 values (780 MB)
CHUNK = 1 << 18


def _nodes(nu: float, t_min: float, dtype, device):
    """The rule's nodes ``s`` up to the cut-off of the smallest ``t``, and
    each node's weight times ``(1 + e^{-2νs}) / 2``."""
    cut = math.asinh(nu / t_min) + math.log(200.0 / nu + 20.0)
    count = int(math.ceil(cut / STEP)) + 1
    s = torch.arange(count, dtype=torch.float64) * STEP
    w = torch.full((count,), STEP, dtype=torch.float64)
    w[0] = 0.5 * STEP
    w = w * 0.5 * (1.0 + torch.exp(-2.0 * nu * s))
    return (s.to(dtype=dtype, device=device),
            w.to(dtype=dtype, device=device))


def phi(t: torch.Tensor, nu: float) -> torch.Tensor:
    """φ_ν(t) elementwise, in ``t``'s dtype; 1 where t is 0."""
    nu = float(nu)
    flat = t.reshape(-1)
    zero = flat == 0
    if bool(torch.any((flat < T_MIN) & ~zero)):
        raise ValueError(f"the quadrature holds for t = 0 or t >= {T_MIN}")
    front = 2.0 ** (1.0 - nu) / math.gamma(nu)
    out = torch.ones_like(flat)
    for at in range(0, flat.shape[0], CHUNK):
        tc = flat[at:at + CHUNK]
        live = tc[tc > 0]
        if live.numel() == 0:
            continue
        s, w = _nodes(nu, float(live.min()), t.dtype, t.device)
        cosh, ns = torch.cosh(s), nu * s
        lt = torch.log(torch.where(tc > 0, tc, torch.ones_like(tc)))
        e = torch.exp(nu * lt[:, None] + ns[None, :]
                      - tc[:, None] * cosh[None, :])
        # an elementwise sum, not a product: the control's TF32 rounds the
        # solve's products, not the correlation
        out[at:at + CHUNK] = front * torch.sum(e * w, dim=1)
    return torch.where(zero, torch.ones_like(out), out).reshape(t.shape)


def matern_nu(r: torch.Tensor, length_scale, nu: float) -> torch.Tensor:
    """The Matérn correlation of distances ``r`` at smoothness ``nu``;
    exactly 1 where ``r`` is ``_dist``'s floor (coincident points)."""
    t = math.sqrt(2.0 * nu) * r / length_scale
    floor = math.sqrt(torch.finfo(r.dtype).tiny)
    return phi(torch.where(r <= floor, torch.zeros_like(t), t), nu)


def neighbourhoods(train_x, train_y, nn_idx, queries, length_scale, nu):
    """``(K, kc, y)`` of each query: ``(Q, n, n)``, ``(Q, n)``, ``(Q, n)``,
    with the noise not yet on K's diagonal."""
    nx = train_x[nn_idx]  # (Q, n, d)
    K = matern_nu(_dist(nx, nx), length_scale, nu)
    kc = matern_nu(_dist(queries[:, None, :], nx)[:, 0, :], length_scale, nu)
    return K, kc, train_y[nn_idx]


def posterior(train_x, train_y, nn_idx, queries, length_scale, noise, nu,
              scale=1.0, block=8192):
    """Posterior mean ``(Q,)`` and variance ``(Q,)`` of each query from
    its neighbours ``nn_idx (Q, n)``, in blocks of queries; NaN where a
    neighbourhood's factorisation fails."""
    means, variances = [], []
    for s in range(0, queries.shape[0], block):
        K, kc, y = neighbourhoods(train_x, train_y, nn_idx[s:s + block],
                                  queries[s:s + block], length_scale, nu)
        L, info = torch.linalg.cholesky_ex(nugget(K, noise))
        rhs = op(torch.stack([kc, y], dim=-1))
        sol = op(torch.cholesky_solve(rhs, op(L)))
        kc = op(kc)
        failed = torch.where(info > 0, torch.nan, 0.0).to(kc.dtype)
        means.append(torch.sum(kc * sol[..., 1], dim=-1) + failed)
        variances.append(scale * (1.0 - torch.sum(kc * sol[..., 0], dim=-1))
                         + failed)
    return torch.cat(means), torch.cat(variances)
