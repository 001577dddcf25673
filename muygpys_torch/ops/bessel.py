"""Modified Bessel function of the second kind, K_nu, in plain tensor code.

Counterpart of :mod:`muygpys_tpu.ops.bessel`: ``kve(v, x) = exp(x) K_v(x)``
for real order by the classical two-regime algorithm (Temme's series for
``x <= 2``, Steed's CF2 continued fraction above, forward recurrence in the
order), with FIXED iteration counts and no data-dependent exit, so the same
code runs elementwise on any device and under forward-mode differentiation.

Gradients: :func:`kve` is a ``torch.autograd.Function``.

- ``d/dx kve(v, x) = kve(v, x) - (kve(v-1, x) + kve(v+1, x)) / 2`` (the
  exact three-term identity);
- ``d/dv`` by forward-mode differentiation THROUGH the algorithm
  (``torch.func.jvp`` over :func:`_kve_raw`): every Temme/CF2 recurrence is
  a smooth function of the fractional order ``mu = v - round(v)`` and
  ``floor`` carries no tangent, so the tangent of the truncated series is
  the analytically differentiated truncated series.  No finite differences.

Forward-mode callers (the coefficient constructor of
:mod:`muygpys_torch.gpu.matern_nu`) differentiate :func:`_kve_raw` directly:
it is plain tensor operations.
"""

from __future__ import annotations

import math

import torch

_EULER_GAMMA = 0.5772156649015328606
# Taylor coefficients of 1/Gamma(1+u) = 1 + a1 u + a2 u^2 + a3 u^3 + ...
_A3 = (
    _EULER_GAMMA**3 / 6.0
    - _EULER_GAMMA * math.pi**2 / 12.0
    + 0.4006856343865314  # zeta(3)/3
)
_A2 = (_EULER_GAMMA**2 - math.pi**2 / 6.0) / 2.0

_TEMME_ITERS = 24
_CF2_ITERS = 80
_RECUR_MAX = 64  # supports orders up to ~64; GP smoothness is O(1)


def _reciprocal_gamma_sym(mu):
    """``(gam1, gam2)`` with ``gam1 = (1/G(1-mu) - 1/G(1+mu)) / (2 mu)`` and
    ``gam2 = (1/G(1-mu) + 1/G(1+mu)) / 2``, stable at ``mu -> 0`` (a Taylor
    branch under ``|mu| < 1e-6``).  ``|mu| <= 0.5``."""
    small = torch.abs(mu) < 1e-6
    mu_safe = torch.where(small, torch.full_like(mu, 0.25), mu)
    rg_p = torch.exp(-torch.lgamma(1.0 + mu_safe))
    rg_m = torch.exp(-torch.lgamma(1.0 - mu_safe))
    gam1_direct = (rg_m - rg_p) / (2.0 * mu_safe)
    gam2_direct = (rg_m + rg_p) / 2.0
    gam1_taylor = -(_EULER_GAMMA + _A3 * mu * mu)
    gam2_taylor = 1.0 + _A2 * mu * mu
    return (
        torch.where(small, gam1_taylor, gam1_direct),
        torch.where(small, gam2_taylor, gam2_direct),
    )


def _kve_temme(mu, x):
    """``exp(x) (K_mu(x), K_{mu+1}(x))`` by Temme's series; valid x <= 2."""
    x = torch.clamp_min(x, 1e-30)
    x2 = 0.5 * x
    pimu = math.pi * mu
    small_pimu = torch.abs(pimu) < 1e-6
    one = torch.ones_like(pimu)
    fact = torch.where(
        small_pimu, one, pimu / torch.sin(torch.where(small_pimu, one, pimu))
    )
    d = -torch.log(x2)
    e = mu * d
    small_e = torch.abs(e) < 1e-6
    one_e = torch.ones_like(e)
    fact2 = torch.where(
        small_e, one_e, torch.sinh(e) / torch.where(small_e, one_e, e)
    )
    gam1, gam2 = _reciprocal_gamma_sym(mu)
    gampl = gam2 - mu * gam1  # 1/Gamma(1+mu)
    gammi = gam2 + mu * gam1  # 1/Gamma(1-mu)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    total = ff
    ee = torch.exp(e)
    p = 0.5 * ee / gampl
    q = 0.5 / (ee * gammi)
    c = torch.ones_like(x)
    d2 = x2 * x2
    total1 = p
    mu2 = mu * mu
    for i in range(1, _TEMME_ITERS + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu2)
        c = c * d2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        total = total + c * ff
        total1 = total1 + c * (p - fi * ff)
    scale = torch.exp(x)
    return total * scale, total1 * (2.0 / x) * scale


def _kve_cf2(mu, x):
    """``exp(x) (K_mu(x), K_{mu+1}(x))`` by Steed's CF2; valid x > 2.

    The products ``u = c q1`` and ``w = c q2`` of the textbook recurrence
    grow without bound for large ``x`` (they overflow f32 near iteration 79
    at x ~ 18), so each element FREEZES once its continued fraction has
    converged (``|delh| <= eps |h|``) or its auxiliaries approach the
    overflow threshold: by then the remaining contributions are below
    roundoff.  The iteration count stays fixed."""
    dtype = x.dtype
    # freeze threshold well below eps, so the f64 result equals the
    # unfrozen one; the overflow guard is what rescues f32 at large x
    eps = torch.finfo(dtype).eps * 0.01
    big = torch.finfo(dtype).max * 1e-8
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    a1 = 0.25 - mu * mu
    ones = torch.ones_like(x)
    q = a1 * ones
    a = -a1 * ones
    s = 1.0 + q * delh
    u = torch.zeros_like(x)  # c * q1
    w = a1 * ones  # c * q2
    done = torch.zeros_like(x, dtype=torch.bool)
    for i in range(2, _CF2_ITERS + 1):
        fi = float(i)
        a_n = a - 2.0 * (fi - 1.0)
        contrib = -(u - b * w) / fi  # = c_new * q_new
        q_n = q + contrib
        u_n = -a_n * w / fi  # = c_new * q1_new
        w_n = contrib  # = c_new * q2_new
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        s_n = s + q_n * delh_n
        a, b, d, h, delh, q, u, w, s = (
            torch.where(done, old, new)
            for new, old in (
                (a_n, a), (b_n, b), (d_n, d), (h_n, h), (delh_n, delh),
                (q_n, q), (u_n, u), (w_n, w), (s_n, s),
            )
        )
        done = (
            done
            | (torch.abs(delh_n) <= eps * torch.abs(h_n))
            | (torch.maximum(torch.abs(u_n), torch.abs(w_n)) > big)
        )
    h = a1 * h
    kmu = torch.sqrt(math.pi / (2.0 * x)) / s  # already exp(x)-scaled
    kmu1 = kmu * (mu + x + 0.5 - h) / x
    return kmu, kmu1


def _kve_raw(v, x):
    """``exp(x) K_v(x)`` for real order, elementwise over ``x``; plain
    tensor operations (``v`` broadcasts against ``x``)."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    v = torch.abs(v)  # K_{-v} = K_v
    n = torch.floor(v + 0.5)
    mu = v - n  # in [-0.5, 0.5)

    k_s, k1_s = _kve_temme(mu, torch.clamp_max(x, 2.0))
    k_b, k1_b = _kve_cf2(mu, torch.clamp_min(x, 2.0))
    use_small = x <= 2.0
    kprev = torch.where(use_small, k_s, k_b)
    kcur = torch.where(use_small, k1_s, k1_b)

    x_safe = torch.clamp_min(x, 1e-30)
    for i in range(1, _RECUR_MAX):
        fi = float(i)
        knext = kprev + (2.0 * (mu + fi) / x_safe) * kcur
        climb = fi <= n - 1.0
        kprev = torch.where(climb, kcur, kprev)
        kcur = torch.where(climb, knext, kcur)
    return torch.where(n == 0.0, kprev, kcur)


def _sum_to(grad, like):
    """Reduce a broadcast gradient back to the shape of ``like``."""
    return grad.sum_to_size(like.shape) if grad.shape != like.shape else grad


class _Kve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, x):
        out = _kve_raw(v, x)
        ctx.save_for_backward(v, x, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        v, x, out = ctx.saved_tensors
        grad_v = grad_x = None
        if ctx.needs_input_grad[1]:
            dx = out - 0.5 * (_kve_raw(v - 1.0, x) + _kve_raw(v + 1.0, x))
            grad_x = _sum_to(grad_out * dx, x)
        if ctx.needs_input_grad[0]:
            # at least one dimension: a 0-d dual tensor times a Python
            # number takes its tangent to f64 under forward mode
            v1 = v.reshape(1) if v.ndim == 0 else v
            _, dv = torch.func.jvp(
                lambda vv: _kve_raw(vv, x), (v1,), (torch.ones_like(v1),)
            )
            grad_v = _sum_to(grad_out * dv, v)
        return grad_v, grad_x


def kve(v, x):
    """Exponentially scaled modified Bessel of the second kind,
    ``exp(x) K_v(x)``, differentiable in ``x`` and in the order ``v``."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    return _Kve.apply(v, x)


def kv(v, x):
    """Modified Bessel of the second kind ``K_v(x)``."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return kve(v, x) * torch.exp(-x)
