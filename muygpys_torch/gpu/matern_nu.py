"""K4: the traced-smoothness general Matern for the fused kernels, its
coefficient constructors and its plain PyTorch version.

Counterpart of :mod:`muygpys_tpu.pallas.matern_nu`.  A modified Bessel
``K_nu`` evaluation per kernel element (the Temme/CF2 recurrences of
:mod:`muygpys_torch.ops.bessel`, ~10^3 operations) is far too expensive
inside a fused kernel, so the work is split:

1. :func:`matern_nu_coeffs` runs OUTSIDE the evaluating kernels (once per
   optimizer step: for a nu on the card one launch of the constructor
   kernel ``csrc/matern_nu_coeffs.cu``, for a nu on the CPU its plain
   version :func:`matern_nu_coeffs_plain`; :func:`matern_nu_coeffs_host` in
   numpy f64, once per server) and compresses the whole nu-dependence of

       phi_nu(t) = 2^{1-nu}/Gamma(nu) t^nu K_nu(t),   t = sqrt(2 nu) d / l

   into ~10^2 scalars: exact power-series coefficients on ``t <= T0`` and a
   Chebyshev fit of ``log(phi e^t)`` on ``[T0, TMAX]``.  With ``need_dnu``
   the nu-tangents of the coefficients, from ONE forward-mode pass through
   the constructor, are appended for the training kernel's d/dnu rows.

2. :func:`matern_nu_eval` evaluates phi (and on request d phi/dt and the
   partial d phi/d nu at fixed t) from those scalars in ~10^2 operations
   per element: two Horner chains, one Clenshaw recurrence and a few
   transcendentals.  On the card this is the device function
   ``csrc/matern_nu.cuh`` inlined in K1, K1b and K2; here it is that
   function's plain version, elementwise tensor code.

Small branch (``w = t^2/4``, ``nu = n + mu`` with ``n`` the nearest integer):

    phi_nu(t) = P(w) + expm1(mu ln w) w^n Q(w)

from the two modified-Bessel-I series of ``K_nu``:

    u_k = (-1)^k / (k! prod_{i=1..k} (nu - i))          [reflection form]
    q_j = -pi / (sin(pi nu) Gamma(nu) j! Gamma(j+1+nu))
    P coefficients: a_k = u_k + q_{k-n} (k >= n; the near-integer 1/sin
    blow-ups of u and q cancel HERE, in the constructor's precision, not in the
    kernel's f32)

Near an integer nu the raw coefficients are singular; the constructor clamps
``|mu| >= MU_CLAMP`` (1e-7 in f64, 1e-2 in f32) GRADIENT-TRANSPARENTLY:
inside the zone the value is phi at the clamped order and the nu-tangent is
the finite tangent at the clamped point.

Certified domain: ``nu in [NU_MIN, NU_MAX] = [0.05, 10]``, any ``t >= 0``
(``phi < 4e-11`` beyond TMAX = 42 for nu <= 10; the tail extrapolates with
the correct ``e^{-t}`` decay).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from muygpys_torch.gpu import _build
from muygpys_torch.ops.bessel import _kve_raw

T0 = 2.0  # series/tail split: the P and Em w^n Q pieces grow ~ e^t/2 each
# while phi decays, so f32 cancellation costs ~ e^{T0} eps / phi(T0)
TMAX = 42.0
KSM = 14  # series terms on t <= T0 (tail term < 1e-12 at t = T0)
NTAIL = 40  # Chebyshev coefficients of log(phi e^t) on [T0, TMAX]
NU_MIN = 0.05
NU_MAX = 10.0
#: tail terms the fused kernels evaluate in f32 (all NTAIL in f64)
TAIL_TERMS_SERVE_F32 = 28
TAIL_TERMS_TRAIN_F32 = 24

SMOOTHNESS_CODES = {0.5: 0, 1.5: 1, 2.5: 2, math.inf: 3, "rbf": 4, "gen": 5}

# the LOG of phi e^t is fitted: for nu >> 1 the pre-asymptotic tail behaves
# like exp(t - t^2/(4 nu)), which no low-degree polynomial captures, while
# its log is smooth and O(30) across the whole nu range
_S_MID = 0.5 * (T0 + TMAX)
_S_HALF = 0.5 * (TMAX - T0)

# flat coefficient-vector layout (static offsets; scalars first)
_N_SCAL = 5  # [sqrt(2 nu), n, mu, nu-tangent gate (1.0), 1/(2 nu)]
_OFF_A = _N_SCAL
_OFF_B = _OFF_A + KSM
_OFF_C = _OFF_B + KSM
_LEN_VAL = _OFF_C + NTAIL  # value-only vector length
# with derivative sets appended: [ap(KSM-1), bp(KSM-1), cp(NTAIL)]
_OFF_AP = _LEN_VAL
_OFF_BP = _OFF_AP + KSM - 1
_OFF_CP = _OFF_BP + KSM - 1
_LEN_DT = _OFF_CP + NTAIL
# with nu-tangent sets appended: [da(KSM), db(KSM), dc(NTAIL)]
_OFF_DA = _LEN_DT
_OFF_DB = _OFF_DA + KSM
_OFF_DC = _OFF_DB + KSM
_LEN_DNU = _OFF_DC + NTAIL
# the sets of the vector by name: (first entry, end)
COEFF_SETS = {
    "scalars": (0, _N_SCAL), "a": (_OFF_A, _OFF_B), "q": (_OFF_B, _OFF_C),
    "c": (_OFF_C, _LEN_VAL), "ap": (_OFF_AP, _OFF_BP), "bp": (_OFF_BP, _OFF_CP),
    "cp": (_OFF_CP, _LEN_DT), "da": (_OFF_DA, _OFF_DB), "db": (_OFF_DB, _OFF_DC),
    "dc": (_OFF_DC, _LEN_DNU),
}

_FACT = np.array([math.factorial(k) for k in range(KSM)], np.float64)
_LOG_FACT = np.array([math.lgamma(k + 1) for k in range(KSM)], np.float64)

# Chebyshev-Gauss interpolation matrix: c = _CHEB_MAT @ h(nodes)
_theta = np.pi * (np.arange(NTAIL) + 0.5) / NTAIL
_NODES_S = np.cos(_theta)  # s in (-1, 1)
_CHEB_MAT = (2.0 / NTAIL) * np.cos(np.outer(np.arange(NTAIL), _theta))
_CHEB_MAT[0] *= 0.5
_NODES_T = _S_MID + _S_HALF * _NODES_S


def check_smoothness(what, smoothness, gen_coeffs, metric_power, need) -> int:
    """The kernels' smoothness code; raises on what they do not take: a bare
    non-closed-form order, ``"gen"`` without at least ``need`` coefficients
    or off the l2 metric."""
    if isinstance(smoothness, torch.Tensor) or smoothness not in SMOOTHNESS_CODES:
        raise ValueError(
            f"{what} supports smoothness 0.5/1.5/2.5/inf/'rbf'/'gen'; got "
            f"{smoothness!r} (pass any other order as 'gen' with its "
            "matern_nu_coeffs vector)"
        )
    if metric_power not in (1, 2):
        raise ValueError(f"metric_power must be 1 or 2, got {metric_power}")
    if smoothness == "gen":
        if gen_coeffs is None:
            raise ValueError('smoothness="gen" requires gen_coeffs')
        if metric_power != 1:
            raise ValueError('smoothness="gen" requires the l2 metric')
        if len(gen_coeffs) < need:
            raise ValueError(
                f'{what}: smoothness="gen" needs {need} coefficients, got '
                f"{len(gen_coeffs)}"
            )
    return SMOOTHNESS_CODES[smoothness]


def _cheb_deriv_coeffs(c):
    """d/ds coefficients of a Chebyshev series (the standard recurrence)
    over a sequence of scalars (or one-element tensors); returns a list as
    long as ``c``."""
    nt = len(c)
    d = [None] * (nt + 1)
    d[nt] = d[nt - 1] = c[0] * 0.0
    for k in range(nt - 1, 0, -1):
        d[k - 1] = d[k + 1] + 2.0 * k * c[k]
    d[0] = 0.5 * d[0]
    return d[:nt]


def _clamp_offset(nu):
    """The offset that moves ``mu = nu - round(nu)`` out of the clamp zone
    (0 outside it), as a constant: it carries neither a gradient nor a
    forward-mode tangent, so d mu_eff / d nu = 1 everywhere."""
    nu = nu.detach()
    mu = nu - torch.floor(nu + 0.5)
    clamp = 1e-7 if nu.dtype == torch.float64 else 1e-2
    sign = torch.where(mu >= 0.0, 1.0, -1.0).to(nu.dtype)
    return torch.where(
        torch.abs(mu) < clamp, sign * clamp - mu, torch.zeros_like(mu)
    )


def _build_value_coeffs(nu, delta):
    """All phi_nu coefficients as one flat vector (length ``_LEN_DT``) in the
    dtype of ``nu`` (a one-element tensor), with
    ``delta = _clamp_offset(nu)``.

    Smooth in ``nu``, so forward mode through this function yields the exact
    nu-tangent coefficient sets.  Every intermediate keeps at least one
    dimension: under forward mode a 0-d dual tensor times a Python number
    takes its tangent to f64, and an f32 build must stay f32 throughout."""
    dtype, dev = nu.dtype, nu.device

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    n = torch.floor(nu + 0.5)
    # GRADIENT-TRANSPARENT clamp: inside the zone the value is phi at the
    # clamped order while the nu-tangent is the (finite) tangent AT the
    # clamped point.  A where()-style clamp would freeze the tangent to
    # zero, and an optimizer started at an integer nu would see no slope.
    mu_eff = (nu - n) + delta
    nu_eff = n + mu_eff

    # u_k = (-1)^k / (k! prod_{i=1..k}(nu - i)), with (nu - i) formed as
    # mu + (n - i): adding the exact integer n - i keeps mu's full
    # precision, where n + mu - i would absorb mu into the integer part
    # and poison the near-integer cancellation a_k = u_k + q_{k-n}
    ks = torch.arange(1, KSM, dtype=dtype, device=dev)
    prods = torch.cumprod(mu_eff + (n - ks), dim=0)
    sign = const((-1.0) ** np.arange(1, KSM))
    u = torch.cat(
        [torch.ones((1,), dtype=dtype, device=dev),
         sign / (const(_FACT[1:]) * prods)]
    )

    # q_j = -pi / (sin(pi nu) Gamma(nu) j! Gamma(j+1+nu)); sin(pi nu) as
    # (-1)^n sin(pi mu) for full accuracy near integers
    js = torch.arange(KSM, dtype=dtype, device=dev)
    log_mag = (
        -torch.lgamma(nu_eff) - torch.lgamma(js + 1.0 + nu_eff)
        - const(_LOG_FACT)
    )
    sin_pinu = (1.0 - 2.0 * torch.remainder(n, 2.0)) * torch.sin(
        math.pi * mu_eff
    )
    q = -(math.pi / sin_pinu) * torch.exp(log_mag)

    # merged regular part: a_k = u_k + q_{k-n} for k >= n
    idx = torch.arange(KSM, device=dev)
    n_int = n.detach().to(torch.int64)
    shifted = q[torch.clamp(idx - n_int, 0, KSM - 1)]
    a = u + torch.where(idx >= n_int, shifted, torch.zeros_like(shifted))

    # tail: Chebyshev fit of g(t) = log(phi e^t) at fixed t-nodes
    t_nodes = const(_NODES_T)
    log_pref = (1.0 - nu_eff) * math.log(2.0) - torch.lgamma(nu_eff)
    g = (
        log_pref + nu_eff * torch.log(t_nodes)
        + torch.log(_kve_raw(nu_eff, t_nodes))
    )
    c = const(_CHEB_MAT) @ g

    # argument-derivative sets: P'(w), Q'(w) Horner coefficients and the
    # Chebyshev d/ds coefficients of the tail
    kp = torch.arange(1, KSM, dtype=dtype, device=dev)
    ap = kp * a[1:]
    bp = kp * q[1:]
    cp = torch.cat(_cheb_deriv_coeffs(c.split(1)))

    scal = torch.cat(
        [
            torch.sqrt(2.0 * nu_eff),
            n,
            mu_eff,
            # nu-tangent gate (slot 3): 1 everywhere, the clamp being
            # gradient-transparent
            torch.ones_like(nu_eff),
            0.5 / nu_eff,
        ]
    )
    return torch.cat([scal, a, q, c, ap, bp, cp])


def _as_nu(nu):
    """``nu`` as a one-element floating tensor (a Python float in f64 on the
    CPU)."""
    if not isinstance(nu, torch.Tensor):
        nu = torch.tensor(float(nu), dtype=torch.float64)
    if not nu.is_floating_point():
        nu = nu.to(torch.float32)
    return nu.reshape(1)


def matern_nu_coeffs_plain(nu, need_dnu: bool = False):
    """Plain PyTorch version of the constructor kernel: the flat coefficient
    vector in the dtype and on the device of ``nu``, built by tensor
    operations (~12,000 of them on a card), the nu-tangent sets from one
    forward-mode pass; differentiable in ``nu`` by ``torch.autograd``
    without ``need_dnu``."""
    nu = _as_nu(nu)
    delta = _clamp_offset(nu)
    if not need_dnu:
        return _build_value_coeffs(nu, delta)
    co, dco = torch.func.jvp(
        lambda v: _build_value_coeffs(v, delta), (nu.detach(),),
        (torch.ones_like(nu),),
    )
    return torch.cat(
        [co, dco[_OFF_A:_OFF_B], dco[_OFF_B:_OFF_C], dco[_OFF_C:_LEN_VAL]]
    )


_COEFFS_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
# the constructor kernel's constants, one tensor per dtype and device
_CONSTANTS = {}


def _kernel_constants(dtype, device):
    """The Chebyshev-Gauss nodes, k!, ln k! and the interpolation matrix in
    the layout of ``csrc/matern_nu_coeffs.cu``: the plain version's f64
    arrays cast to ``dtype``, so both sides read the same bits."""
    key = (dtype, device)
    if key not in _CONSTANTS:
        # the kernel evaluates kve at the nodes by CF2 alone, the branch the
        # plain version selects above T0
        if not _NODES_T.min() > T0:
            raise RuntimeError("a tail node lies at or below T0")
        flat = np.concatenate([_NODES_T, _FACT, _LOG_FACT, _CHEB_MAT.ravel()])
        _CONSTANTS[key] = torch.as_tensor(flat, dtype=dtype, device=device)
    return _CONSTANTS[key]


def _launch_coeffs(nu, need_dnu: bool, tangent: bool = False):
    """One launch of the constructor kernel on a one-element CUDA ``nu``:
    the vector (``_LEN_DNU`` long with ``need_dnu``, else ``_LEN_DT``) and,
    with ``tangent``, d vector / d nu of its first ``_LEN_DT`` entries."""
    dtype, dev = nu.dtype, nu.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"matern_nu_coeffs takes f32 or f64, not {dtype}")
    nu = nu.detach().contiguous()
    out = torch.empty((_LEN_DNU if need_dnu else _LEN_DT,), dtype=dtype,
                      device=dev)
    dout = (torch.empty((_LEN_DT,), dtype=dtype, device=dev) if tangent
            else None)
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = _build.function(
        "matern_nu_coeffs", f"matern_nu_coeffs_{suffix}", _COEFFS_ARGTYPES
    )
    with _build.on_device(dev):
        rc = fn(
            _build.ptr(nu), _build.ptr(_kernel_constants(dtype, dev)),
            _build.ptr(out), _build.ptr(dout), int(need_dnu),
            _build.stream(dev),
        )
    _build.check(rc, "matern_nu_coeffs", "matern_nu_coeffs")
    _build.count("matern_nu_coeffs")
    return out, dout


class _CoeffsOnCard(torch.autograd.Function):
    """The kernel's vector, differentiable in ``nu``: nu is a scalar, so the
    tangent the same launch writes is the whole Jacobian."""

    @staticmethod
    def forward(ctx, nu):
        out, dout = _launch_coeffs(nu, False, tangent=True)
        ctx.save_for_backward(dout)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        (dout,) = ctx.saved_tensors
        return (grad_out * dout).sum().reshape(1)


def matern_nu_coeffs(nu, need_dnu: bool = False):
    """Flat coefficient vector for :func:`matern_nu_eval` and the fused
    kernels, in the dtype and on the device of ``nu`` (a Python float
    builds in f64 on the CPU).

    ``need_dnu`` appends the nu-tangent sets (analytic, not finite
    differences) for the training kernel's d/dnu rows.  Without it the
    vector is differentiable in ``nu`` by ``torch.autograd``.

    A ``nu`` on a CUDA device is one launch of the constructor kernel
    (``csrc/matern_nu_coeffs.cu``), and nothing is read back to the host; a
    ``nu`` on the CPU runs :func:`matern_nu_coeffs_plain`."""
    nu = _as_nu(nu)
    if nu.device.type == "cpu":
        return matern_nu_coeffs_plain(nu, need_dnu)
    if need_dnu:
        return _launch_coeffs(nu, True)[0]
    return _CoeffsOnCard.apply(nu)


#: the orders at which a vector built another way is checked against this
#: module's (the constructor kernel's tests and chip_smoke.py): K4's test
#: orders, the integers and both sides of the clamp zones (f32 1e-2, f64 1e-7)
COEFFS_CHECK_NUS = (0.05, 0.31, 0.5, 1.2, 1.5, 2.5, 3.7, 4.8, 7.3, 10.0, 1.0,
                    2.0, 2.003, 0.999)
#: :func:`coeffs_limits`' rtol by dtype: in f64 the builds differ only in
#: their rounding; in f32 the bound of the port's f32 vector against JAX's
COEFFS_CHECK_RTOL = {torch.float64: 1e-12, torch.float32: 2e-4}
#: the rounding floor of the near-integer cancellation, in eps max|q|
#: (eps max|dq| for da): the most that two builds on different devices
#: were seen to need, 0.743 (the plain version on the CPU against the
#: same on a card, f64, nu = 10), doubled and rounded up (PERF.md)
COEFFS_CANCEL_FLOOR = 2


def coeffs_limits(want, rtol: float) -> np.ndarray:
    """Entry-by-entry absolute limits for a coefficient vector built another
    way (the constructor kernel, another framework) against ``want`` (a
    1-D vector of this layout, any length, in the dtype both were built
    in), as a float64 numpy array.

    - Each set is held against its own largest magnitude times ``rtol``:
      the sets span thirty orders of magnitude, and a set's small members
      are sums of its large ones.
    - The tail sets ``c``, ``cp`` and ``dc`` against at least 1: they are
      Chebyshev coefficients of ``log(phi e^t)`` and of its derivatives, so
      an absolute error of ``rtol`` is a relative error of ``rtol`` on phi
      (at nu = 1/2 the fit is zero up to rounding).
    - ``a``, ``ap`` and ``da`` also get the rounding floor of the
      near-integer cancellation ``a_k = u_k + q_{k-n}``: its terms are as
      large as ``max|q|`` (tangents ``max|dq|``, ~``max|q| / |mu|``), so
      ``COEFFS_CANCEL_FLOOR`` eps times that, ``(KSM - 1)`` times more for
      ``ap_k = k a_k``.
    """
    want = torch.as_tensor(want).detach()
    eps = torch.finfo(want.dtype).eps  # the dtype the vector was built in
    want = want.cpu().double().abs().numpy()
    lim = np.zeros_like(want)
    for name, (lo, hi) in COEFF_SETS.items():
        if lo < want.size:
            scale = want[lo:hi].max()
            tail = name in ("c", "cp", "dc")
            lim[lo:hi] = rtol * (max(scale, 1.0) if tail else scale)
    floor_q = COEFFS_CANCEL_FLOOR * eps * want[_OFF_B:_OFF_C].max()
    lim[_OFF_A:_OFF_B] += floor_q
    lim[_OFF_AP:_OFF_BP] += (KSM - 1) * floor_q
    if want.size > _OFF_DA:
        lim[_OFF_DA:_OFF_DB] += (
            COEFFS_CANCEL_FLOOR * eps * want[_OFF_DB:_OFF_DC].max())
    return lim


def _horner(coefs, w):
    acc = coefs[-1]
    for ck in coefs[-2::-1]:
        acc = acc * w + ck
    return acc


def _clenshaw(coefs, s):
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for ck in coefs[:0:-1]:
        b1, b2 = ck + 2.0 * s * b1 - b2, b1
    return coefs[0] + s * b1 - b2


def _expm1(z):
    """The kernels' expm1: a 4-term series under ``|z| < 1e-2`` (absolute
    error < 1e-12), plain ``exp(z) - 1`` above (no cancellation there)."""
    small = torch.abs(z) < 1e-2
    zs = torch.where(small, torch.zeros_like(z), z)
    series = z * (1.0 + z * (0.5 + z * (1.0 / 6.0 + z * (1.0 / 24.0))))
    return torch.where(small, series, torch.exp(zs) - 1.0)


def matern_nu_eval(
    t,
    coef,
    need_dt: bool = False,
    need_dnu: bool = False,
    tail_terms: int = NTAIL,
):
    """Elementwise ``phi_nu`` from a :func:`matern_nu_coeffs` vector: the
    plain version of K4.

    Args:
        t: scaled distances ``sqrt(2 nu) d / length_scale`` (>= 0), any
            shape (``coef[0]`` carries ``sqrt(2 nu)`` for the caller).
        coef: flat coefficient vector (a 1-D tensor).
        need_dt / need_dnu: also return ``d phi/dt`` and the *partial*
            ``d phi/d nu`` at fixed t (the caller owns the chain term
            ``dt/dnu = t/(2 nu)`` through ``coef[4] = 1/(2 nu)``).
        tail_terms: static truncation of the tail Chebyshev series (the
            leading coefficients of the same layout; <= NTAIL).  The
            derivatives returned are the exact derivatives of the TRUNCATED
            phi: ``d phi/dt`` re-derives its Chebyshev coefficients from the
            truncated series, and the nu-tangent truncates linearly.

    Returns ``phi`` or a tuple ``(phi, [dphi_dt], [dphi_dnu_partial])``.
    """
    coef = torch.as_tensor(coef, dtype=t.dtype, device=t.device).unbind()
    nf, mu = coef[1], coef[2]
    nt = min(int(tail_terms), NTAIL)
    a = coef[_OFF_A:_OFF_A + KSM]
    b = coef[_OFF_B:_OFF_B + KSM]
    c = coef[_OFF_C:_OFF_C + nt]

    # ---- small branch: w = t^2/4 ----
    w = 0.25 * t * t
    ws = torch.clamp_min(w, 1e-30)
    L = torch.log(ws)
    Em = _expm1(mu * L)
    Wn = torch.exp(nf * L)  # w^n
    P = _horner(a, ws)
    Q = _horner(b, ws)
    phi_small = P + Em * Wn * Q

    # ---- tail branch: phi = exp(g(t) - t), g Chebyshev-fitted ----
    tc = torch.clamp(t, T0, TMAX)
    s = (tc - _S_MID) / _S_HALF
    phi_tail = torch.exp(_clenshaw(c, s) - t)

    use_small = t <= T0
    at_zero = t <= 0.0
    phi = torch.where(use_small, phi_small, phi_tail)
    phi = torch.where(at_zero, torch.ones_like(phi), phi)
    out = (phi,)

    if need_dt:
        ap = coef[_OFF_AP:_OFF_AP + KSM - 1]
        bp = coef[_OFF_BP:_OFF_BP + KSM - 1]
        if nt == NTAIL:
            cp = coef[_OFF_CP:_OFF_CP + nt]
        else:
            # from the TRUNCATED c, so the gradient is exactly the
            # derivative of the evaluated phi (the stored cp came from the
            # full series)
            cp = _cheb_deriv_coeffs(c)
        X = Em + 1.0  # w^mu
        dP = _horner(ap, ws)
        dQ = _horner(bp, ws)
        # d/dw [P + Em w^n Q] = P' + w^n (Em Q' + mu X Q / w) + n w^{n-1} Em Q
        dphi_dw = (
            dP + Wn * (Em * dQ + mu * X * Q / ws) + nf * (Wn / ws) * Em * Q
        )
        dsmall = dphi_dw * (0.5 * t)  # dw/dt = t/2
        dG = _clenshaw(cp, s)
        ds_dt = torch.where(
            t > TMAX, torch.zeros_like(t), torch.full_like(t, 1.0 / _S_HALF)
        )
        dtail = phi_tail * (dG * ds_dt - 1.0)
        dphi_dt = torch.where(use_small, dsmall, dtail)
        out = out + (torch.where(at_zero, torch.zeros_like(t), dphi_dt),)

    if need_dnu:
        da = coef[_OFF_DA:_OFF_DA + KSM]
        db = coef[_OFF_DB:_OFF_DB + KSM]
        dc = coef[_OFF_DC:_OFF_DC + nt]
        X = Em + 1.0
        Pd = _horner(da, ws)
        Qd = _horner(db, ws)
        # coefficient tangents plus the explicit dEm/dmu = L X (dmu/dnu = 1
        # everywhere, dn/dnu = 0; coef[3] gates the term)
        dnu_small = Pd + Wn * (Em * Qd + coef[3] * (L * X * Q))
        dnu_tail = phi_tail * _clenshaw(dc, s)
        dphi_dnu = torch.where(use_small, dnu_small, dnu_tail)
        out = out + (torch.where(at_zero, torch.zeros_like(t), dphi_dnu),)

    return out if len(out) > 1 else out[0]


def _kve_host(v: float, x) -> np.ndarray:
    """numpy-f64 ``exp(x) K_v(x)`` (the Temme/CF2 algorithm of
    :mod:`muygpys_torch.ops.bessel`, iterated to convergence) for the host
    constructor."""
    x = np.asarray(x, np.float64)
    v = abs(float(v))
    n = math.floor(v + 0.5)
    mu = v - n

    out = np.empty_like(x)
    for i, xi in enumerate(x.ravel()):
        if xi <= 2.0:
            # Temme series
            xi = max(xi, 1e-300)
            x2 = 0.5 * xi
            pimu = math.pi * mu
            fact = pimu / math.sin(pimu) if abs(pimu) > 1e-15 else 1.0
            d = -math.log(x2)
            e = mu * d
            fact2 = math.sinh(e) / e if abs(e) > 1e-15 else 1.0
            # gam1 = (1/G(1-mu) - 1/G(1+mu))/(2 mu), gam2 = (sum)/2
            if abs(mu) > 1e-8:
                rg_p = 1.0 / math.gamma(1.0 + mu)
                rg_m = 1.0 / math.gamma(1.0 - mu)
                gam1 = (rg_m - rg_p) / (2.0 * mu)
                gam2 = (rg_m + rg_p) / 2.0
            else:
                g = 0.5772156649015329
                gam1 = -g - (
                    g**3 / 6.0 - g * math.pi**2 / 12.0 + 0.4006856343865314
                ) * mu * mu
                gam2 = 1.0 + (g * g - math.pi**2 / 6.0) / 2.0 * mu * mu
            gampl = gam2 - mu * gam1
            gammi = gam2 + mu * gam1
            ff = fact * (gam1 * math.cosh(e) + gam2 * fact2 * d)
            total = ff
            ee = math.exp(e)
            p = 0.5 * ee / gampl
            q = 0.5 / (ee * gammi)
            c = 1.0
            d2 = x2 * x2
            total1 = p
            for it in range(1, 40):
                fi = float(it)
                ff = (fi * ff + p + q) / (fi * fi - mu * mu)
                c = c * d2 / fi
                p = p / (fi - mu)
                q = q / (fi + mu)
                total += c * ff
                total1 += c * (p - fi * ff)
                if abs(c * ff) < abs(total) * 1e-17:
                    break
            scale = math.exp(xi)
            kmu = total * scale
            kmu1 = total1 * (2.0 / xi) * scale
        else:
            # Steed CF2
            b = 2.0 * (1.0 + xi)
            d = 1.0 / b
            h = delh = d
            a1 = 0.25 - mu * mu
            q = a1
            a = -a1
            s = 1.0 + q * delh
            u = 0.0
            w = a1
            for it in range(2, 200):
                fi = float(it)
                a -= 2.0 * (fi - 1.0)
                contrib = -(u - b * w) / fi
                q += contrib
                u = -a * w / fi
                w = contrib
                b += 2.0
                d = 1.0 / (b + a * d)
                delh = (b * d - 1.0) * delh
                h += delh
                s += q * delh
                if abs(delh) < abs(h) * 1e-17:
                    break
            h = a1 * h
            kmu = math.sqrt(math.pi / (2.0 * xi)) / s
            kmu1 = kmu * (mu + xi + 0.5 - h) / xi
        for j in range(1, n + 1):
            kmu, kmu1 = kmu1, kmu + (2.0 * (mu + j) / max(xi, 1e-300)) * kmu1
        out.ravel()[i] = kmu
    return out


def matern_nu_coeffs_host(nu: float, dtype=np.float32) -> np.ndarray:
    """f64 host-side coefficient constructor for a CONCRETE smoothness.

    Serving builds its coefficients once from a plain-float trained ``nu``:
    this pure-numpy mirror of :func:`matern_nu_coeffs` runs in f64 with the
    1e-7 clamp whatever the serving dtype, then casts.  Layout: value and dt
    sets (no nu-tangent sets: serving does not differentiate)."""
    nu = float(nu)
    n = math.floor(nu + 0.5)
    mu = nu - n
    clamp = 1e-7
    if abs(mu) < clamp:
        mu = clamp if mu >= 0.0 else -clamp
    nu_eff = n + mu

    ks = np.arange(1, KSM, dtype=np.float64)
    prods = np.cumprod(mu + (n - ks))
    sign = (-1.0) ** np.arange(1, KSM)
    u = np.concatenate([[1.0], sign / (_FACT[1:] * prods)])

    log_mag = (
        -math.lgamma(nu_eff)
        - np.array([math.lgamma(j + 1.0 + nu_eff) for j in range(KSM)])
        - _LOG_FACT
    )
    sin_pinu = ((-1.0) ** n) * math.sin(math.pi * mu)
    q = -(math.pi / sin_pinu) * np.exp(log_mag)

    idx = np.arange(KSM)
    shifted = q[np.clip(idx - n, 0, KSM - 1)]
    a = u + np.where(idx >= n, shifted, 0.0)

    log_pref = (1.0 - nu_eff) * math.log(2.0) - math.lgamma(nu_eff)
    g = (
        log_pref + nu_eff * np.log(_NODES_T)
        + np.log(_kve_host(nu_eff, _NODES_T))
    )
    c = _CHEB_MAT @ g

    kp = np.arange(1, KSM, dtype=np.float64)
    ap = kp * a[1:]
    bp = kp * q[1:]
    cp = np.array(_cheb_deriv_coeffs(list(c)))

    scal = np.array(
        [math.sqrt(2.0 * nu_eff), float(n), mu, 1.0, 0.5 / nu_eff]
    )
    return np.concatenate([scal, a, q, c, ap, bp, cp]).astype(dtype)


def matern_gen_surrogate(dists, nu):
    """``phi_nu(sqrt(2 nu) dists)`` through the surrogate's coefficients:
    semantically :func:`muygpys_torch.ops.kernels.matern_gen_fn`."""
    if not isinstance(nu, torch.Tensor):
        nu = torch.tensor(float(nu), dtype=dists.dtype, device=dists.device)
    co = matern_nu_coeffs(nu)
    return matern_nu_eval(co[0] * dists, co)
