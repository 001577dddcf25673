"""L-BFGS with a zoom line search as a branch-free state machine in torch.

Counterpart of the optimizer inside
:func:`muygpys_tpu.optimize.device_chassis.lbfgs_while_loop`:
``optax.lbfgs(memory_size)``, that is ``scale_by_lbfgs(memory_size,
scale_init_precond=True)``, then ``scale(-1)``, then
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")``, the line search's last value and gradient
reused by the next iteration, and scipy's stopping rule (iteration 0 always
runs; then go on while ``count < maxiter``, ``max|g| >= gtol`` and the
relative decrease ``>= ftol``).

JAX runs two nested ``while_loop``s.  Here the two loops are flattened into
one state machine whose :func:`step` is ONE objective evaluation (one
line-search probe): it scores the pending probe, advances the line search,
and, when the line search ends, takes the step, applies the stopping rule
and opens the next iteration (the two-loop recursion over a ring of
``(memory_size, P)`` tensors).  Every branch is a ``torch.where``; the
iteration count, the stopping measures and the ``done`` flag live in
tensors, so a step never reads anything back to the host and can be
captured in a CUDA graph (:mod:`muygpys_torch.optimize.device_chassis`).
The state's fields are views of three flat buffers (float, int64, bool),
so a step selects and writes all of it in a few kernels.  A step taken
after ``done`` leaves the state as it was.

The arithmetic follows optax's, operation by operation and in its order:
the capped reciprocal gradient norm as the first scale, the cubic and
quadratic interpolation with their safeguards, the approximate-decrease,
curvature and slope tests, and the step size reset to 1 at every
iteration.  The one exception is the two-loop recursion, whose two loops
are solved as two triangular systems over the memory's Gram matrix
(:func:`_two_loop`): the same coefficients up to rounding, in a few dozen
kernels instead of one for each inner product.  A probe value that is not
finite is scored as :data:`BIG` (:func:`finite_or_big`), as the JAX
chassis' objectives are.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

#: finite score of a probe whose objective value is not finite
BIG = 1e12
MEMORY_SIZE = 15
# scale_by_zoom_linesearch's settings under optax.lbfgs
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0

State = Dict[str, torch.Tensor]


def finite_or_big(v: torch.Tensor) -> torch.Tensor:
    """A non-finite value becomes :data:`BIG`, with a zero derivative (the
    double ``where`` keeps the unselected branch out of autograd), so the
    line search backtracks instead of poisoning the two-loop history."""
    ok = torch.isfinite(v)
    return torch.where(ok, torch.where(ok, v, 0.0), BIG)


# The state's fields by dtype, each with its shape: "" a scalar, "p" like
# z, "m" one per memory slot, "mp" a memory of vectors.  A state keeps each
# dtype's fields in one flat buffer (FLATS) and every field is a view of it,
# so a step selects and writes its whole state in a few kernels.
_FLOAT_FIELDS = (
    ("z", "p"), ("u", "p"), ("probe", ""),
    # scale_by_lbfgs
    ("prev_params", "p"), ("prev_updates", "p"), ("dw_mem", "mp"),
    ("du_mem", "mp"), ("rho_mem", "m"),
    # scale_by_zoom_linesearch's value and grad, reused by the next
    # iteration; the value at the start of the iteration (scipy's ftol)
    ("value", ""), ("grad", "p"), ("prev", ""),
    # the zoom line search
    ("stepsize", ""), ("ls_value", ""), ("ls_grad", "p"), ("ls_slope", ""),
    ("value_init", ""), ("slope_init", ""), ("decrease_error", ""),
    ("curvature_error", ""), ("error", ""), ("low", ""), ("value_low", ""),
    ("slope_low", ""), ("high", ""), ("value_high", ""), ("slope_high", ""),
    ("cubic_ref", ""), ("value_cubic_ref", ""), ("safe_stepsize", ""),
    ("safe_value", ""), ("safe_grad", "p"),
)
_INT_FIELDS = ("count", "evals", "ls_count")
# start_ok: whether the value and gradient at z0 are finite (set by the
# first step, read by the device chassis)
_BOOL_FIELDS = ("started", "done", "start_ok", "interval_found", "ls_done",
                "ls_failed")
#: the keys of a state's flat buffers (float, int64, bool)
FLATS = ("flat_f", "flat_i", "flat_b")
_INITIAL = {"value": float("inf"), "prev": BIG}


def _fields(dim: int, memory_size: int):
    """``(flat key, [(name, shape), ...])`` for each flat buffer."""
    shapes = {"": (), "p": (dim,), "m": (memory_size,),
              "mp": (memory_size, dim)}
    return (
        ("flat_f", [(n, shapes[k]) for n, k in _FLOAT_FIELDS]),
        ("flat_i", [(n, ()) for n in _INT_FIELDS]),
        ("flat_b", [(n, ()) for n in _BOOL_FIELDS]),
    )


def _views(flats: Dict[str, torch.Tensor], dim: int,
           memory_size: int) -> State:
    """The state whose fields are views of ``flats``."""
    state = dict(flats)
    for key, fields in _fields(dim, memory_size):
        offset = 0
        for name, shape in fields:
            size = math.prod(shape)
            state[name] = flats[key][offset:offset + size].view(shape)
            offset += size
    return state


def _pack(d: State, dim: int, memory_size: int) -> Dict[str, torch.Tensor]:
    """Every field of ``d`` gathered into new flat buffers (one ``cat``
    each)."""
    return {
        key: torch.cat([d[name].reshape(-1) for name, _ in fields])
        for key, fields in _fields(dim, memory_size)
    }


def _dims(s: State):
    return s["z"].shape[0], s["rho_mem"].shape[0]


def clone_state(s: State) -> State:
    """A copy of a state, its fields views of the copy's buffers."""
    return _views({k: s[k].clone() for k in FLATS}, *_dims(s))


def init_state(z0: torch.Tensor, memory_size: int = MEMORY_SIZE) -> State:
    """The state before the first evaluation, on ``z0``'s device and in its
    dtype; ``z0`` is a 1-D tensor of the unconstrained parameters."""
    if z0.ndim != 1:
        raise ValueError(f"z0 must be 1-D, got shape {tuple(z0.shape)}")
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")
    dim = z0.shape[0]
    dtypes = dict(flat_f=z0.dtype, flat_i=torch.int64, flat_b=torch.bool)
    flats = {
        key: torch.zeros(sum(math.prod(shape) for _, shape in fields),
                         dtype=dtypes[key], device=z0.device)
        for key, fields in _fields(dim, memory_size)
    }
    state = _views(flats, dim, memory_size)
    state["z"].copy_(z0.detach())
    for name, val in _INITIAL.items():
        state[name].fill_(val)
    return state


def _where(cond, a, b):
    return torch.where(cond, a, b)


def _dot(a, b):
    return torch.sum(a * b)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * torch.abs(
        value_init
    )
    approx = torch.maximum(approx, delta_values)
    dec = torch.minimum(approx, dec)
    dec = torch.clamp_min(dec, 0.0)
    return _where(torch.isnan(dec), float("inf"), dec)


def _curvature_error(slope_step, slope_init):
    curv = torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init)
    curv = torch.clamp_min(curv, 0.0)
    return _where(torch.isnan(curv), float("inf"), curv)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where none exists; the caller's bracket test then
    rejects it)."""
    C = fpa
    db = b - a
    dc = c - a
    dbdc = db * dc
    denom = dbdc * dbdc * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


def _zoom_middle(s: State) -> torch.Tensor:
    """The zoom phase's next step size: cubic, else quadratic, else
    bisection, each kept only well inside the bracket."""
    low, high = s["low"], s["high"]
    delta = torch.abs(high - low)
    left = torch.minimum(high, low)
    right = torch.maximum(high, low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    middle_cubic = _cubicmin(
        low, s["value_low"], s["slope_low"], high, s["value_high"],
        s["cubic_ref"], s["value_cubic_ref"],
    )
    use_cubic = (middle_cubic > left + cubic_chk) & (
        middle_cubic < right - cubic_chk
    )
    middle_quad = _quadmin(low, s["value_low"], s["slope_low"], high,
                           s["value_high"])
    use_quad = ~use_cubic & (middle_quad > left + quad_chk) & (
        middle_quad < right - quad_chk
    )
    use_bisection = ~use_cubic & ~use_quad
    middle = _where(use_cubic, middle_cubic, s["cubic_ref"])
    middle = _where(use_quad, middle_quad, middle)
    return _where(use_bisection, (low + high) / 2.0, middle)


def _linesearch_update(s: State, p, v, g) -> State:
    """One line-search step at step size ``p`` with value ``v`` and gradient
    ``g``: the interval search or the zoom, as ``interval_found`` says,
    then the safe step where the search failed."""
    slope = _dot(g, s["u"])
    vi, si = s["value_init"], s["slope_init"]
    dec = _decrease_error(p, v, slope, vi, si)
    curv = _curvature_error(slope, si)
    err = torch.maximum(dec, curv)
    safe_decrease = dec <= TOL
    cnt = s["ls_count"]
    max_iter_reached = cnt + 1 >= MAX_LINESEARCH_STEPS
    done = err <= TOL

    # interval search (Nocedal and Wright, Algorithm 3.5)
    prev_step, prev_v, prev_slope = s["stepsize"], s["ls_value"], s["ls_slope"]
    high_to_new = (dec > 0.0) | ((v >= prev_v) & (cnt > 0))
    low_to_new = (slope >= 0.0) & ~high_to_new
    search = dict(
        safe_stepsize=_where(safe_decrease, p, s["safe_stepsize"]),
        safe_value=_where(safe_decrease, v, s["safe_value"]),
        safe_grad=_where(safe_decrease, g, s["safe_grad"]),
        low=_where(low_to_new, p, prev_step),
        value_low=_where(low_to_new, v, prev_v),
        slope_low=_where(low_to_new, slope, prev_slope),
        high=_where(low_to_new, prev_step, p),
        value_high=_where(low_to_new, prev_v, v),
        slope_high=_where(low_to_new, prev_slope, slope),
        interval_found=high_to_new | low_to_new | done,
        ls_failed=max_iter_reached & ~done,
    )
    search["cubic_ref"] = search["low"]
    search["value_cubic_ref"] = search["value_low"]

    # zoom (Algorithm 3.6)
    low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
    high, value_high, slope_high = s["high"], s["value_high"], s["slope_high"]
    too_small = torch.abs(high - low) <= STEPSIZE_PRECISION
    update_safe = safe_decrease & (v < s["safe_value"])
    safe_stepsize = _where(update_safe, p, s["safe_stepsize"])
    high_to_middle = (dec > 0.0) | (v >= value_low)
    high_to_low = (slope * (high - low) >= 0.0) & ~high_to_middle
    low_to_middle = ~high_to_middle
    high1 = _where(high_to_middle, p, high)
    value_high1 = _where(high_to_middle, v, value_high)
    slope_high1 = _where(high_to_middle, slope, slope_high)
    ref_is_high = high_to_middle | high_to_low
    zoom = dict(
        safe_stepsize=safe_stepsize,
        safe_value=_where(update_safe, v, s["safe_value"]),
        safe_grad=_where(update_safe, g, s["safe_grad"]),
        low=_where(low_to_middle, p, low),
        value_low=_where(low_to_middle, v, value_low),
        slope_low=_where(low_to_middle, slope, slope_low),
        high=_where(high_to_low, low, high1),
        value_high=_where(high_to_low, value_low, value_high1),
        slope_high=_where(high_to_low, slope_low, slope_high1),
        cubic_ref=_where(ref_is_high, high, low),
        value_cubic_ref=_where(ref_is_high, value_high, value_low),
        interval_found=s["interval_found"],
        ls_failed=(max_iter_reached | (too_small & (safe_stepsize > 0.0)))
        & ~done,
    )

    in_zoom = s["interval_found"]
    # the scalars picked by one where over stacks, the rest one by one
    scalars = [k for k, val in zoom.items()
               if val.ndim == 0 and val.dtype.is_floating_point]
    picked = _where(in_zoom, torch.stack([zoom[k] for k in scalars]),
                    torch.stack([search[k] for k in scalars]))
    new = dict(zip(scalars, picked.unbind()))
    for k in zoom.keys() - new.keys():
        new[k] = _where(in_zoom, zoom[k], search[k])
    failed = new["ls_failed"]
    # the safe step: where the search failed, fall back on the best step
    # with sufficient decrease, or on it outright when the probe left the
    # objective's domain
    use_safe = failed & ((new["safe_stepsize"] > 0.0) | torch.isinf(dec))
    new.update(
        stepsize=_where(use_safe, new["safe_stepsize"], p),
        ls_value=_where(use_safe, new["safe_value"], v),
        ls_grad=_where(use_safe, new["safe_grad"], g),
        ls_slope=slope, value_init=vi, slope_init=si, decrease_error=dec,
        curvature_error=curv, error=err, ls_done=done, ls_count=cnt + 1,
    )
    return new


def _two_loop(grad, dw_mem, du_mem, rho_mem, identity_scale, memory_idx):
    """The inverse-Hessian approximation times ``grad`` (Nocedal and
    Wright, Algorithm 7.4), over the ring ordered from ``memory_idx``.

    Each loop's recursion over the memory is a triangular system in its
    coefficients, since every inner product it takes is one of ``grad`` or
    of a memory vector with a memory vector: the first loop's alpha_j =
    rho_j (dw_j.grad - sum_{k>j} alpha_k dw_j.du_k), the second's c_j =
    alpha_j - beta_j = alpha_j - rho_j (du_j.r + sum_{k<j} c_k du_j.dw_k)
    with r the scaled result of the first.  Both are solved by one
    triangular solve each over the memory's Gram matrix, a few dozen
    kernels where the loops launch one for each product."""
    memory_size = rho_mem.shape[0]
    order = torch.remainder(
        memory_idx + torch.arange(memory_size, device=grad.device),
        memory_size,
    )
    dw, du, rho = dw_mem[order], du_mem[order], rho_mem[order]
    gram = dw @ du.T  # gram[j, k] = dw_j . du_k
    eye = torch.eye(memory_size, dtype=grad.dtype, device=grad.device)
    first = eye + rho[:, None] * torch.triu(gram, 1)
    alpha = torch.linalg.solve_triangular(
        first, (rho * (dw @ grad))[:, None], upper=True
    )[:, 0]
    r = identity_scale * (grad - alpha @ du)
    second = eye + rho[:, None] * torch.tril(gram.T, -1)
    c = torch.linalg.solve_triangular(
        second, (alpha - rho * (du @ r))[:, None], upper=False
    )[:, 0]
    return r + c @ dw


def _begin_iteration(s: State, z, value, grad) -> State:
    """``scale_by_lbfgs``'s update at ``z`` (value and gradient already
    made safe), the direction, and a fresh line search from it."""
    count = s["count"]
    memory_size = s["rho_mem"].shape[0]
    memory_idx = torch.remainder(count, memory_size)
    prev_idx = torch.remainder(count - 1, memory_size)
    started = count > 0
    diff_params = z - s["prev_params"]
    diff_updates = grad - s["prev_updates"]
    vdot = _dot(diff_updates, diff_params)
    weight = _where(vdot == 0.0, 0.0, 1.0 / vdot)
    diff_params = _where(started, diff_params, 0.0)
    diff_updates = _where(started, diff_updates, 0.0)
    weight = _where(started, weight, 0.0)
    slot = torch.arange(memory_size, device=z.device) == prev_idx
    dw_mem = _where(slot[:, None], diff_params[None, :], s["dw_mem"])
    du_mem = _where(slot[:, None], diff_updates[None, :], s["du_mem"])
    rho_mem = _where(slot, weight, s["rho_mem"])
    numerator = _dot(diff_updates, diff_params)
    denominator = _dot(diff_updates, diff_updates)
    identity_scale = _where(denominator > 0.0, numerator / denominator, 1.0)
    # the first step: a capped reciprocal of the gradient norm
    capped_inv_norm = torch.clamp_max(1.0 / torch.sqrt(_dot(grad, grad)),
                                      1.0)
    identity_scale = _where(started, identity_scale, capped_inv_norm)
    u = -1.0 * _two_loop(grad, dw_mem, du_mem, rho_mem, identity_scale,
                         memory_idx)
    slope = _dot(u, grad)
    zero = torch.zeros_like(value)
    inf = torch.full_like(value, float("inf"))
    false = torch.zeros_like(s["done"])
    return dict(
        count=count + 1, prev_params=z, prev_updates=grad, dw_mem=dw_mem,
        du_mem=du_mem, rho_mem=rho_mem, u=u, prev=value,
        probe=torch.ones_like(value),  # initial_guess_strategy "one"
        stepsize=zero, ls_value=value, ls_grad=grad, ls_slope=slope,
        value_init=value, slope_init=slope, decrease_error=inf,
        curvature_error=inf, error=inf, interval_found=false, ls_done=false,
        ls_failed=false, low=zero, value_low=value, slope_low=slope,
        high=zero, value_high=value, slope_high=slope, cubic_ref=zero,
        value_cubic_ref=value, safe_stepsize=zero, safe_value=value,
        safe_grad=grad, ls_count=torch.zeros_like(s["ls_count"]),
    )


def step(
    state: State,
    value_and_grad: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                   torch.Tensor]],
    maxiter: int = 200,
    gtol: float = 1e-7,
    ftol: float = 2.22e-9,
    out: State = None,
) -> State:
    """One objective evaluation of the flattened L-BFGS loop; returns the
    new state.  ``state`` is not modified unless it is ``out``: with
    ``out`` the new state is written into ``out``'s flat buffers (one
    ``where`` each, the device chassis' static state) and ``out`` is
    returned.

    ``value_and_grad(x) -> (value, grad)`` takes and returns tensors in the
    state's dtype and on its device (the value 0-d, the gradient like
    ``x``).  The first step evaluates at ``z0``; every later one at the
    pending probe ``z + probe * u``.
    """
    s = state
    x = s["z"] + s["probe"] * s["u"]
    v, g = value_and_grad(x)
    v = v.detach().to(x.dtype)
    g = g.detach().to(x.dtype)
    started = s["started"]
    start_ok = _where(
        started, s["start_ok"],
        torch.isfinite(v) & (v < BIG) & torch.all(torch.isfinite(g)),
    )
    v = finite_or_big(v)

    ls = _linesearch_update(s, s["probe"], v, g)
    over = ls["ls_done"] | ls["ls_failed"]
    finish = started & over
    # the iteration that ends here: take the step, then scipy's test
    z_fin = s["z"] + ls["stepsize"] * s["u"]
    value_fin, grad_fin = ls["ls_value"], ls["ls_grad"]
    gmax = torch.amax(torch.abs(grad_fin))
    prev = s["prev"]
    frel = (prev - value_fin) / torch.clamp_min(
        torch.maximum(torch.abs(prev), torch.abs(value_fin)), 1.0
    )
    go_on = (s["count"] == 0) | (
        (s["count"] < maxiter) & (gmax >= gtol) & (frel >= ftol)
    )
    # the next iteration starts from the line search's last value and
    # gradient, or, at the very first step, from this evaluation
    begin = _begin_iteration(
        s,
        _where(started, z_fin, s["z"]),
        finite_or_big(_where(started, value_fin, v)),
        torch.nan_to_num(_where(started, grad_fin, g), nan=0.0, posinf=0.0,
                         neginf=0.0),
    )
    new_iter = ~started | (finish & go_on)
    probe = _where(
        ls["interval_found"], _zoom_middle(ls),
        _where(ls["ls_count"] == 0, 1.0, INCREASE_FACTOR * ls["stepsize"]),
    )
    going = dict(s)
    going.update(ls)
    going.update(
        probe=probe,
        z=_where(finish, z_fin, s["z"]),
        value=_where(finish, value_fin, s["value"]),
        grad=_where(finish, grad_fin, s["grad"]),
        started=torch.ones_like(started),
        done=s["done"] | (finish & ~go_on),
        evals=s["evals"] + 1,
        start_ok=start_ok,
    )
    opened = dict(going)
    opened.update(begin)
    dims = _dims(s)
    going, opened = _pack(going, *dims), _pack(opened, *dims)
    # past convergence a step changes nothing
    done = s["done"]
    if out is None:
        return _views({
            k: _where(done, s[k], _where(new_iter, opened[k], going[k]))
            for k in FLATS
        }, *dims)
    if out is s:
        done = done.clone()  # a view of the flat buffer written below
    for k in FLATS:
        torch.where(done, s[k], _where(new_iter, opened[k], going[k]),
                    out=out[k])
    return out


def summary(state: State):
    """``(z, iterations, value, max|grad|)`` of a state, as tensors."""
    return (state["z"], state["count"], state["value"],
            torch.amax(torch.abs(state["grad"])))


def max_steps(maxiter: int) -> int:
    """An upper bound on the steps of a run: the first evaluation, then at
    most ``MAX_LINESEARCH_STEPS`` probes per iteration."""
    return 1 + max(maxiter, 1) * MAX_LINESEARCH_STEPS


def autograd_value_and_grad(fun: Callable) -> Callable:
    """``x -> (finite_or_big(fun(x)), d/dx)`` by ``torch.autograd``."""

    def value_and_grad(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            value = finite_or_big(fun(xr))
            (grad,) = torch.autograd.grad(value, xr)
        return value.detach(), grad

    return value_and_grad
