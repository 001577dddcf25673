"""Batched per-neighborhood posterior solvers, standard layout.

Counterpart of :mod:`muygpys_tpu.ops.solve`.  Shape conventions:

- univariate and diagonal-multivariate: ``Kin (b, n, n)``, ``Kcross (b, n)``,
  ``nn_targets (b, n)`` or ``(b, n, r)``;
- flattened multi-output blocks (the shear family): ``Kin (b, i, n, i, n)``,
  ``Kcross (b, i, n, o)``, ``nn_targets (b, i, n)``: the ``(i, n)`` axes are
  flattened into one observation axis of ``i * n`` rows, and the variance is
  the full ``(o, o)`` block per neighborhood.

The fast posterior mean's offline coefficients
(:func:`fast_posterior_mean_precompute`) and its serve-time contraction
(:func:`fast_posterior_mean`, :func:`mmuygps_fast_posterior_mean`) are here
too, as are the fused mean, variance and analytic scale of
:func:`posterior_mean_variance_scale`.

Factorizations and solves go through :func:`cholesky` and :func:`solve`.
Outside :func:`sync_free` they raise on a matrix that is not positive
definite (or singular), which costs a read of the device's status on a
card; inside it they give NaN for such a matrix and never read the device,
as a CUDA graph capture requires (JAX's factorization returns NaN too).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch

_SYNC_FREE = contextvars.ContextVar("sync_free", default=False)


@contextlib.contextmanager
def sync_free():
    """Inside: a failed factorization or solve yields NaN instead of
    raising, with no host read (the device chassis steps in it)."""
    token = _SYNC_FREE.set(True)
    try:
        yield
    finally:
        _SYNC_FREE.reset(token)


def _nan_where_failed(X, info):
    failed = (info != 0).reshape(info.shape + (1,) * (X.ndim - info.ndim))
    return torch.where(failed, torch.full_like(X, math.nan), X)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``K (..., n, n)``; inside :func:`sync_free`
    a failed factor is NaN."""
    if not _SYNC_FREE.get():
        return torch.linalg.cholesky(K)
    L, info = torch.linalg.cholesky_ex(K)
    return _nan_where_failed(L, info)


def cholesky_solve(B: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """``(L L^T)^{-1} B``.  Inside :func:`sync_free` as two triangular
    solves: on a card ``torch.cholesky_solve`` may go through a MAGMA
    routine that allocates device memory, which a capture refuses."""
    if not _SYNC_FREE.get():
        return torch.cholesky_solve(B, L)
    W = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-2, -1), W, upper=True)


def solve_and_logdet(A: torch.Tensor, B: torch.Tensor):
    """``(A^{-1} B, log det A)`` for symmetric positive definite ``A``;
    inside :func:`sync_free` both from one :func:`cholesky` (``slogdet``'s
    LU may allocate device memory as ``cholesky_solve`` does)."""
    if not _SYNC_FREE.get():
        return torch.linalg.solve(A, B), torch.linalg.slogdet(A)[1]
    L = cholesky(A)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1
    )
    return cholesky_solve(B, L), logdet


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^{-1} B`` for a symmetric positive definite ``A`` (every caller's:
    covariance blocks); inside :func:`sync_free` by :func:`cholesky` and
    :func:`cholesky_solve`, NaN where ``A`` is not positive definite."""
    if not _SYNC_FREE.get():
        return torch.linalg.solve(A, B)
    return cholesky_solve(B, cholesky(A))


def _as_columns(nn_targets: torch.Tensor):
    squeeze = nn_targets.ndim == 2
    return (nn_targets[:, :, None] if squeeze else nn_targets), squeeze


def _like(Kout, ref: torch.Tensor):
    """A tensor prior (the shear ``(o, o)`` block) in ``ref``'s dtype and on
    its device; a number goes through as it is."""
    if torch.is_tensor(Kout):
        return Kout.to(dtype=ref.dtype, device=ref.device)
    return Kout


def _matching_ndim(nn_targets: torch.Tensor, Kin: torch.Tensor) -> int:
    """Count of leading dims shared by ``nn_targets`` and ``Kin``."""
    count = 0
    for a, b in zip(nn_targets.shape, Kin.shape):
        if a != b:
            break
        count += 1
    return count


def _flatten_blocks(Kin, Kcross, nn_targets=None, batch_dim_count: int = 1):
    """``(Kin (batch, in, in), Kcross (batch, in, out), targets (batch, in,
    extra) or None, batch_shape, out_shape, extra_shape)`` for the generic
    layout, as ``muygpys_tpu.ops.solve._mean_shapes`` / ``_var_shapes`` cut
    it."""
    if nn_targets is not None:
        batch_in_ndim = _matching_ndim(nn_targets, Kin)
        in_shape = tuple(Kin.shape[batch_in_ndim:])
        batch_shape = tuple(Kin.shape[: Kin.ndim - 2 * len(in_shape)])
    else:
        in_dim_count = (Kin.ndim - batch_dim_count) // 2
        batch_shape = tuple(Kin.shape[:batch_dim_count])
        in_shape = tuple(Kin.shape[batch_dim_count + in_dim_count:])
    out_shape = tuple(Kcross.shape[len(batch_shape) + len(in_shape):])
    in_size, out_size = math.prod(in_shape), math.prod(out_shape)
    Kin_flat = Kin.reshape(batch_shape + (in_size, in_size))
    Kcross_flat = Kcross.reshape(batch_shape + (in_size, out_size))
    targets_flat, extra_shape = None, ()
    if nn_targets is not None:
        extra_shape = tuple(
            nn_targets.shape[len(batch_shape) + len(in_shape):]
        )
        targets_flat = nn_targets.reshape(
            batch_shape + (in_size, math.prod(extra_shape))
        )
    return Kin_flat, Kcross_flat, targets_flat, batch_shape, out_shape, extra_shape


def posterior_mean(Kin, Kcross, nn_targets, **kwargs) -> torch.Tensor:
    """``mu = Kcross Kin^{-1} Y`` per neighborhood."""
    if Kin.ndim != 3:
        Kf, Kc, y, batch, out, extra = _flatten_blocks(Kin, Kcross, nn_targets)
        F = cholesky_solve(Kc, cholesky(Kf))
        return (F.transpose(-2, -1) @ y).reshape(batch + out + extra)
    y, squeeze = _as_columns(nn_targets)
    L = cholesky(Kin)
    F = cholesky_solve(Kcross[:, :, None], L)  # (b, n, 1)
    mean = (F.transpose(-2, -1) @ y)[:, 0, :]  # (b, r)
    return mean[:, 0] if squeeze else mean


def diagonal_variance(
    Kin, Kcross, Kout, batch_dim_count: int = 1, **kwargs
) -> torch.Tensor:
    """``Kout - Kcross Kin^{-1} Kcross^T`` per neighborhood (the full
    ``(o, o)`` block for the multi-output layout)."""
    Kout = _like(Kout, Kin)
    if Kin.ndim != 3:
        Kf, Kc, _, batch, out, _ = _flatten_blocks(
            Kin, Kcross, batch_dim_count=batch_dim_count
        )
        V = torch.linalg.solve_triangular(
            cholesky(Kf), Kc, upper=False
        )
        return Kout - (V.transpose(-2, -1) @ V).reshape(batch + out + out)
    L = cholesky(Kin)
    V = torch.linalg.solve_triangular(L, Kcross[:, :, None], upper=False)
    return Kout - torch.sum(V[:, :, 0] ** 2, dim=-1)


def posterior_mean_and_variance(
    Kin, Kcross, Kout, nn_targets, **kwargs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance sharing ONE Cholesky factorization, any layout."""
    Kf, Kc, y, batch, out, extra = _flatten_blocks(Kin, Kcross, nn_targets)
    L = cholesky(Kf)
    Z = torch.linalg.solve_triangular(
        L, torch.cat([Kc, y], dim=-1), upper=False
    )
    V, W = Z[..., : Kc.shape[-1]], Z[..., Kc.shape[-1]:]
    mean = (V.transpose(-2, -1) @ W).reshape(batch + out + extra)
    var = _like(Kout, Kin) - (V.transpose(-2, -1) @ V).reshape(
        batch + out + out
    )
    return mean, var


def serve_mean_and_variance(
    Kin, Kcross, Kout, nn_targets, **kwargs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused mean + variance from ONE batched solve against the stacked
    right-hand sides ``[Kcross, Y]`` (one shared factorization for the
    multi-output layout)."""
    if Kin.ndim != 3:
        return posterior_mean_and_variance(Kin, Kcross, Kout, nn_targets)
    y, squeeze = _as_columns(nn_targets)
    rhs = torch.cat([Kcross[:, :, None], y], dim=-1)
    sol = solve(Kin, rhs)
    mean = torch.einsum("bn,bnr->br", Kcross, sol[:, :, 1:])
    var = Kout - torch.einsum("bn,bn->b", Kcross, sol[:, :, 0])
    return (mean[:, 0] if squeeze else mean), var


def posterior_mean_variance_scale(
    Kin, Kcross, Kout, nn_targets, batch_count_global: Optional[float] = None,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean, unscaled variance and the analytic sigma^2 from ONE Cholesky
    factorization, any layout: ``sigma^2 = sum |L^{-1} Y|^2 / (count *
    in_size)``, where ``count`` is ``batch_count_global`` (the global batch
    count of a sharded batch) or the batch size."""
    Kf, Kc, y, batch, out, extra = _flatten_blocks(Kin, Kcross, nn_targets)
    L = cholesky(Kf)
    V = torch.linalg.solve_triangular(L, Kc, upper=False)
    W = torch.linalg.solve_triangular(L, y, upper=False)
    mean = (V.transpose(-2, -1) @ W).reshape(batch + out + extra)
    var = _like(Kout, Kin) - (V.transpose(-2, -1) @ V).reshape(
        batch + out + out
    )
    if batch_count_global is None:
        batch_count_global = math.prod(batch)
    scale = torch.sum(W * W) / (batch_count_global * Kf.shape[-1])
    return mean, var, scale


def fast_posterior_mean(Kcross, coeffs, **kwargs) -> torch.Tensor:
    """Serve-time fast mean ``Kcross . C`` (no solve): ``Kcross (b, n)``,
    ``coeffs (b, n)`` or ``(b, n, r)``.  Every unit axis of the result is
    squeezed, as ``jnp.squeeze`` does: one query gives ``(r,)``, one query
    and one response a 0-d tensor."""
    if coeffs.ndim == 2:
        coeffs = coeffs[:, :, None]
    return torch.einsum("ij,ijk->ik", Kcross, coeffs).squeeze()


def mmuygps_fast_posterior_mean(Kcross, coeffs, **kwargs) -> torch.Tensor:
    """Multivariate fast mean with one Kcross per response:
    ``(b, n, r), (b, n, r) -> (b, r)``."""
    return torch.einsum("ijk,ijk->ik", Kcross, coeffs)


def fast_posterior_mean_precompute(
    Kin, train_nn_targets_fast, **kwargs
) -> torch.Tensor:
    """Offline coefficients ``C = Kin^{-1} Y`` over self-inclusive
    neighborhoods: ``Kin (b, n, n)``, ``Y (b, n)`` or ``(b, n, r)``.  A
    neighborhood whose factorization fails gets NaN coefficients and
    nothing raises (JAX's factorization returns NaN); the device is not
    read.  Every unit axis of the result is squeezed, as ``jnp.squeeze``
    does."""
    y = train_nn_targets_fast
    if y.ndim == 2:
        y = y[:, :, None]
    with sync_free():
        C = cholesky_solve(y, cholesky(Kin))
    return C.squeeze()
