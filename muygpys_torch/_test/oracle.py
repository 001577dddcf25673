"""Pure-numpy oracle implementations for conformance testing.

Independent re-derivations (from the MuyGPs equations, arXiv:2104.14581) of
the quantities the ops compute, in plain numpy with LAPACK solves: the
slow, trusted answer.  The port's own copy of
:mod:`muygpys_tpu._test.oracle` (numpy and scipy only, equal on equal
inputs), since ``muygpys_torch`` imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import scipy.special


def crosswise_diffs(data, nn_data, indices, nn_indices):
    return data[indices][:, None, :] - nn_data[nn_indices]


def pairwise_diffs(data, nn_indices):
    pts = data[nn_indices]
    return pts[:, :, None, :] - pts[:, None, :, :]


def crosswise_l2(data, nn_data, indices, nn_indices):
    return np.linalg.norm(crosswise_diffs(data, nn_data, indices, nn_indices), axis=-1)


def pairwise_l2(data, nn_indices):
    return np.linalg.norm(pairwise_diffs(data, nn_indices), axis=-1)


def matern(dists, nu):
    """Matern kernel on unit length scale via scipy Bessel."""
    if nu == np.inf:
        return np.exp(-(dists**2) / 2.0)
    d = np.where(dists == 0.0, 1e-30, dists)
    t = np.sqrt(2 * nu) * d
    with np.errstate(invalid="ignore", over="ignore"):
        val = (
            (2 ** (1.0 - nu) / scipy.special.gamma(nu))
            * t**nu
            * scipy.special.kv(nu, t)
        )
    return np.where(dists == 0.0, 1.0, val)


def rbf(sq_dists):
    return np.exp(-sq_dists / 2.0)


def posterior_mean(Kin, Kcross, nn_targets):
    """mu = Kcross (Kin)^{-1} Y, univariate layout (b,n,n),(b,n),(b,n,r)."""
    F = np.linalg.solve(Kin, Kcross[:, :, None])
    if nn_targets.ndim == 2:
        nn_targets = nn_targets[:, :, None]
    out = np.swapaxes(F, -2, -1) @ nn_targets
    return np.squeeze(out, axis=1)


def diagonal_variance(Kin, Kcross, Kout=1.0):
    F = np.linalg.solve(Kin, Kcross[:, :, None])
    Kpost = np.squeeze(np.swapaxes(F, -2, -1) @ Kcross[:, :, None])
    return Kout - Kpost


def analytic_scale(Kin, nn_targets):
    if nn_targets.ndim == 2:
        nn_targets = nn_targets[:, :, None]
    sol = np.linalg.solve(Kin, nn_targets)
    num = np.sum(np.einsum("ijk,ijk->ik", nn_targets, sol))
    b, n = Kin.shape[:2]
    return num / (b * n)


def dense_gp_sample(rng, X, nu, length_scale, noise, n_draws=1):
    """Draw exact GP realizations via dense Cholesky (test data generator)."""
    n = X.shape[0]
    d = np.linalg.norm(X[:, None, :] - X[None, :, :], axis=-1)
    K = matern(d / length_scale, nu) + noise * np.eye(n)
    L = np.linalg.cholesky(K + 1e-12 * np.eye(n))
    z = rng.standard_normal((n, n_draws))
    return L @ z
