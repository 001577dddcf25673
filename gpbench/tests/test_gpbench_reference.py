"""The plain reference against a direct dense solve at a tiny size, in
numpy float64: the exact neighbours, the Matérn posterior, the shear
posterior; and its control's precision."""

import math

import numpy as np
import pytest
import torch

from gpbench.reference import knn, matern, shear

RNG = np.random.default_rng(11)
X = RNG.uniform(size=(400, 2))
Y = np.sin(6 * X[:, 0]) + 0.1 * RNG.standard_normal(400)
Q = RNG.uniform(size=(25, 2))
NN = 12


def brute_knn(train, queries, k):
    d2 = ((queries[:, None, :] - train[None, :, :]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def matern32(r, ls):
    u = math.sqrt(3) * r / ls
    return (1 + u) * np.exp(-u)


def dense_posterior(idx, queries, ls, noise):
    means, variances = [], []
    for q, nb in zip(queries, idx):
        p = X[nb]
        K = matern32(np.linalg.norm(p[:, None] - p[None], axis=-1), ls)
        kc = matern32(np.linalg.norm(p - q, axis=-1), ls)
        Kn = K + noise * np.eye(len(nb))
        means.append(kc @ np.linalg.solve(Kn, Y[nb]))
        variances.append(1 - kc @ np.linalg.solve(Kn, kc))
    return np.array(means), np.array(variances)


def t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_knn_is_exact():
    got = knn.knn(t(X), t(Q), NN, block=7).numpy()
    assert np.array_equal(np.sort(got, 1), np.sort(brute_knn(X, Q, NN), 1))


def test_matern_posterior():
    idx = brute_knn(X, Q, NN)
    mean, var = matern.posterior(t(X), t(Y), torch.as_tensor(idx), t(Q),
                                 0.3, 1e-2, 1.5, block=10)
    want_m, want_v = dense_posterior(idx, Q, 0.3, 1e-2)
    np.testing.assert_allclose(mean.numpy(), want_m, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), want_v, rtol=1e-9, atol=1e-13)


def test_tf32_rounds_the_solve_and_float64_does_not():
    from gpbench.reference.precision import computing, matmul_operand

    v = torch.tensor([1.0 + 2**-12, 1.0 + 2**-9], dtype=torch.float32)
    with computing("tf32"):
        assert matmul_operand(v).tolist() == [1.0, 1.0 + 2**-9]
        assert matmul_operand(v.double()).equal(v.double())
    with computing("float64"):
        assert matmul_operand(v).equal(v)
    idx = torch.as_tensor(brute_knn(X, Q, NN))
    with computing("tf32") as dt:
        low = matern.posterior(t(X).to(dt), t(Y).to(dt), idx, t(Q).to(dt),
                               0.3, 1e-2, 1.5)
    high = matern.posterior(t(X), t(Y), idx, t(Q), 0.3, 1e-2, 1.5)
    gap = (low[0].double() - high[0]).abs().max()
    assert 1e-4 < gap < 1.0


def shear_dense(dx, ls):
    """The six blocks written out again from their definition."""
    x, y = dx
    r2 = x * x + y * y
    e = math.exp(-r2 / (2 * ls)) / ls**4
    kk = 0.25 * (8 * ls**2 - 8 * ls * r2 + 2 * x**2 * y**2 + x**4 + y**4) * e
    k1 = 0.25 * (6 * ls * (y**2 - x**2) + x**4 - y**4) * e
    k2 = 0.5 * x * y * (r2 - 6 * ls) * e
    g11 = 0.25 * (4 * ls**2 - 4 * ls * r2 - 2 * x**2 * y**2 + x**4 + y**4) * e
    g12 = 0.5 * x * y * (x**2 - y**2) * e
    g22 = (ls**2 - ls * r2 + x**2 * y**2) * e
    return np.array([[kk, k1, k2], [k1, g11, g12], [k2, g12, g22]])


def test_shear_posterior():
    ls, tau, n = 0.05, 3.0, 8
    targets = RNG.standard_normal((400, 3))
    idx = brute_knn(X, Q[:5], n)
    mean, cov = shear.posterior(t(X), t(targets), torch.as_tensor(idx),
                                t(Q[:5]), ls, tau, block=2)
    for b, (q, nb) in enumerate(zip(Q[:5], idx)):
        kin = np.zeros((3 * n, 3 * n))
        kc = np.zeros((3 * n, 3))
        for i in range(n):
            kc[i::n][:3] = shear_dense(q - X[nb[i]], ls)
            for j in range(n):
                kin[i::n, j::n] = shear_dense(X[nb[i]] - X[nb[j]], ls)
        kin += np.diag([2 * tau] * n + [tau] * (2 * n))
        yv = targets[nb].T.reshape(-1)
        np.testing.assert_allclose(mean[b].numpy(),
                                   kc.T @ np.linalg.solve(kin, yv),
                                   rtol=1e-9, atol=1e-12)
        want = shear_dense(np.zeros(2), ls) - kc.T @ np.linalg.solve(kin, kc)
        np.testing.assert_allclose(cov[b].numpy(), want, rtol=1e-9,
                                   atol=1e-9)
