"""Bayesian optimization over box bounds: random exploration, a small exact
GP surrogate (Matern 5/2) and expected-improvement acquisition, in numpy.

Counterpart of :mod:`muygpys_tpu.optimize.bayes` (the port keeps its own
copy of that JAX-free module, the same code): one ``random_state`` draws
the same probes in both packages.  The surface is the subset of
``bayes_opt.BayesianOptimization`` the chassis use: ``probe(params,
lazy=True)``, ``maximize(init_points, n_iter)``, ``.max`` with
``"params"``/``"target"`` keys, ``.res``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np


def _matern52(d):
    k = np.sqrt(5.0) * d
    return (1.0 + k + k * k / 3.0) * np.exp(-k)


class BayesianOptimization:
    """Maximize a black-box function over a box via GP + EI."""

    def __init__(
        self,
        f: Callable,
        pbounds: Dict[str, Tuple[float, float]],
        random_state=None,
        verbose: int = 0,
        allow_duplicate_points: bool = True,
        **kwargs,
    ):
        self._f = f
        self._names = list(pbounds.keys())
        self._bounds = np.array([pbounds[n] for n in self._names], float)
        self._rng = np.random.default_rng(random_state)
        self._verbose = verbose
        self._X: list = []
        self._y: list = []
        self._queue: list = []

    # -- bayes_opt-compatible surface --

    def probe(self, params: Dict[str, float], lazy: bool = True) -> None:
        x = np.array([params[n] for n in self._names], float)
        if lazy:
            self._queue.append(x)
        else:
            self._observe(x)

    def register(self, params: Dict[str, float], target: float) -> None:
        self._X.append(np.array([params[n] for n in self._names], float))
        self._y.append(float(target))

    @property
    def max(self) -> Dict:
        i = int(np.argmax(self._y))
        return {
            "target": self._y[i],
            "params": dict(zip(self._names, self._X[i])),
        }

    @property
    def res(self) -> Sequence[Dict]:
        return [
            {"target": y, "params": dict(zip(self._names, x))}
            for x, y in zip(self._X, self._y)
        ]

    def maximize(self, init_points: int = 5, n_iter: int = 20, **kwargs):
        for x in self._queue:
            self._observe(x)
        self._queue = []
        lo, hi = self._bounds[:, 0], self._bounds[:, 1]
        for _ in range(init_points):
            self._observe(self._rng.uniform(lo, hi))
        for _ in range(n_iter):
            self._observe(self._suggest())
        return self.max

    # -- internals --

    def _observe(self, x: np.ndarray) -> None:
        y = float(self._f(**dict(zip(self._names, x))))
        if not np.isfinite(y):
            y = -1e12
        self._X.append(x)
        self._y.append(y)
        if self._verbose:
            print(f"bayes_opt: f({dict(zip(self._names, x))}) = {y:.6g}")

    def _suggest(self) -> np.ndarray:
        X = np.array(self._X)
        y = np.array(self._y)
        lo, hi = self._bounds[:, 0], self._bounds[:, 1]
        span = np.where(hi > lo, hi - lo, 1.0)
        Xn = (X - lo) / span
        mu_y, sd_y = y.mean(), y.std() + 1e-12
        yn = (y - mu_y) / sd_y

        # GP surrogate fit (fixed unit length scale in normalized space)
        d = np.linalg.norm(Xn[:, None, :] - Xn[None, :, :], axis=-1)
        K = _matern52(d / 0.35) + 1e-6 * np.eye(len(Xn))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        cand = self._rng.uniform(size=(2048, len(self._names)))
        dc = np.linalg.norm(cand[:, None, :] - Xn[None, :, :], axis=-1)
        Kc = _matern52(dc / 0.35)
        mu = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        var = np.maximum(1.0 - np.sum(v * v, axis=0), 1e-12)
        sd = np.sqrt(var)

        best = yn.max()
        xi = 0.01
        z = (mu - best - xi) / sd
        from scipy.stats import norm

        ei = (mu - best - xi) * norm.cdf(z) + sd * norm.pdf(z)
        return lo + cand[int(np.argmax(ei))] * span
