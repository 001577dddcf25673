"""Synthetic exact-GP data samplers for statistical recovery tests.

Mirrors the role of the reference's ``_test/sampler.py`` (UnivariateSampler)
and ``_test/gp.py`` (BenchmarkGP): draw ground-truth responses from a dense
GP prior via Cholesky, split train/test, and hand out the pieces the recovery
chassis needs.  The port's own copy of :mod:`muygpys_tpu._test.sampler`,
drawing through the port's :mod:`muygpys_torch._test.oracle`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from muygpys_torch._test import oracle


class UnivariateSampler:
    """1D dense-GP sampler on a regular grid with train/test split."""

    def __init__(
        self,
        data_count: int = 500,
        train_ratio: float = 0.1,
        nu: float = 1.5,
        length_scale: float = 0.05,
        noise: float = 1e-5,
        measurement_noise: float = 1e-2,
        rng=None,
    ):
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.nu = nu
        self.length_scale = length_scale
        self.noise = noise
        self.measurement_noise = measurement_noise
        self.x = np.linspace(0.0, 1.0, data_count)[:, None]
        train_mask = np.zeros(data_count, bool)
        chosen = self.rng.choice(
            data_count, int(train_ratio * data_count), replace=False
        )
        train_mask[chosen] = True
        self.train_mask = train_mask

    def features(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.x[self.train_mask], self.x[~self.train_mask]

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        y = oracle.dense_gp_sample(
            self.rng, self.x, self.nu, self.length_scale, self.noise
        )
        y_train = (
            y[self.train_mask]
            + self.measurement_noise
            * self.rng.standard_normal((self.train_mask.sum(), 1))
        )
        return y_train, y[~self.train_mask]


class UnivariateSampler2D(UnivariateSampler):
    """2D dense-GP sampler on a regular grid (mirror of the reference's
    _test/sampler.py:242 variant)."""

    def __init__(self, points_per_dim: int = 20, train_ratio: float = 0.3,
                 **kwargs):
        super().__init__(
            data_count=points_per_dim**2, train_ratio=train_ratio, **kwargs
        )
        g = np.meshgrid(
            np.linspace(0.0, 1.0, points_per_dim),
            np.linspace(0.0, 1.0, points_per_dim),
        )
        self.x = np.stack([g[0].ravel(), g[1].ravel()], axis=1)
