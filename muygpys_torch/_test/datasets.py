"""Committed dataset generators emulating the reference's real-data API
tests.

The reference pins regression/classification bars on two local pickled
datasets that are not redistributable (``tests/api/regress.py:44-56``):

- **Heaton** — the Heaton et al. (2019) spatial case-study: ~100k daytime
  land-surface temperatures on a lat/lon grid (values ~°30-55), with sharp
  weather-front structure; pinned target MSE <= 11.0
  (``tests/api/regress.py:193,207``).
- **star-gal** — galaxy/star image embeddings with one-hot class targets,
  fitted as multivariate surrogate regression; pinned target MSE <= 1.0
  (``tests/api/regress.py:87,114``).

These generators reproduce the *shape* of those problems — scale, value
range, spatial discontinuity / class-cluster geometry, noise floor — from a
seed, so the same API-level bars run in CI with no data mounted.  The
port's own copy of :mod:`muygpys_tpu._test.datasets`: one seed gives the
same arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def heaton_style(
    train_count: int = 15_000,
    test_count: int = 2_000,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """2-D spatial temperature field with a sharp front.

    Surface = smooth seasonal field + a tanh weather front whose position
    wanders with longitude + measurement noise (sd 1.0), values in the
    Heaton ~°C 30-55 range.  Returns (train_x, train_y, test_x, test_y)
    with features in [0, 1]^2.
    """
    rng = rng or np.random.default_rng(0)
    n = train_count + test_count
    x = rng.uniform(size=(n, 2))

    def surface(x):
        lon, lat = x[:, 0], x[:, 1]
        smooth = 45.0 + 6.0 * np.sin(2 * np.pi * lon) * np.cos(
            2 * np.pi * lat
        ) + 3.0 * np.sin(5.0 * lon + 2.0 * lat)
        front = 5.0 * np.tanh(
            12.0 * (lat - 0.5 - 0.15 * np.sin(2 * np.pi * lon))
        )
        return smooth + front

    y = surface(x) + rng.normal(scale=1.0, size=n)
    return (
        x[:train_count],
        y[:train_count],
        x[train_count:],
        y[train_count:],
    )


def stargal_style(
    train_count: int = 4_000,
    test_count: int = 1_000,
    embed_dim: int = 16,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Two-class embedding classification in the star-gal shape.

    Class-conditional anisotropic Gaussians in an ``embed_dim``-D embedding
    space with partial overlap (the stargal CNN embeddings are separable but
    not trivially so), one-hot targets in {0.02, 0.98} like the reference's
    smoothed one-hot encoding (``_test/utils.py`` ``_make_gaussian_matrix``
    usage).  Returns (train_x, train_labels, test_x, test_labels) with
    one-hot float labels.
    """
    rng = rng or np.random.default_rng(1)
    n = train_count + test_count
    labels = rng.integers(0, 2, size=n)
    centers = np.stack([np.zeros(embed_dim), np.ones(embed_dim) * 0.7])
    scales = np.linspace(0.4, 1.0, embed_dim)
    x = centers[labels] + rng.normal(size=(n, embed_dim)) * scales
    one_hot = np.full((n, 2), 0.02)
    one_hot[np.arange(n), labels] = 0.98
    return (
        x[:train_count],
        one_hot[:train_count],
        x[train_count:],
        one_hot[train_count:],
    )
