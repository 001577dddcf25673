"""Loaders for the reference's real API-test datasets (when present).

The port's copy of :mod:`muygpys_tpu._test.real_data`.  The reference's API
tests load pickles (reference ``tests/api/regress.py:44-56``: ``heaton/
sub_heaton.pkl`` and ``star-gal/embedded_40_galstar.pkl`` et al.).  That
data is not distributed with the repository and nothing here fetches it.
These loaders look in ``$MUYGPYS_DATA_DIR``, by default the ``data/``
directory at the repository root (the JAX package looks next to the
repository, ``../data``; the port reads nothing outside its checkout
unless told to), and raise ``FileNotFoundError`` naming the path when the
file is absent: tests that need the data then skip and say so, and the
dataset-shaped generators (:mod:`muygpys_torch._test.datasets`) carry the
thresholds instead.

Pickle schemas (reference ``_test/api.py``):
- heaton: ``(train, test)`` dicts with ``"input" (n, 2)`` lon/lat and
  ``"output" (n, 1)`` temperature.
- star-gal (embedded): ``(train, test)`` dicts with ``"input" (n, d)``
  embedded features and ``"output" (n, 2)`` one-hot galaxy/star labels.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def data_dir() -> str:
    return os.environ.get(
        "MUYGPYS_DATA_DIR", os.path.join(_REPO_ROOT, "data")
    )


def _load(relpath: str):
    path = os.path.join(data_dir(), relpath)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"real dataset not present: {path} (set MUYGPYS_DATA_DIR; see "
            "muygpys_torch/_test/real_data.py for the expected layout)"
        )
    with open(path, "rb") as f:
        return pickle.load(f)


def load_heaton() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_x, train_y, test_x, test_y) for the Heaton spatial problem
    (reference bar: MSE <= 11.0, ``tests/api/regress.py:193,207``)."""
    train, test = _load(os.path.join("heaton", "sub_heaton.pkl"))
    return (
        np.asarray(train["input"], np.float64),
        np.asarray(train["output"], np.float64).reshape(-1),
        np.asarray(test["input"], np.float64),
        np.asarray(test["output"], np.float64).reshape(-1),
    )


def load_stargal_embedded(
    dim: int = 40,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_x, train_y, test_x, test_y) for the embedded star-gal
    problem; ``train_y`` is one-hot ``(n, 2)`` (reference bars: surrogate
    MSE <= 1.0, accuracy tiers in ``tests/api/classify.py``)."""
    train, test = _load(
        os.path.join("star-gal", f"embedded_{dim}_galstar.pkl")
    )
    return (
        np.asarray(train["input"], np.float64),
        np.asarray(train["output"], np.float64),
        np.asarray(test["input"], np.float64),
        np.asarray(test["output"], np.float64),
    )
