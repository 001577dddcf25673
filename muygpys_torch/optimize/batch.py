"""Batch sampling for LOO training.

Counterpart of :mod:`muygpys_tpu.optimize.batch`.  Index sampling is host
numpy on an explicit ``numpy.random.Generator`` (``rng=``), so the two
packages draw the same indices from the same generator; the neighbors come
from :meth:`muygpys_torch.neighbors.NN_Wrapper.get_batch_nns`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rng(rng):
    return rng if rng is not None else np.random.default_rng()


def sample_batch(
    nbrs_lookup,
    batch_count: int,
    train_count: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform sample of training indices without replacement, with their
    neighbor indices (self excluded)."""
    if train_count > batch_count:
        batch_indices = _rng(rng).choice(
            train_count, batch_count, replace=False
        )
    else:
        batch_indices = np.arange(train_count)
    batch_nn_indices, _ = nbrs_lookup.get_batch_nns(batch_indices)
    return batch_indices, np.asarray(batch_nn_indices)


def _nonconstant(nbrs_lookup, labels):
    labels = np.asarray(labels)
    nn_indices, _ = nbrs_lookup.get_batch_nns(np.arange(len(labels)))
    nn_indices = np.asarray(nn_indices)
    nn_labels = labels[nn_indices]
    return labels, nn_indices, nn_labels.max(axis=1) != nn_labels.min(axis=1)


def full_filtered_batch(
    nbrs_lookup, labels
) -> Tuple[np.ndarray, np.ndarray]:
    """All training points whose neighborhoods have non-constant labels."""
    labels, nn_indices, nonconstant = _nonconstant(nbrs_lookup, labels)
    indices = np.arange(len(labels))
    return indices[nonconstant], nn_indices[nonconstant]


def sample_balanced_batch(
    nbrs_lookup,
    labels,
    batch_count: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-balanced sample of non-constant-neighborhood training points."""
    labels, nn_indices, nonconstant = _nonconstant(nbrs_lookup, labels)
    classes = np.unique(labels)
    each = batch_count // len(classes)
    gen = _rng(rng)
    per_class = [
        np.where(np.logical_and(nonconstant, labels == c))[0]
        for c in classes
    ]
    chosen = np.concatenate([
        gen.choice(arr, min(len(arr), each), replace=False)
        for arr in per_class
    ])
    return chosen, nn_indices[chosen]


def get_balanced_batch(
    nbrs_lookup,
    labels,
    batch_count: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced sample if the data is larger than the batch, else the full
    filtered batch."""
    if len(labels) > batch_count:
        return sample_balanced_batch(nbrs_lookup, labels, batch_count, rng)
    return full_filtered_batch(nbrs_lookup, labels)
