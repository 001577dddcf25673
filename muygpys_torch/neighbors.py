"""Nearest neighbor index.

Counterpart of :class:`muygpys_tpu.neighbors.NN_Wrapper`.  Distances are
*squared* l2.  Methods:

- ``"exact"``: brute force on the device — Gram-identity distance tiles
  (a matrix product) reduced with ``torch.topk`` over an over-fetched
  candidate set, then an exact re-rank by direct differences;
- ``"kernel"`` (JAX: ``"pallas"``): the K3 candidate kernel
  (:mod:`muygpys_torch.gpu.knn`, 1024 bins, Morton-sorted and pruned at
  ``d <= 4``; its train side built once per index) followed by the same
  exact re-rank.

The host methods ``"sklearn"`` and ``"hnsw"`` are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gpu import knn as _knn

_QUERY_TILE = 512


def _brute_force_knn(
    train: torch.Tensor,
    queries: torch.Tensor,
    nn_count: int,
    query_tile: int = _QUERY_TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k smallest squared-l2 distances, tiled over queries so only
    a ``(query_tile, train)`` block is ever materialized."""
    train_sq = torch.sum(train * train, dim=-1)
    idx, d2 = [], []
    for start in range(0, queries.shape[0], query_tile):
        q = queries[start:start + query_tile]
        dist = (
            torch.sum(q * q, dim=-1)[:, None] + train_sq[None, :]
            - 2.0 * (q @ train.T)
        )
        vals, sel = torch.topk(dist, nn_count, dim=1, largest=False)
        idx.append(sel)
        d2.append(torch.clamp_min(vals, 0.0))
    return torch.cat(idx), torch.cat(d2)


def _refine_knn(
    train: torch.Tensor,
    queries: torch.Tensor,
    cand_idx: torch.Tensor,
    nn_count: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of candidate neighbors by direct squared differences."""
    cand = train[cand_idx]  # (q, kc, f)
    d2 = torch.sum((queries[:, None, :] - cand) ** 2, dim=-1)
    vals, sel = torch.topk(d2, nn_count, dim=1, largest=False)
    return torch.gather(cand_idx, 1, sel), torch.clamp_min(vals, 0.0)


class NN_Wrapper:
    """KNN index over the training features.

    Args:
        train: ``(train_count, feature_count)`` training features.
        nn_count: number of neighbors returned per query.
        nn_method: ``"exact"`` (default) or ``"kernel"``.
        device: where the index lives and searches (default ``"cuda"``).
        spatial_sort: ``"kernel"`` only; Morton-sort a copy of the training
            rows so the candidate kernel skips provably irrelevant tiles.
            Default ``None`` = on for ``feature_count <= 4``.
    """

    def __init__(
        self,
        train,
        nn_count: int,
        nn_method: str = "exact",
        device=None,
        spatial_sort=None,
    ):
        self.device = config.device(device)
        train = np.asarray(train)
        if train.ndim == 1:
            train = train[:, None]
        self.train = train
        self.train_count, self.feature_count = train.shape
        self.nn_count = nn_count
        self.nn_method = nn_method.lower()
        if self.nn_method not in ("exact", "kernel"):
            raise NotImplementedError(
                f"nn_method {nn_method!r} is not ported yet (exact, kernel)"
            )
        self._train_dev = torch.as_tensor(train, device=self.device)
        if spatial_sort is None:
            spatial_sort = self.feature_count <= 4
        self._spatial = (
            bool(spatial_sort)
            and self.nn_method == "kernel"
            and self.train_count >= 2048
        )
        if self._spatial:
            self._perm_dev = _knn.spatial_sort(self._train_dev)
            self._train_sorted = self._train_dev[self._perm_dev]
        # the candidate search's train side, built once per index
        self._knn_index = None
        if self.nn_method == "kernel" and self.train_count >= 2048:
            self._knn_index = _knn.build_index(
                self._train_sorted if self._spatial else self._train_dev,
                bins=1024, pruned=self._spatial,
            )

    def get_nns(self, test) -> Tuple[np.ndarray, np.ndarray]:
        """Neighbors of out-of-sample queries: ``(indices, sq_dists)``."""
        return self._get_nns(test, self.nn_count)

    def get_batch_nns(self, batch_indices) -> Tuple[np.ndarray, np.ndarray]:
        """Neighbors of training points, self-neighbor dropped."""
        batch_indices = np.asarray(batch_indices)
        nn_indices, nn_dists = self._get_nns(
            self.train[batch_indices], self.nn_count + 1
        )
        return nn_indices[:, 1:], nn_dists[:, 1:]

    def _get_nns(self, test, nn_count: int):
        test = np.asarray(test)
        if test.ndim == 1:
            test = test[:, None]
        # over-fetch through the Gram identity, then re-rank exactly: the
        # identity loses ~eps*|a|^2 absolute precision, which scrambles
        # ranking once nearest distances approach that floor
        cand_count = min(nn_count + 32, self.train_count)
        queries = torch.as_tensor(test, device=self.device)
        if self._knn_index is not None:
            # 1024 bins: the host KNN API favors recall over merge cost;
            # below 2*bins train rows the exact engine is used instead
            if self._spatial:
                cand_s, _ = _knn.knn_cuda_pruned(
                    None, queries, cand_count, bins=1024, device=self.device,
                    train_index=self._knn_index,
                )
                cand_idx = self._perm_dev[cand_s]
            else:
                cand_idx, _ = _knn.knn_cuda(
                    None, queries, cand_count, bins=1024, device=self.device,
                    train_index=self._knn_index,
                )
        else:
            cand_idx, _ = _brute_force_knn(self._train_dev, queries, cand_count)
        idx, d2 = _refine_knn(self._train_dev, queries, cand_idx, nn_count)
        return idx.cpu().numpy(), d2.cpu().numpy()
