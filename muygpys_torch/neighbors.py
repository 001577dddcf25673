"""Nearest neighbor index.

Counterpart of :mod:`muygpys_tpu.neighbors`.  Distances are *squared* l2;
``get_nns`` and ``get_batch_nns`` return numpy arrays for every method.
Methods:

- ``"exact"`` (alias ``"brute"``): the exact search on the device, by one
  of two routes chosen by what the index is:

  * on a card, at ``feature_count <= 4``, ``train_count >= 2048`` and
    float32 rows, for a request of at most 64 neighbours
    (``get_batch_nns`` asks for ``nn_count + 1``): one launch of the
    pruned exact kernel (:mod:`muygpys_torch.gpu.knn_exact`) over the rows
    Morton-sorted once per index into tiles of 256 with their bounding
    boxes.  It scores the few tiles that can hold a neighbour and returns
    each query's exact ``nn_count`` nearest rows with their distances by
    direct differences, no re-rank needed; :attr:`NN_Wrapper.stats`
    counts the tiles it scored;
  * everywhere else (the CPU, ``d > 4``, smaller indices, float64 rows,
    more than 64 neighbours): Gram-identity distance tiles (a matrix
    product) reduced with ``torch.topk`` over an over-fetched candidate
    set, then an exact re-rank by direct differences.  There boxes stop
    pruning and the matrix product is the tool.

  The tiled route scans the training rows in the fewest equal tiles of at most
  :data:`_TRAIN_TILE` rows (padded and normed once per index), each
  tile's top-k merged by one top-k over the tiles' candidates, so memory
  stays ``O(query_tile * (train_tile + tiles * k))`` at any training size;
  up to :data:`_TRAIN_TILE` rows that is one block per query tile.  JAX
  scans only past one tile and picks each scanned tile's candidates with
  ``lax.approx_min_k`` (a TPU reduction) into a running top-k; here each
  tile's top-k is exact, and after the re-rank both give the exact sets.
  Among neighbors at equal distances (points on a grid) the choice is the
  rounding's (on the kernel's route, its walk's), each package its own:
  the sets agree with JAX's up to such ties;
- ``"kernel"`` (alias ``"pallas"``, the JAX name): the K3 candidate kernel
  (:mod:`muygpys_torch.gpu.knn`, 1024 bins, Morton-sorted and pruned at
  ``d <= 4``; its train side built once per index) followed by the same
  exact re-rank;
- ``"sklearn"``: scikit-learn's exact ``NearestNeighbors`` on the host,
  imported when the index is built (an ``ImportError`` names it where it is
  not installed);
- ``"hnsw"``: the approximate HNSW graph of :mod:`muygpys_torch.native`,
  on the host.

Under a recording :mod:`torch.profiler` every search is a
``muygpys.nn.get_nns`` span, and a device search's candidates (the exact
kernel on its route) and re-rank are spans inside it
(:mod:`muygpys_torch.tracing`).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gpu import knn as _knn
from muygpys_torch.gpu import knn_exact as _knn_exact
from muygpys_torch.tracing import span

_QUERY_TILE = 512
_TRAIN_TILE = 16384

#: keyword arguments each host method takes (the JAX package's sets)
SKLEARN_KEYS = {"radius", "algorithm", "leaf_size", "metric", "p",
                "metric_params", "n_jobs"}
HNSW_KEYS = {"max_elements", "ef_construction", "M", "random_seed"}


def _train_tiles(
    train: torch.Tensor, train_tile: int = _TRAIN_TILE
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The brute-force search's train side, built once per index: the rows
    split into the fewest tiles of at most ``train_tile`` rows, all of one
    size (rounded up to 8), and padded to whole tiles with ``+inf`` norms so
    a padded row never enters a top-k.  Returns ``(padded rows, squared
    norms, tile size)``."""
    train_count = train.shape[0]
    t_tiles = -(-train_count // train_tile)
    tile = 8 * -(-train_count // (8 * t_tiles))
    train_pad = torch.nn.functional.pad(
        train, (0, 0, 0, t_tiles * tile - train_count)
    )
    train_sq = torch.sum(train_pad * train_pad, dim=-1)
    train_sq[train_count:] = math.inf
    return train_pad, train_sq, tile


def _brute_force_knn(
    train: torch.Tensor,
    queries: torch.Tensor,
    nn_count: int,
    query_tile: int = _QUERY_TILE,
    train_tile: int = _TRAIN_TILE,
    tiles=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest squared-l2 distances through the Gram identity, in
    ``(query_tile, tile)`` blocks whatever the training size: one
    ``addmm`` and one top-k a block, then one top-k over the tiles'
    candidates.  ``|t|^2 - 2 q.t`` ranks a query's row as ``|q - t|^2``
    does, so ``|q|^2`` is added to the ``nn_count`` nearest alone.
    ``tiles`` is :func:`_train_tiles`'s result, built once per index (from
    ``train`` in tiles of at most ``train_tile`` rows when absent)."""
    train_pad, train_sq, tile = (
        _train_tiles(train, train_tile) if tiles is None else tiles
    )
    bases = range(0, train_pad.shape[0], tile)
    # the tiles' top-k indices are tile-local: offsets map them back
    offsets = torch.arange(
        0, train_pad.shape[0], tile, device=queries.device
    ).repeat_interleave(nn_count)
    idx, d2 = [], []
    for start in range(0, queries.shape[0], query_tile):
        q = queries[start:start + query_tile]
        cand_d, cand_i = [], []
        for base in bases:
            part = torch.addmm(train_sq[base:base + tile], q,
                               train_pad[base:base + tile].T, alpha=-2.0)
            vals, sel = torch.topk(part, nn_count, dim=1, largest=False)
            cand_d.append(vals)
            cand_i.append(sel)
        if len(bases) == 1:
            best_d, best_i = cand_d[0], cand_i[0]
        else:
            best_d, pick = torch.topk(torch.cat(cand_d, dim=1), nn_count,
                                      dim=1, largest=False)
            best_i = torch.gather(torch.cat(cand_i, dim=1) + offsets, 1, pick)
        idx.append(best_i)
        d2.append(torch.clamp_min(best_d + torch.sum(q * q, -1)[:, None], 0.0))
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
        nn_method: ``"exact"`` (default), ``"brute"`` (its alias),
            ``"kernel"`` (alias ``"pallas"``), ``"sklearn"`` or ``"hnsw"``.
        device: where the device methods' index lives and searches
            (default ``"cuda"``); the host methods search on the CPU.
        **kwargs: the JAX package's keywords: ``spatial_sort``
            (``"kernel"`` only: Morton-sort a copy of the training rows so
            the candidate kernel skips provably irrelevant tiles; default
            ``None`` = on for ``feature_count <= 4``); scikit-learn's
            ``radius``, ``algorithm``, ``leaf_size``, ``metric``, ``p``,
            ``metric_params``, ``n_jobs``; HNSW's ``max_elements``
            (default: the training count), ``ef_construction``, ``M``,
            ``random_seed``.  Other keywords are ignored, as in JAX.
    """

    def __init__(
        self,
        train,
        nn_count: int,
        nn_method: str = "exact",
        device=None,
        **kwargs,
    ):
        self.device = config.device(device)
        train = np.asarray(train)
        if train.ndim == 1:
            train = train[:, None]
        self.train = train
        self.train_count, self.feature_count = train.shape
        self.nn_count = nn_count
        self.nn_method = config.kernel_alias(nn_method.lower())
        self._exact = None
        self._stats = {"searches": 0, "queries": 0, "tiles_total": 0}
        if self.nn_method in ("exact", "brute", "kernel"):
            self._build_device_index(kwargs.get("spatial_sort"))
        elif self.nn_method == "sklearn":
            try:
                from sklearn.neighbors import NearestNeighbors
            except ImportError as err:
                raise ImportError(
                    "nn_method='sklearn' needs scikit-learn, which is not "
                    "installed; 'exact' gives the same neighbors on the "
                    "device"
                ) from err
            self.nbrs = NearestNeighbors(
                n_neighbors=nn_count,
                **{k: v for k, v in kwargs.items() if k in SKLEARN_KEYS},
            ).fit(train)
        elif self.nn_method == "hnsw":
            from muygpys_torch.native import HNSW

            index_kwargs = {
                k: v for k, v in kwargs.items() if k in HNSW_KEYS
            }
            index_kwargs.setdefault("max_elements", self.train_count)
            self.nbrs = HNSW(self.feature_count, **index_kwargs)
            self.nbrs.add_items(train)
        else:
            raise NotImplementedError(
                f"selected nn_method {nn_method} is not implemented "
                "(exact, brute, kernel, pallas, sklearn, hnsw)"
            )

    def _build_device_index(self, spatial_sort) -> None:
        self._train_dev = torch.as_tensor(self.train, device=self.device)
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
        self._knn_index = self._tiles = None
        if self.nn_method == "kernel" and self.train_count >= 2048:
            self._knn_index = _knn.build_index(
                self._train_sorted if self._spatial else self._train_dev,
                bins=1024, pruned=self._spatial,
            )
        elif _knn_exact.takes(self._train_dev):
            self._exact = _knn_exact.build_exact_index(self._train_dev)
        else:
            self._tiles = _train_tiles(self._train_dev)

    @property
    def stats(self) -> dict:
        """``searches`` and ``queries`` answered, every method; on the exact
        kernel's route ``tiles_total`` (the tiles of the index times the
        queries searched) and ``tiles_scored`` (those the kernel did not
        skip: read from the card's counter when asked, so the searches
        themselves never wait for it), 0 elsewhere.  Their ratio is the
        pruning's hit rate."""
        out = dict(self._stats)
        out["tiles_scored"] = (
            0 if self._exact is None else int(self._exact.scored.item())
        )
        return out

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
        with span("muygpys.nn.get_nns"):
            test = np.asarray(test)
            if test.ndim == 1:
                test = test[:, None]
            self._stats["searches"] += 1
            self._stats["queries"] += test.shape[0]
            if self.nn_method == "sklearn":
                dists, idx = self.nbrs.kneighbors(test, n_neighbors=nn_count)
                return idx, dists**2  # hnsw's squared-l2 convention
            if self.nn_method == "hnsw":
                idx, d2 = self.nbrs.knn_query(test, k=nn_count)
                return idx, d2.astype(np.float64)
            queries = torch.as_tensor(test, dtype=self._train_dev.dtype,
                                      device=self.device)
            if self._exact is not None and nn_count <= _knn_exact.MAX_K:
                with span("muygpys.nn.candidates"):
                    idx, d2 = _knn_exact.knn_exact_select(
                        self._exact, queries.contiguous(), nn_count)
                self._stats["tiles_total"] += (
                    test.shape[0] * _knn_exact.tile_count(self._exact))
                return idx.cpu().numpy(), d2.cpu().numpy()
            # over-fetch through the Gram identity, then re-rank exactly: the
            # identity loses ~eps*|a|^2 absolute precision, which scrambles
            # ranking once nearest distances approach that floor
            cand_count = min(nn_count + 32, self.train_count)
            with span("muygpys.nn.candidates"):
                if self._knn_index is not None:
                    # 1024 bins: the host KNN API favors recall over merge
                    # cost; below 2*bins train rows the exact engine is used
                    # instead
                    if self._spatial:
                        cand_s, _ = _knn.knn_cuda_pruned(
                            None, queries, cand_count, bins=1024,
                            device=self.device, train_index=self._knn_index,
                        )
                        cand_idx = self._perm_dev[cand_s]
                    else:
                        cand_idx, _ = _knn.knn_cuda(
                            None, queries, cand_count, bins=1024,
                            device=self.device, train_index=self._knn_index,
                        )
                else:
                    if self._tiles is None:
                        # the kernel's route asked for more than it returns:
                        # the tiles are built at the first such request
                        self._tiles = _train_tiles(self._train_dev)
                    cand_idx, _ = _brute_force_knn(
                        self._train_dev, queries, cand_count, tiles=self._tiles
                    )
            with span("muygpys.nn.refine"):
                idx, d2 = _refine_knn(self._train_dev, queries, cand_idx,
                                      nn_count)
            return idx.cpu().numpy(), d2.cpu().numpy()
