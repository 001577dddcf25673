"""The exact nearest-neighbour search at low dimension: one hand-written
kernel over a Morton-sorted index, pruned by tile bounding boxes, and its
plain mirror.

:func:`build_exact_index` sorts the training rows along the Morton curve
(the quantisation of :func:`muygpys_torch.gpu.knn._morton_codes`) and cuts
them into tiles of :data:`TILE` rows; the index holds the rows
feature-major, each tile's bounding box and first Morton code, the
permutation back to the caller's rows, the curve's grid, and a device
counter of the tiles the kernel scored.  It is built once per index.

:func:`knn_exact_select` gives each query's exact ``k`` nearest rows
(``idx`` int64 in the caller's numbering, ``d2`` f32, both ``(Q, k)``,
ascending).  On a card it is one launch of ``csrc/knn_exact.cu``, counted
as ``"knn_exact_select"``: a warp per query scores the tile holding the
query's Morton code and its two neighbours, then every tile whose box is
within the query's current k-th distance.  CPU tensors take
:func:`knn_exact_select_plain`, which scores every row.  Both compute a
distance as ``sum_f (q_f - t_f)^2`` in feature order, each operation
rounded on its own, so the kernel's distances are the mirror's bits (and
:func:`muygpys_torch.neighbors._refine_knn`'s at the same indices on the
CPU and, at ``d <= 2``, on a card, whose ``torch.sum`` adds 3 or 4
features in another order, within an ulp or two).  The
kernel skips a tile only when the same expression of its box's gaps
exceeds the k-th distance, which rounding to nearest keeps below every
row's distance in the tile: the result is the exact k smallest distances,
the order among equal distances the walk's (``csrc/knn_exact.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from muygpys_torch.gpu import _build
from muygpys_torch.gpu import knn as _knn

#: the kernel's bounds: features and neighbours (two list slots a lane)
MAX_FEAT = 4
MAX_K = 64
#: rows a tile
TILE = 256

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class ExactIndex(NamedTuple):
    """The train side of the exact search, built once per index."""

    tT: torch.Tensor  # (f, n) f32: the rows, Morton-sorted, feature-major
    box: torch.Tensor  # (2 f, nt) f32: each tile's lower corner, then upper
    first: torch.Tensor  # (nt,) int32: each tile's first Morton code
    perm: torch.Tensor  # (n,) int64: sorted position -> the caller's row
    grid: torch.Tensor  # (2 f,) f32: the curve's origin, then its scale
    bits: int  # Morton bits a feature
    tile: int
    scored: torch.Tensor  # (1,) int64: tiles scored, added by every search


def build_exact_index(train: torch.Tensor) -> ExactIndex:
    """The index of ``(n, f)`` rows (``f <= 4``) on their device, in f32,
    in tiles of :data:`TILE` rows."""
    train = train.to(torch.float32)
    n, feat = train.shape
    if not 1 <= feat <= MAX_FEAT:
        raise ValueError(
            f"the exact kernel takes 1 to {MAX_FEAT} features, not {feat}")
    tile = TILE
    grid = _knn._morton_grid(train)
    perm = _knn.spatial_sort(train, grid=grid)
    rows = train[perm]
    nt = -(-n // tile)
    # edge-padded: a padded row repeats the last, so no box widens
    lo, hi = _knn._tile_bboxes(_knn._edge_pad(rows, nt * tile), tile)
    return ExactIndex(
        rows.T.contiguous(), torch.cat([lo.T, hi.T]).contiguous(),
        _knn._morton_codes(rows[::tile], grid=grid), perm,
        torch.cat([grid[0], grid[1]]).contiguous(), grid[2], tile,
        torch.zeros(1, dtype=torch.int64, device=train.device),
    )


def tile_count(index: ExactIndex) -> int:
    return index.box.shape[1]


def takes(train) -> bool:
    """Whether an exact search over ``train`` (anything with ``device``,
    ``shape`` and ``dtype``) is the kernel's: on a card, 1 to 4 features,
    at least 2048 float32 rows.  Elsewhere the Gram-identity tiles of
    :func:`muygpys_torch.neighbors._brute_force_knn` are the tool: boxes
    stop pruning at higher dimension, and a small index is one tile."""
    return (
        train.device.type == "cuda"
        and 1 <= train.shape[1] <= MAX_FEAT
        and train.shape[0] >= 2048
        and train.dtype == torch.float32
    )


def _check(index: ExactIndex, queries: torch.Tensor, k: int) -> None:
    """Raise on what the kernel does not take (on every device, so the CPU
    shows what the card would refuse)."""
    feat, n = index.tT.shape
    if not 1 <= feat <= MAX_FEAT:
        raise ValueError(
            f"the exact kernel takes 1 to {MAX_FEAT} features, not {feat}")
    if queries.dim() != 2 or queries.shape[1] != feat:
        raise ValueError(
            f"queries {tuple(queries.shape)} do not match the index's "
            f"{feat} features")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(
            f"k = {k}: the exact kernel returns 1 to {MAX_K} neighbours, at "
            f"most the index's {n} rows")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, not {queries.dtype}")
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")
    if queries.device != index.tT.device:
        raise ValueError(
            f"queries on {queries.device}, the index on {index.tT.device}")


def knn_exact_select_plain(
    index: ExactIndex, queries: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`knn_exact_select`: every row scored
    by the kernel's expression, then an exact ``torch.topk``; every tile
    counts as scored.  The same distances, bit for bit; among equal
    distances ``torch.topk`` chooses."""
    tT = index.tT
    n = tT.shape[1]
    chunk = max(1, 2**24 // n)  # queries a step: ~64 MB of distances
    idx, d2 = [], []
    for start in range(0, max(queries.shape[0], 1), chunk):
        q = queries[start:start + chunk]
        d = (q[:, 0:1] - tT[0:1]) ** 2
        for f in range(1, tT.shape[0]):
            d = d + (q[:, f:f + 1] - tT[f:f + 1]) ** 2
        vals, sel = torch.topk(d, k, dim=1, largest=False)
        idx.append(index.perm[sel])
        d2.append(vals)
    index.scored.add_(queries.shape[0] * tile_count(index))
    return torch.cat(idx), torch.cat(d2)


def knn_exact_select(
    index: ExactIndex, queries: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's exact ``k`` nearest rows: ``idx`` int64 (the caller's
    rows) and ``d2`` f32, ``(Q, k)`` in ascending order.  ``queries``
    ``(Q, f)`` f32, contiguous, on the index's device; ``k <= 64``.  CPU
    tensors take :func:`knn_exact_select_plain`; CUDA tensors launch the
    kernel (built on first use) or raise."""
    _check(index, queries, k)
    if queries.device.type == "cpu":
        return knn_exact_select_plain(index, queries, k)
    if queries.device.type != "cuda":
        raise ValueError(
            f"knn_exact_select runs on cpu or cuda, not {queries.device}")
    q_count, feat = queries.shape
    n = index.tT.shape[1]
    idx = torch.empty((q_count, k), dtype=torch.int64, device=queries.device)
    d2 = torch.empty((q_count, k), dtype=torch.float32, device=queries.device)
    fn = _build.function("knn_exact", "knn_exact_select", _ARGTYPES)
    with _build.on_device(queries.device):
        rc = fn(
            _build.ptr(queries), _build.ptr(index.tT), _build.ptr(index.box),
            _build.ptr(index.first), _build.ptr(index.perm),
            _build.ptr(index.grid), _build.ptr(idx), _build.ptr(d2),
            _build.ptr(index.scored), q_count, feat, n, index.tile,
            tile_count(index), k, index.bits, _build.stream(queries.device),
        )
    _build.check(rc, "knn_exact", "knn_exact_select")
    _build.count("knn_exact_select")
    return idx, d2

