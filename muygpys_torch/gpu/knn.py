"""K3: packed-key KNN candidate selection, CUDA kernel plus PyTorch glue.

Counterpart of :mod:`muygpys_tpu.pallas.knn`.  The distance field never
leaves the kernel: per query and residue bin ``col % bins`` it keeps the two
smallest *packed keys* (f32 squared distance with its low ``chunk_bits``
mantissa bits replaced by the column's chunk ``col // bins``), so the
candidate's train index decodes algebraically from (merge position, key low
bits).

Two designs of the kernel (``csrc/knn.cu``), picked by :func:`knn_design`:

- ``"fused"`` (``feat <= 4``, ``k <= 64``, ``bins`` in {256, 512, 1024}):
  the kernel also merges each query's ``2 * bins`` keys exactly and decodes
  them, and writes only ``(idx, d2)`` of shape ``(Q_pad, k)``; its pruned
  search on a card is the bounded route (:func:`prepare_bounded`): each
  block of 8 queries prunes the index's boxes of :data:`BOX` columns against
  its own bound, and its candidates are the unpruned search's bit for bit;
- ``"keys"`` (every other shape): the kernel writes the key state ``s1``,
  ``s2`` ``(Q_pad, bins)`` (:func:`knn_candidates`; its plain mirror
  :func:`knn_candidates_plain` gives the same bits) and the glue merges it
  with an exact ``torch.topk`` (:func:`_merge_decode`; JAX's
  ``approx_min_k`` is exact on the CPU, so CPU results match the JAX
  package).

:func:`knn_select` runs either; its plain version :func:`knn_select_plain`
is the keys mirror followed by the merge.  The rest of the glue is plain
PyTorch, as it was plain XLA in the JAX package: padding, norms, Morton
sorting and the bounding-box pruning bounds (the skip table of the keys
design and of the CPU, as the JAX package's); on a card the bounded route
orders up to :data:`ORDER_CAP` queries in one launch of a kernel of its own
(:func:`knn_query_order`), bit for bit as the plain sort.  The train side
is built once per index (:func:`build_index`), so a request computes only
its query side.

Public counterparts: :func:`knn_cuda` ↔ ``knn_pallas``,
:func:`knn_cuda_pruned` ↔ ``knn_pallas_pruned``; ``spatial_sort``,
``_morton_codes``, ``_tile_bboxes``, ``_bbox_lb2`` and ``_merge_decode``
keep their names.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from muygpys_torch import config
from muygpys_torch.gpu import _build

# init sentinel: 2^127 (huge finite, zero mantissa -> zero chunk bits);
# padded train columns get 1e30 norms, also never selected
_INIT_KEY_BITS = 0x7F000000

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SELECT_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
)
_BOUNDED_ARGTYPES = (
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
)
_ORDER_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)

#: the fused design's bounds (``csrc/knn.cu``): features, neighbours, bins
FUSED_MAX_FEAT = 4
FUSED_MAX_K = 64
FUSED_BINS = (256, 512, 1024)
#: queries a block of either design owns (one query tile holds them)
_BLOCK_QUERIES = 8
#: columns a box of the bounded route: one block-wide step of the fused walk
BOX = 256
#: the most queries one launch of the order kernel sorts: one block of 1024
#: threads, 8 queries a thread, in shared memory (``csrc/knn.cu``)
ORDER_CAP = 8192


def knn_design(feat: int, k: int, bins: int) -> str:
    """The K3 design a launch takes: ``"fused"`` (the merge inside the
    kernel) for ``feat <= 4``, ``k <= 64`` and ``bins`` in {256, 512,
    1024}, else ``"keys"`` (the key state, merged by ``torch.topk``)."""
    if (
        1 <= feat <= FUSED_MAX_FEAT and 1 <= k <= FUSED_MAX_K
        and bins in FUSED_BINS
    ):
        return "fused"
    return "keys"


def knn_candidates_plain(
    q, qsq, tT, tsq, bins, train_tile, query_tile, chunk_mask,
    lb=None, ub=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the keys design: the same operations in the
    same rounding order, so ``s1``/``s2`` agree bit for bit."""
    q_count = q.shape[0]
    feat, t_count = tT.shape
    s1 = torch.full(
        (q_count, bins), _INIT_KEY_BITS, dtype=torch.int32, device=q.device
    )
    s2 = s1.clone()
    chunks_per_tile = train_tile // bins
    if lb is not None:
        run_rows = (lb <= ub[:, None]).repeat_interleave(query_tile, dim=0)
    for j in range(t_count // train_tile):
        cols = slice(j * train_tile, (j + 1) * train_tile)
        dot = q[:, 0:1] * tT[0:1, cols]
        for f in range(1, feat):
            dot = dot + q[:, f:f + 1] * tT[f:f + 1, cols]
        dist = torch.clamp_min(
            (qsq[:, None] + tsq[None, cols]) - 2.0 * dot, 0.0
        )
        bits = dist.view(torch.int32)
        for g in range(chunks_per_tile):
            chunk = j * chunks_per_tile + g
            key = (bits[:, g * bins:(g + 1) * bins] & ~chunk_mask) | chunk
            if lb is not None:
                # a skipped tile leaves the state as it was
                key = torch.where(
                    run_rows[:, j:j + 1], key, torch.full_like(key, _INIT_KEY_BITS)
                )
            lo = torch.minimum(key, s1)
            s2 = torch.minimum(torch.maximum(key, s1), s2)
            s1 = lo
    return s1, s2


def _check_launch(q, qsq, tT, tsq, bins, train_tile, query_tile, lb, ub):
    """Raise on what neither design takes: a device other than the CPU or a
    card, types, contiguity, the tiling, the skip table's shape."""
    if q.device.type != "cuda":
        raise ValueError(f"knn_candidates runs on cpu or cuda, not {q.device}")
    q_count, feat = q.shape
    t_count = tT.shape[1]
    tensors = {"q": q, "qsq": qsq, "tT": tT, "tsq": tsq}
    if lb is not None:
        tensors.update(lb=lb, ub=ub)
    for name, t in tensors.items():
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nq, nt = q_count // query_tile, t_count // train_tile
    if (
        tT.shape[0] != feat or qsq.shape != (q_count,)
        or tsq.shape != (t_count,)
        or q_count % query_tile or query_tile % _BLOCK_QUERIES
        or t_count % train_tile or train_tile % bins
        or (bins > 256 and bins % 256)
    ):
        raise ValueError(
            f"knn_candidates geometry: q {tuple(q.shape)}, tT "
            f"{tuple(tT.shape)}, bins {bins}, train_tile {train_tile}, "
            f"query_tile {query_tile}"
        )
    if lb is not None and (lb.shape != (nq, nt) or ub.shape != (nq,)):
        raise ValueError(
            f"skip table lb {tuple(lb.shape)} / ub {tuple(ub.shape)} does "
            f"not match ({nq}, {nt})"
        )


def knn_candidates(
    q, qsq, tT, tsq, bins, train_tile, query_tile, chunk_mask,
    lb=None, ub=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keys design's wrapper: two smallest packed keys per (query, bin).

    ``q (Q_pad, f)``, ``qsq (Q_pad,)``, ``tT (f, T_pad)``, ``tsq (T_pad,)``
    f32; optional skip table ``lb (nq, nt)``, ``ub (nq,)``.  Returns
    ``s1, s2 (Q_pad, bins)`` int32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (built on first use) or raise.
    """
    pruned = lb is not None
    if q.device.type == "cpu":
        return knn_candidates_plain(
            q, qsq, tT, tsq, bins, train_tile, query_tile, chunk_mask, lb, ub
        )
    _check_launch(q, qsq, tT, tsq, bins, train_tile, query_tile, lb, ub)
    q_count, feat = q.shape
    s1 = torch.empty((q_count, bins), dtype=torch.int32, device=q.device)
    s2 = torch.empty_like(s1)
    fn = _build.function("knn", "knn_candidates", _ARGTYPES)
    with _build.on_device(q.device):
        rc = fn(
            _build.ptr(q), _build.ptr(qsq), _build.ptr(tT), _build.ptr(tsq),
            _build.ptr(lb), _build.ptr(ub), _build.ptr(s1), _build.ptr(s2),
            q_count, feat, tT.shape[1], bins, train_tile, query_tile,
            chunk_mask, _build.stream(q.device),
        )
    _build.check(rc, "knn", "knn_candidates")
    _build.count(
        "knn_candidates_pruned" if pruned else "knn_candidates",
        "knn_candidates/keys",
    )
    return s1, s2


class Boxes(NamedTuple):
    """The bounded route's side of a pruned index (:func:`build_index`):
    the Morton-sorted columns in boxes of :data:`BOX`."""

    box: torch.Tensor  # (2 f, nb) f32: each box's lower corner, then upper
    norm: torch.Tensor  # (nb,) f32: its real columns' largest norm (0: none)
    first: torch.Tensor  # (nb,) int32: its first row's Morton code
    grid: torch.Tensor  # (2 f,) f32: the curve's origin, then its scale
    bits: int  # Morton bits a feature
    counts: torch.Tensor  # (2,) int64: boxes of the index, boxes walked;
    # every launch adds both for each of its blocks of 8 queries


class TrainIndex(NamedTuple):
    """The train side of a candidate search, built once per index
    (:func:`build_index`): every request against the same train set and
    geometry reuses it."""

    tT: torch.Tensor  # (f, T_pad) f32, the padded train set transposed
    tsq: torch.Tensor  # (T_pad,) norms; padded columns 1e30
    tlo: Optional[torch.Tensor]  # (nt, f) train tile bounding boxes (pruned)
    thi: Optional[torch.Tensor]
    boxes: Optional[Boxes]  # the bounded route's (pruned, fused shapes)
    sub: Optional["TrainIndex"]  # the 1/subsample row subset's own (pruned)
    bins: int
    train_tile: int
    chunk_mask: int
    train_count: int


class Prepared(NamedTuple):
    """The kernel's inputs for one candidate search, plus what the merge
    and the caller need to map results back."""

    q: torch.Tensor
    qsq: torch.Tensor
    tT: torch.Tensor
    tsq: torch.Tensor
    lb: Optional[torch.Tensor]
    ub: Optional[torch.Tensor]
    bins: int
    train_tile: int
    query_tile: int
    chunk_mask: int
    train_count: int
    query_count: int
    qperm: Optional[torch.Tensor]
    boxes: Optional[Boxes] = None  # the bounded route's (no table)
    qinv: Optional[torch.Tensor] = None  # qperm's inverse (pruned searches)

    def candidates(self):
        """The keys design's ``s1, s2`` (:func:`knn_candidates`)."""
        return knn_candidates(
            self.q, self.qsq, self.tT, self.tsq, self.bins,
            self.train_tile, self.query_tile, self.chunk_mask,
            self.lb, self.ub,
        )


def knn_select_plain(prep: Prepared, k: int):
    """Plain PyTorch version of :func:`knn_select`: the keys mirror, then
    the exact merge and decode.  A bounded route's ``prep`` carries no
    table: the unpruned search, whose candidates the kernel gives bit for
    bit."""
    return _merge_decode(
        *knn_candidates_plain(
            prep.q, prep.qsq, prep.tT, prep.tsq, prep.bins, prep.train_tile,
            prep.query_tile, prep.chunk_mask, prep.lb, prep.ub,
        ),
        k, prep,
    )


def knn_select(prep: Prepared, k: int, design: Optional[str] = None):
    """The ``k`` nearest candidates of every padded query: ``idx`` int64 and
    ``d2`` f32, both ``(Q_pad, k)``, in ascending key order.

    CPU tensors take :func:`knn_select_plain`.  On a card: the design of
    :func:`knn_design` (the keys design where ``prep`` carries the skip
    table), or ``design`` where a caller compares the two (the kernel
    refuses a fused launch outside its bounds); ``"keys"`` launches
    :func:`knn_candidates` and merges with ``torch.topk``; the fused design
    on a bounded route's ``prep`` (:func:`prepare_bounded`) launches the
    bounded kernel.  Keys equal to each other may come out in another order
    than ``torch.topk``'s; the distances are the same bits.
    """
    if prep.q.device.type == "cpu":
        return knn_select_plain(prep, k)
    feat = prep.q.shape[1]
    design = design or (
        "keys" if prep.lb is not None else knn_design(feat, k, prep.bins))
    if design == "keys":
        return _merge_decode(*prep.candidates(), k, prep)
    if prep.lb is not None:
        raise ValueError("the skip table is the keys design's; the fused "
                         "design prunes by the bounded route")
    if prep.boxes is not None:
        return _select_bounded(prep, k)
    q, qsq, tT, tsq = prep[:4]
    _check_launch(q, qsq, tT, tsq, prep.bins, prep.train_tile,
                  prep.query_tile, None, None)
    q_count = q.shape[0]
    idx = torch.empty((q_count, k), dtype=torch.int64, device=q.device)
    d2 = torch.empty((q_count, k), dtype=torch.float32, device=q.device)
    fn = _build.function("knn", "knn_select", _SELECT_ARGTYPES)
    with _build.on_device(q.device):
        rc = fn(
            _build.ptr(q), _build.ptr(qsq), _build.ptr(tT), _build.ptr(tsq),
            _build.ptr(idx), _build.ptr(d2), q_count, feat, tT.shape[1],
            prep.bins, prep.chunk_mask, k, prep.train_count,
            _build.stream(q.device),
        )
    _build.check(rc, "knn", "knn_select")
    _build.count("knn_candidates", "knn_candidates/fused")
    return idx, d2


def _select_bounded(prep: Prepared, k: int):
    """The bounded route's launch (``csrc/knn.cu:knn_bounded``): the fused
    design's candidates, counted as K3p."""
    q, qsq, tT, tsq = prep[:4]
    _check_launch(q, qsq, tT, tsq, prep.bins, prep.train_tile,
                  _BLOCK_QUERIES, None, None)
    boxes = prep.boxes
    for name in ("box", "norm", "grid"):
        t = getattr(boxes, name)
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"boxes.{name} must be float32 on {q.device}")
    nb = boxes.norm.shape[0]
    if boxes.box.shape != (2 * q.shape[1], nb) or nb * BOX != tT.shape[1]:
        raise ValueError(
            f"boxes {tuple(boxes.box.shape)} do not cover tT "
            f"{tuple(tT.shape)} in boxes of {BOX}")
    q_count, feat = q.shape
    idx = torch.empty((q_count, k), dtype=torch.int64, device=q.device)
    d2 = torch.empty((q_count, k), dtype=torch.float32, device=q.device)
    fn = _build.function("knn", "knn_bounded", _BOUNDED_ARGTYPES)
    with _build.on_device(q.device):
        rc = fn(
            _build.ptr(q), _build.ptr(qsq), _build.ptr(tT), _build.ptr(tsq),
            _build.ptr(boxes.box), _build.ptr(boxes.norm),
            _build.ptr(boxes.first), _build.ptr(boxes.grid), _build.ptr(idx),
            _build.ptr(d2), _build.ptr(boxes.counts), q_count, feat,
            tT.shape[1], prep.bins, nb, boxes.bits, prep.chunk_mask, k,
            prep.train_count, _build.stream(q.device),
        )
    _build.check(rc, "knn", "knn_bounded")
    _build.count("knn_candidates_pruned", "knn_candidates/fused")
    return idx, d2


def _check_count(nn_count, bins):
    if nn_count > 2 * bins:
        # the state holds exactly two candidates per residue bin
        raise ValueError(
            f"nn_count {nn_count} exceeds the 2*bins={2 * bins} candidates "
            "the kernel retains; raise bins or use an exact engine"
        )


def _chunk_mask(train_count, train_tile, bins) -> Tuple[int, int]:
    """(padded train count, chunk mask) of the packed-key geometry."""
    if train_tile % bins != 0:
        raise ValueError(f"bins {bins} must divide train_tile {train_tile}")
    t_padded = math.ceil(train_count / train_tile) * train_tile
    chunk_bits = max(1, math.ceil(math.log2(t_padded // bins)))
    if chunk_bits > 14:
        raise ValueError(
            f"{train_count} train points need {chunk_bits} chunk bits at "
            f"bins={bins}; > 14 bits erodes candidate resolution — raise "
            "bins or shard the train set"
        )
    return t_padded, (1 << chunk_bits) - 1


def _norms(pts: torch.Tensor, valid: int) -> torch.Tensor:
    sq = torch.sum(pts * pts, dim=-1)
    # huge-but-finite norm keeps padded rows out of every bin minimum
    # (+inf would turn into NaN once chunk bits are OR'ed into the key)
    return torch.where(
        torch.arange(pts.shape[0], device=pts.device) < valid,
        sq, torch.full_like(sq, 1e30),
    )


def _edge_pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    pad = rows - x.shape[0]
    return torch.cat([x, x[-1:].expand(pad, -1)]) if pad else x


def build_index(
    train, train_tile=2048, bins=512, pruned=False, subsample=16, grid=None
) -> TrainIndex:
    """The train side of the unpruned (:func:`knn_cuda`) or, with
    ``pruned``, the pruned search (:func:`knn_cuda_pruned`; ``train``
    Morton-sorted): the padded train set transposed, its norms and, when
    pruned, the train tiles' bounding boxes and the ``1/subsample`` row
    subset's own unpruned index (the skip table's: the tiles' lower bounds,
    the queries' upper bounds) and the boxes of the bounded route
    (:class:`Boxes`, at ``feat <= 4`` and fused ``bins``).  ``grid``
    (:func:`_morton_grid`) is the grid ``train`` was sorted on, where that
    is not the rows' own: a slice of a larger sorted set."""
    train = torch.as_tensor(train).to(torch.float32)
    train_count, feat = train.shape
    t_padded, mask = _chunk_mask(train_count, train_tile, bins)
    if not pruned:
        train_pad = torch.nn.functional.pad(
            train, (0, 0, 0, t_padded - train_count)
        )
        return TrainIndex(
            train_pad.T.contiguous(), _norms(train_pad, train_count),
            None, None, None, None, bins, train_tile, mask, train_count,
        )
    # edge-pad (not zero-pad): padded rows must not widen the last tile's
    # bounding box; the 1e30 sentinel norm still excludes them as columns
    train_pad = _edge_pad(train, t_padded)
    tsq = _norms(train_pad, train_count)
    tlo, thi = _tile_bboxes(train_pad, train_tile)
    bounded = 1 <= feat <= FUSED_MAX_FEAT and bins in FUSED_BINS
    return TrainIndex(
        train_pad.T.contiguous(), tsq, tlo, thi,
        _boxes(train_pad, tsq, train_count, grid) if bounded else None,
        build_index(train[::subsample], train_tile, bins),
        bins, train_tile, mask, train_count,
    )


def _boxes(train_pad, tsq, train_count, grid=None) -> Boxes:
    """The bounded route's boxes of the edge-padded, Morton-sorted rows:
    boxes of :data:`BOX` rows (padded rows repeat the last, so no box
    widens), their real columns' largest norms, first Morton codes on the
    grid the rows were sorted on (``grid``, else the rows' own), and a
    zeroed counter."""
    lo, hi = _tile_bboxes(train_pad, BOX)
    real = torch.arange(train_pad.shape[0], device=tsq.device) < train_count
    norm = torch.amax(torch.where(real, tsq, torch.zeros_like(tsq))
                      .reshape(-1, BOX), dim=1)
    if grid is None:
        grid = _morton_grid(train_pad[:train_count])
    return Boxes(
        torch.cat([lo.T, hi.T]).contiguous(), norm.contiguous(),
        _morton_codes(train_pad[::BOX], grid=grid),
        torch.cat([grid[0], grid[1]]).contiguous(), grid[2],
        torch.zeros(2, dtype=torch.int64, device=tsq.device),
    )


def _index_for(train, train_index, train_tile, bins, pruned, subsample=16):
    """``train_index`` after checking it was built for this geometry, or a
    new one."""
    if train_index is None:
        return build_index(train, train_tile, bins, pruned, subsample)
    if (
        (train_index.bins, train_index.train_tile) != (bins, train_tile)
        or (train_index.sub is not None) != pruned
    ):
        raise ValueError(
            f"train_index was built for bins {train_index.bins}, train_tile "
            f"{train_index.train_tile}, pruned {train_index.sub is not None}"
            f"; this search asks for bins {bins}, train_tile {train_tile}, "
            f"pruned {pruned}"
        )
    return train_index


def _prepared(index: TrainIndex, q_pad, query_tile, query_count, lb=None,
              ub=None, qperm=None, boxes=None, qinv=None) -> Prepared:
    return Prepared(
        q_pad.contiguous(), torch.sum(q_pad * q_pad, dim=-1), index.tT,
        index.tsq, lb, ub, index.bins, index.train_tile, query_tile,
        index.chunk_mask, index.train_count, query_count, qperm, boxes, qinv,
    )


def prepare(
    train, queries, nn_count, query_tile=128, train_tile=2048, bins=512,
    train_index: Optional[TrainIndex] = None,
) -> Prepared:
    """Inputs of the unpruned search (:func:`knn_cuda`); the train side
    from ``train_index`` where given (``train`` is then not read)."""
    _check_count(nn_count, bins)
    index = _index_for(train, train_index, train_tile, bins, False)
    queries = queries.to(torch.float32)
    query_count = queries.shape[0]
    q_padded = math.ceil(query_count / query_tile) * query_tile
    q_pad = torch.nn.functional.pad(queries, (0, 0, 0, q_padded - query_count))
    return _prepared(index, q_pad, query_tile, query_count)


def _sorted_queries(queries, multiple):
    """``(q_pad, qperm)``: the f32 queries along their own Morton curve
    (so that a tile or block of them is compact), edge-padded to a
    multiple of ``multiple`` rows."""
    queries = queries.to(torch.float32)
    qperm = spatial_sort(queries)
    rows = math.ceil(queries.shape[0] / multiple) * multiple
    return _edge_pad(queries[qperm], rows), qperm


def query_order_route(count: int, feat: int, device) -> str:
    """How the bounded route orders ``count`` queries of ``feat``
    features on ``device``: ``"kernel"`` (one launch of
    ``csrc/knn.cu:knn_query_order_kernel``) on a card for 1 to 4 features
    and 1 to :data:`ORDER_CAP` queries, else ``"torch"`` (the plain
    :func:`_sorted_queries` and an argsort for the inverse)."""
    if (
        torch.device(device).type == "cuda"
        and 1 <= feat <= FUSED_MAX_FEAT and 1 <= count <= ORDER_CAP
    ):
        return "kernel"
    return "torch"


def knn_query_order(queries):
    """``(q_pad, qperm, qinv)`` of the bounded route: the f32 queries
    along their own Morton curve, edge-padded to a multiple of 8 rows (a
    block of the bounded kernel), the permutation and its inverse.  By
    :func:`query_order_route`: one launch of the order kernel (counted
    ``"knn_query_order"``), or :func:`_sorted_queries` and
    ``torch.argsort`` (on a card counted ``"knn_query_order/torch"``),
    whose bits the kernel gives."""
    queries = queries.to(torch.float32)
    count, feat = queries.shape
    if query_order_route(count, feat, queries.device) == "torch":
        if queries.is_cuda:
            _build.count("knn_query_order/torch")
        q_pad, qperm = _sorted_queries(queries, _BLOCK_QUERIES)
        return q_pad, qperm, torch.argsort(qperm)
    queries = queries.contiguous()
    rows = math.ceil(count / _BLOCK_QUERIES) * _BLOCK_QUERIES
    q_pad = torch.empty((rows, feat), dtype=torch.float32,
                        device=queries.device)
    qperm = torch.empty(count, dtype=torch.int64, device=queries.device)
    qinv = torch.empty_like(qperm)
    fn = _build.function("knn", "knn_query_order", _ORDER_ARGTYPES)
    with _build.on_device(queries.device):
        rc = fn(
            _build.ptr(queries), _build.ptr(q_pad), _build.ptr(qperm),
            _build.ptr(qinv), count, feat, rows,
            _build.stream(queries.device),
        )
    _build.check(rc, "knn", "knn_query_order")
    _build.count("knn_query_order")
    return q_pad, qperm, qinv


def prepare_pruned(
    train, queries, nn_count, query_tile=128, train_tile=2048, bins=512,
    subsample=16, train_index: Optional[TrainIndex] = None,
) -> Prepared:
    """Inputs of the skip table's pruned search (:func:`knn_cuda_pruned`
    on the CPU and in the keys design), including the table; runs the
    unpruned kernel on the ``1/subsample`` row subset for the upper bound,
    as ``muygpys_tpu.pallas.knn.knn_pallas_pruned`` does.  The train side
    comes from ``train_index`` where given."""
    _check_count(nn_count, bins)
    index = _index_for(train, train_index, train_tile, bins, True, subsample)
    query_count = queries.shape[0]
    q_pad, qperm = _sorted_queries(queries, query_tile)
    nq = q_pad.shape[0] // query_tile

    # per-query upper bound on the k-th neighbor distance: max candidate
    # distance on a row subsample (k-th NN of a subset >= k-th NN of the
    # set), inflated past the packed-key mantissa truncation
    sub = _prepared(index.sub, q_pad, query_tile, nq * query_tile)
    _, d2_sub = knn_select(sub, min(nn_count, 2 * bins))
    d2_sub = torch.where(
        torch.isfinite(d2_sub), d2_sub, torch.full_like(d2_sub, 1e30)
    )
    ub_row = torch.amax(d2_sub, dim=1) * (1.0 + 2.0**-14)
    ub = torch.amax(ub_row.reshape(nq, query_tile), dim=1)

    qlo, qhi = _tile_bboxes(q_pad, query_tile)
    lb = _bbox_lb2(qlo, qhi, index.tlo, index.thi)  # (nq, nt)
    return _prepared(
        index, q_pad, query_tile, query_count, lb.contiguous(),
        ub.contiguous(), qperm, qinv=torch.argsort(qperm),
    )


def prepare_bounded(
    train, queries, nn_count, train_tile=2048, bins=512,
    train_index: Optional[TrainIndex] = None,
) -> Prepared:
    """Inputs of the bounded route (:func:`knn_cuda_pruned` on a card in
    the fused design; ``train`` Morton-sorted): the queries along their
    own Morton curve in blocks of 8 (:func:`knn_query_order`) and the
    index's boxes, no table.  Its plain version is the unpruned search's
    (:func:`knn_select_plain`), whose candidates the kernel gives bit for
    bit."""
    _check_count(nn_count, bins)
    index = _index_for(train, train_index, train_tile, bins, True)
    if index.boxes is None:
        raise ValueError(
            f"the bounded route takes 1 to {FUSED_MAX_FEAT} features and "
            f"bins in {FUSED_BINS}; this index has {index.tT.shape[0]} "
            f"features and {index.bins} bins")
    q_pad, qperm, qinv = knn_query_order(queries)
    return _prepared(index, q_pad, _BLOCK_QUERIES, queries.shape[0],
                     qperm=qperm, boxes=index.boxes, qinv=qinv)


def _merge_decode(s1, s2, nn_count, prep: Prepared):
    """Exact merge of the ``2 * bins`` surviving keys per query and the
    algebraic index decode: bin = merge position mod bins, chunk = key low
    bits, column = chunk * bins + bin.  Sentinel and padded-column keys that
    survive (train_count < 2 * bins) get an ``+inf`` distance and an
    in-range, possibly duplicate, index."""
    bins, mask = prep.bins, prep.chunk_mask
    # non-negative floats order like their bit patterns
    keys = torch.cat([s1, s2], dim=1).view(torch.float32)
    vals, sel = torch.topk(keys, min(nn_count, 2 * bins), dim=1, largest=False)
    vbits = vals.view(torch.int32)
    idx = (vbits & mask).to(torch.int64) * bins + (sel % bins)
    d2 = (vbits & ~mask).view(torch.float32)
    d2 = torch.where(d2 >= 1e29, torch.full_like(d2, math.inf), d2)
    idx = torch.clamp_max(idx, prep.train_count - 1)
    return idx, d2


def knn_cuda(
    train, queries, nn_count, query_tile=128, train_tile=2048, bins=512,
    device=None, train_index: Optional[TrainIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate KNN ``(indices, sq_dists)`` of shape ``(Q, nn_count)``
    through the K3 kernel; counterpart of ``knn_pallas``.

    Candidates, not guaranteed-exact neighbors: distances carry the
    packed-key truncation (<= 2^(chunk_bits-23) relative).  Callers
    over-fetch and re-rank exactly.  ``nn_count > 2 * bins`` raises.  A
    ``train_index`` from :func:`build_index` (``pruned=False``) saves the
    train side's work; ``train`` is then not read.
    """
    dev = config.device(device)
    prep = prepare(
        None if train_index is not None else torch.as_tensor(train, device=dev),
        torch.as_tensor(queries, device=dev), nn_count, query_tile,
        train_tile, bins, train_index,
    )
    idx, d2 = knn_select(prep, min(nn_count, 2 * bins))
    return idx[: prep.query_count], d2[: prep.query_count]


def knn_cuda_pruned(
    train, queries, nn_count, query_tile=128, train_tile=2048, bins=512,
    subsample=16, device=None, train_index: Optional[TrainIndex] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatially pruned candidate KNN; counterpart of ``knn_pallas_pruned``.

    ``train`` must be Morton-sorted (:func:`spatial_sort`) for tight
    bounding boxes; queries are sorted internally and results mapped back.
    A ``train_index`` from :func:`build_index` (``pruned=True``) saves the
    train side's work.  Two routes, by the input's shape:

    - on a card in the fused design (:func:`knn_design`; ``feat <= 4``,
      ``k <= 64``, ``bins`` in {256, 512, 1024}), the bounded route
      (:func:`prepare_bounded`, ``csrc/knn.cu:knn_bounded_kernel``): each
      block of 8 queries walks the boxes of :data:`BOX` columns holding its
      queries and the boxes on either side of each, bounds each query's
      k-th key from above by the top bits of its k-th smallest kept key
      (tau), and walks only the boxes whose lower bound, less an
      allowance for the kernel's own rounding, does not exceed tau.  A skipped column can neither enter the k selected
      nor displace one that does, so the candidates are the unpruned
      kernel's bit for bit (the argument and the allowance:
      ``csrc/knn.cu``'s header);
    - elsewhere (the CPU, the keys design) the skip table, as the JAX
      package: a (query tile, train tile) block is skipped only when its
      bounding-box lower bound exceeds the query tile's k-th-neighbor upper
      bound from the ``1/subsample`` rows, so the candidates equal the
      unpruned search's but for rare bin collisions.
    """
    dev = config.device(device)
    if train_index is None:
        train = torch.as_tensor(train, device=dev)
    queries = torch.as_tensor(queries, device=dev)
    k = min(nn_count, 2 * bins)
    if dev.type == "cuda" and knn_design(queries.shape[1], k, bins) == "fused":
        prep = prepare_bounded(train, queries, nn_count, train_tile, bins,
                               train_index)
    else:
        prep = prepare_pruned(train, queries, nn_count, query_tile,
                              train_tile, bins, subsample, train_index)
    idx, d2 = knn_select(prep, k)
    return (idx[: prep.query_count][prep.qinv],
            d2[: prep.query_count][prep.qinv])


def _morton_grid(pts: torch.Tensor, bits: int = 10):
    """``(origin, scale, bits)`` of the Morton quantization of ``pts``:
    each dimension's range cut into ``2**bits`` cells, the bits capped so
    that a code fits 30 bits."""
    pts = pts.to(torch.float32)
    bits = min(bits, 30 // pts.shape[1])
    lo = torch.amin(pts, dim=0)
    hi = torch.amax(pts, dim=0)
    # tensor / tensor: PyTorch computes scalar / tensor as a reciprocal
    # times the scalar, one rounding more than the JAX package's divide
    top = torch.full_like(hi, 2.0**bits - 1.0)
    return lo, top / torch.clamp_min(hi - lo, 1e-30), bits


def _morton_codes(pts: torch.Tensor, bits: int = 10, grid=None) -> torch.Tensor:
    """Morton (Z-order) codes: per-dimension quantization + bit interleave,
    capped to fit 30 bits; on ``grid`` (:func:`_morton_grid`) where given,
    else on the points' own."""
    pts = pts.to(torch.float32)
    d = pts.shape[1]
    lo, scale, bits = _morton_grid(pts, bits) if grid is None else grid
    q = torch.clamp((pts - lo) * scale, 0.0, 2.0**bits - 1.0).to(torch.int32)
    code = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    for b in range(bits):
        for dim in range(d):
            code = code | (((q[:, dim] >> b) & 1) << (b * d + dim))
    return code


def spatial_sort(pts: torch.Tensor, grid=None) -> torch.Tensor:
    """Permutation ordering points along a Morton curve (stable, as
    ``jnp.argsort``); on ``grid`` (:func:`_morton_grid`) where given."""
    return torch.argsort(_morton_codes(pts, grid=grid), stable=True)


def _tile_bboxes(pts_padded: torch.Tensor, tile: int):
    """(n_tiles, d) per-tile bounding boxes of a padded point array."""
    r = pts_padded.reshape(pts_padded.shape[0] // tile, tile, pts_padded.shape[1])
    return torch.amin(r, dim=1), torch.amax(r, dim=1)


def _bbox_lb2(qlo, qhi, tlo, thi) -> torch.Tensor:
    """Squared bbox-to-bbox distance lower bound: (nq_tiles, nt_tiles)."""
    gap = torch.clamp_min(
        torch.maximum(
            tlo[None, :, :] - qhi[:, None, :],
            qlo[:, None, :] - thi[None, :, :],
        ),
        0.0,
    )
    return torch.sum(gap * gap, dim=-1)
