"""K3: packed-key KNN candidate selection, CUDA kernel plus PyTorch glue.

Counterpart of :mod:`muygpys_tpu.pallas.knn`.  The distance field never
leaves the kernel: per query and residue bin ``col % bins`` it keeps the two
smallest *packed keys* (f32 squared distance with its low ``chunk_bits``
mantissa bits replaced by the column's chunk ``col // bins``), so the
candidate's train index decodes algebraically from (merge position, key low
bits).  The kernel (``csrc/knn.cu``) and its plain mirror
:func:`knn_candidates_plain` produce the same ``s1``/``s2`` bits.

The glue around it is plain PyTorch, as it was plain XLA in the JAX
package: padding, the train norms, the merge of the ``2 * bins`` surviving
keys (an exact ``torch.topk``; JAX's ``approx_min_k`` is exact on the CPU,
so CPU results match the JAX package), Morton sorting and the
bounding-box pruning bounds.

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


def knn_candidates_plain(
    q, qsq, tT, tsq, bins, train_tile, query_tile, chunk_mask,
    lb=None, ub=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K3 kernel: the same operations in the
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


def knn_candidates(
    q, qsq, tT, tsq, bins, train_tile, query_tile, chunk_mask,
    lb=None, ub=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 kernel wrapper: two smallest packed keys per (query, bin).

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
    if q.device.type != "cuda":
        raise ValueError(f"knn_candidates runs on cpu or cuda, not {q.device}")
    q_count, feat = q.shape
    t_count = tT.shape[1]
    tensors = {"q": q, "qsq": qsq, "tT": tT, "tsq": tsq}
    if pruned:
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
        or q_count % query_tile or query_tile % 8
        or t_count % train_tile or train_tile % bins
        or (bins > 256 and bins % 256)
    ):
        raise ValueError(
            f"knn_candidates geometry: q {tuple(q.shape)}, tT "
            f"{tuple(tT.shape)}, bins {bins}, train_tile {train_tile}, "
            f"query_tile {query_tile}"
        )
    if pruned and (lb.shape != (nq, nt) or ub.shape != (nq,)):
        raise ValueError(
            f"skip table lb {tuple(lb.shape)} / ub {tuple(ub.shape)} does "
            f"not match ({nq}, {nt})"
        )
    s1 = torch.empty((q_count, bins), dtype=torch.int32, device=q.device)
    s2 = torch.empty_like(s1)
    fn = _build.function("knn", "knn_candidates", _ARGTYPES)
    rc = fn(
        _build.ptr(q), _build.ptr(qsq), _build.ptr(tT), _build.ptr(tsq),
        _build.ptr(lb), _build.ptr(ub), _build.ptr(s1), _build.ptr(s2),
        q_count, feat, t_count, bins, train_tile, query_tile, chunk_mask,
        _build.stream(q.device),
    )
    _build.check(rc, "knn", "knn_candidates")
    _build.count("knn_candidates_pruned" if pruned else "knn_candidates")
    return s1, s2


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

    def candidates(self):
        return knn_candidates(
            self.q, self.qsq, self.tT, self.tsq, self.bins,
            self.train_tile, self.query_tile, self.chunk_mask,
            self.lb, self.ub,
        )


def _chunk_mask(train_count, nn_count, train_tile, bins) -> Tuple[int, int]:
    """(padded train count, chunk mask) of the packed-key geometry."""
    if train_tile % bins != 0:
        raise ValueError(f"bins {bins} must divide train_tile {train_tile}")
    if nn_count > 2 * bins:
        # the state holds exactly two candidates per residue bin
        raise ValueError(
            f"nn_count {nn_count} exceeds the 2*bins={2 * bins} candidates "
            "the kernel retains; raise bins or use an exact engine"
        )
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


def prepare(
    train, queries, nn_count, query_tile=128, train_tile=2048, bins=512
) -> Prepared:
    """Inputs of the unpruned search (:func:`knn_cuda`)."""
    train = train.to(torch.float32)
    queries = queries.to(torch.float32)
    train_count, query_count = train.shape[0], queries.shape[0]
    t_padded, mask = _chunk_mask(train_count, nn_count, train_tile, bins)
    train_pad = torch.nn.functional.pad(train, (0, 0, 0, t_padded - train_count))
    q_padded = math.ceil(query_count / query_tile) * query_tile
    q_pad = torch.nn.functional.pad(queries, (0, 0, 0, q_padded - query_count))
    return Prepared(
        q_pad.contiguous(), torch.sum(q_pad * q_pad, dim=-1),
        train_pad.T.contiguous(), _norms(train_pad, train_count),
        None, None, bins, train_tile, query_tile, mask,
        train_count, query_count, None,
    )


def prepare_pruned(
    train, queries, nn_count, query_tile=128, train_tile=2048, bins=512,
    subsample=16,
) -> Prepared:
    """Inputs of the pruned search (:func:`knn_cuda_pruned`), including the
    skip table; runs the unpruned kernel on a ``1/subsample`` row subset for
    the upper bound, as ``muygpys_tpu.pallas.knn.knn_pallas_pruned`` does."""
    train = train.to(torch.float32)
    queries = queries.to(torch.float32)
    train_count, query_count = train.shape[0], queries.shape[0]
    t_padded, mask = _chunk_mask(train_count, nn_count, train_tile, bins)
    # edge-pad (not zero-pad): padded rows must not widen the last tile's
    # bounding box; the 1e30 sentinel norm still excludes them as columns
    train_pad = _edge_pad(train, t_padded)

    # sort queries along the same curve so query tiles are compact too
    qperm = spatial_sort(queries)
    nq = math.ceil(query_count / query_tile)
    q_pad = _edge_pad(queries[qperm], nq * query_tile)

    # per-query upper bound on the k-th neighbor distance: max candidate
    # distance on a row subsample (k-th NN of a subset >= k-th NN of the
    # set), inflated past the packed-key mantissa truncation
    sub = prepare(
        train[::subsample], q_pad, nn_count, query_tile, train_tile, bins
    )
    _, d2_sub = _merge_decode(*sub.candidates(), nn_count, sub)
    d2_sub = torch.where(
        torch.isfinite(d2_sub), d2_sub, torch.full_like(d2_sub, 1e30)
    )
    ub_row = torch.amax(d2_sub, dim=1) * (1.0 + 2.0**-14)
    ub = torch.amax(ub_row.reshape(nq, query_tile), dim=1)

    qlo, qhi = _tile_bboxes(q_pad, query_tile)
    tlo, thi = _tile_bboxes(train_pad, train_tile)
    lb = _bbox_lb2(qlo, qhi, tlo, thi)  # (nq, nt)
    return Prepared(
        q_pad.contiguous(), torch.sum(q_pad * q_pad, dim=-1),
        train_pad.T.contiguous(), _norms(train_pad, train_count),
        lb.contiguous(), ub.contiguous(), bins, train_tile, query_tile, mask,
        train_count, query_count, qperm,
    )


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
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate KNN ``(indices, sq_dists)`` of shape ``(Q, nn_count)``
    through the K3 kernel; counterpart of ``knn_pallas``.

    Candidates, not guaranteed-exact neighbors: distances carry the
    packed-key truncation (<= 2^(chunk_bits-23) relative).  Callers
    over-fetch and re-rank exactly.  ``nn_count > 2 * bins`` raises.
    """
    dev = config.device(device)
    prep = prepare(
        torch.as_tensor(train, device=dev), torch.as_tensor(queries, device=dev),
        nn_count, query_tile, train_tile, bins,
    )
    idx, d2 = _merge_decode(*prep.candidates(), nn_count, prep)
    return idx[: prep.query_count], d2[: prep.query_count]


def knn_cuda_pruned(
    train, queries, nn_count, query_tile=128, train_tile=2048, bins=512,
    subsample=16, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatially pruned candidate KNN; counterpart of ``knn_pallas_pruned``.

    ``train`` must be Morton-sorted (:func:`spatial_sort`) for tight tile
    bounding boxes; queries are sorted internally and results mapped back.
    A (query tile, train tile) block is skipped only when its bounding-box
    lower bound exceeds the query tile's k-th-neighbor upper bound, so the
    candidates equal the unpruned kernel's.
    """
    dev = config.device(device)
    prep = prepare_pruned(
        torch.as_tensor(train, device=dev), torch.as_tensor(queries, device=dev),
        nn_count, query_tile, train_tile, bins, subsample,
    )
    idx, d2 = _merge_decode(*prep.candidates(), nn_count, prep)
    qinv = torch.argsort(prep.qperm)
    return idx[: prep.query_count][qinv], d2[: prep.query_count][qinv]


def _morton_codes(pts: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Morton (Z-order) codes: per-dimension quantization + bit interleave,
    capped to fit 30 bits."""
    pts = pts.to(torch.float32)
    d = pts.shape[1]
    bits = min(bits, 30 // d)
    lo = torch.amin(pts, dim=0)
    hi = torch.amax(pts, dim=0)
    # tensor / tensor: PyTorch computes scalar / tensor as a reciprocal
    # times the scalar, one rounding more than the JAX package's divide
    top = torch.full_like(hi, 2.0**bits - 1.0)
    scale = top / torch.clamp_min(hi - lo, 1e-30)
    q = torch.clamp((pts - lo) * scale, 0.0, 2.0**bits - 1.0).to(torch.int32)
    code = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    for b in range(bits):
        for dim in range(d):
            code = code | (((q[:, dim] >> b) & 1) << (b * d + dim))
    return code


def spatial_sort(pts: torch.Tensor) -> torch.Tensor:
    """Permutation ordering points along a Morton curve (stable, as
    ``jnp.argsort``)."""
    return torch.argsort(_morton_codes(pts), stable=True)


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
