"""K3p's bounded route (``csrc/knn.cu:knn_bounded_kernel``), run on the CPU
one thread per CUDA thread (``_cuda_emulation``): its candidates against the
unpruned fused kernel's (bit for bit) and the plain version's, on uniform and
clustered queries, ties and a far query, a column at the allowance's edge,
and a box list of one round, walked inside the loop.  Its ThreadSanitizer
launches are ``"k3-fused-bounded"`` and ``"k3-fused-bounded-rounds"`` in
``_cuda_emulation.RACE_LAUNCHES``.  Skipped where ``g++`` lacks C++20
``<barrier>``."""

import ctypes

import numpy as np
import pytest
import torch

import _cuda_emulation as emu
from muygpys_torch.gpu import knn as K


@pytest.fixture(scope="module")
def lib():
    return ctypes.CDLL(emu.build("knn"))


def _unpruned(prep):
    """The unpruned search of the bounded route's padded, sorted queries."""
    train = prep.tT[:, :prep.train_count].T.contiguous()
    return K.prepare(train, prep.q, 64, query_tile=8,
                     train_tile=prep.train_tile, bins=prep.bins)


def _check(lib, prep, k):
    """One bounded launch against the unpruned fused kernel (idx and d2 bit
    for bit) and the plain version (d2 bit for bit; idx on every row whose
    k + 1 nearest keys are distinct, where torch.topk has no tie to order);
    returns (boxes of the index, boxes walked) of the launch."""
    prep.boxes.counts.zero_()
    idx, d2 = emu.k3_bounded(lib, prep, k)
    full = _unpruned(prep)
    ik, dk = emu.k3_select(lib, full, k)
    assert torch.equal(idx, ik) and torch.equal(d2, dk)
    ip, dp = K.knn_select_plain(full, k)
    assert torch.equal(d2, dp)
    _, dn = K.knn_select_plain(full, k + 1)
    distinct = (torch.diff(dn, dim=1) > 0).all(1)
    assert torch.equal(idx[distinct], ip[distinct])
    total, scored = prep.boxes.counts.tolist()
    assert total == prep.q.shape[0] // 8 * prep.boxes.norm.shape[0]
    return total, scored


@pytest.mark.parametrize("bins", [256, 512, 1024])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_bounded_source_matches_unpruned(lib, d, bins):
    """2300 uniform Morton-sorted rows (not a whole number of boxes: 9 real
    boxes of 256, the last with 4 padded columns, then 7 of padding), 16
    queries in a square of side 0.05 and 16 uniform ones (4 blocks), k in
    {1, 9, 38, 64}: bit-equal to the unpruned kernel, and every launch skips
    boxes."""
    prep = emu.k3_bounded_problem(2300, 16, 16, d, bins=bins, seed=d)
    assert prep.boxes.norm.shape[0] == 16 and prep.train_count % 256 == 252
    for k in (1, 9, 38, 64):
        total, scored = _check(lib, prep, k)
        assert 4 <= scored < total, (k, scored, total)


@pytest.mark.parametrize("bins", [256, 1024])
def test_bounded_source_on_ties_and_a_far_query(lib, bins):
    """Every row twice (ties between equal distances and equal keys) and a
    query at 5.0, far outside the unit square the rows fill: bit-equal to
    the unpruned kernel."""
    rng = np.random.default_rng(11)
    rows = rng.uniform(size=(1150, 2)).astype(np.float32)
    rows = np.concatenate([rows, rows[rng.permutation(1150)]])
    train = torch.as_tensor(rows)
    train = train[K.spatial_sort(train)]
    queries = np.concatenate([rows[:7], rng.uniform(size=(8, 2)),
                              [[5.0, 5.0]]]).astype(np.float32)
    prep = K.prepare_bounded(train, torch.as_tensor(queries), 64, bins=bins)
    for k in (9, 64):
        _check(lib, prep, k)


def _edge_problem():
    """One query q = (4, 4) (a block of 8 copies); its home box: 256 rows on
    an arc of radius rho to its lower left; the other box: a column c at (s,
    ~s) from q to its upper right, the box's lower corner, and 255 rows
    beyond it.  At these coordinates the kernel's expanded distance rounds
    c's distance well under its exact value."""
    rng = np.random.default_rng(1073)
    s = rng.uniform(2e-3, 4e-3)
    rho = np.sqrt(2) * s * rng.uniform(0.95, 1.02)
    rng = np.random.default_rng(73)
    q = np.array([4.0, 4.0], np.float32)
    arc = rng.uniform(np.pi * 1.05, np.pi * 1.45, size=256)
    home = q + rho * np.stack([np.cos(arc), np.sin(arc)], 1)
    c = q + np.array([s, s * rng.uniform(0.8, 1.2)])
    beyond = c + rng.uniform(0.01, 1.0, size=(255, 2))
    train = np.concatenate([home, [c], beyond]).astype(np.float32)
    train = torch.as_tensor(train)
    train = train[K.spatial_sort(train)]
    return K.prepare_bounded(train, torch.as_tensor(q[None]), 64, bins=256)


def test_bounded_source_at_the_allowance_edge(lib):
    """The skip's allowance at its edge: the other box's exact bound lies
    over the block's tau while its column c's computed distance lies under
    it (and c's key under every key of the home box), so only the allowance
    keeps the box walked; the candidates are the unpruned kernel's, c
    first."""
    prep = _edge_problem()
    q = prep.q[:1]
    d = torch.clamp_min((prep.qsq[0] + prep.tsq[:512])
                        - 2.0 * (q[:, 0:1] * prep.tT[0:1, :512]
                                 + q[:, 1:2] * prep.tT[1:2, :512])[0], 0.0)
    chunk = (torch.arange(512) // 256).int()
    keys = (d.view(torch.int32) & ~prep.chunk_mask) | chunk
    # the home box (the query's Morton code lies in box 0) and tau
    grid = (prep.boxes.grid[:2], prep.boxes.grid[2:], prep.boxes.bits)
    code = K._morton_codes(q, grid=grid)
    assert int(torch.searchsorted(prep.boxes.first, code, right=True)) - 1 == 0
    low = (1 << 20) - 1
    tau = float(((keys[:256].min() & ~low) | low).view(torch.float32))
    lo, hi = prep.boxes.box[:2, 1].double(), prep.boxes.box[2:, 1].double()
    q64 = q[0].double()
    gap = torch.clamp_min(torch.maximum(lo - q64, q64 - hi), 0)
    bound = float((gap * gap).sum())
    c = int(torch.argmin(d[256:512])) + 256
    assert bound > tau >= float(d[c]), (bound, tau, float(d[c]))
    assert int(keys[c]) < int(keys[:256].min())
    _check(lib, prep, 1)
    idx, _ = emu.k3_bounded(lib, prep, 1)
    assert int(idx[0, 0]) == c


@pytest.mark.parametrize("k", [9, 64])
def test_bounded_source_walks_its_list_inside_the_loop(lib, k):
    """A box list of one round (``knn_bounded_one_round``) over rows on a
    segment, 8 queries on it and 8 off it (``k3_segment_problem``): 137,216
    columns in 536 boxes, three rounds of 256; the block of off queries
    lists every box, so its list is walked inside the loop at each round
    and reset between them.  Bit-equal to the unpruned kernel and to the
    list of the keys' room (``knn_bounded``)."""
    prep = emu.k3_segment_problem(137_000, 8, 8)
    nb = prep.boxes.norm.shape[0]
    assert nb == 536
    total, scored = _check(lib, prep, k)
    idx, d2 = emu.k3_bounded(lib, prep, k)
    prep.boxes.counts.zero_()
    i1, d1 = emu.k3_bounded(lib, prep, k, entry="knn_bounded_one_round")
    assert torch.equal(i1, idx) and torch.equal(d1, d2)
    assert prep.boxes.counts.tolist() == [total, scored]
    # the off queries' block walked every box, the other block a few
    assert nb < scored < total
