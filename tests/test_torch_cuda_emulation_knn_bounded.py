"""K3p's bounded route (``csrc/knn.cu:knn_bounded_kernel``), run on the CPU
one thread per CUDA thread (``_cuda_emulation``): its candidates against the
unpruned fused kernel's (bit for bit) and the plain version's, on uniform and
clustered queries, ties and a far query, a column at the allowance's edge,
a query on the short run of a box that straddles a jump of the curve, and a
box list of one round, walked inside the loop.  Its ThreadSanitizer
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
    an arc of radius rho to its lower left; the next box, which the home
    walk takes too: 256 rows further from q, in one Morton cell between q's
    and c's; the other box: a column c at (s, ~s) from q to its upper
    right, the box's lower corner, and 255 rows beyond it.  At these
    coordinates the kernel's expanded distance rounds c's distance well
    under its exact value."""
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
    # the rows' grid (its cells ~1e-3 wide): the arc fills cells (0..3,
    # 0..3), q lies in cell (3, 3), c in (6, 6); the far half of cell (7, 0)
    # lies between them on the curve and beyond the arc's radius from q
    lo, scale, _ = K._morton_grid(torch.as_tensor(train))
    lo, width = lo.double().numpy(), 1.0 / scale.double().numpy()
    between = lo + width * (np.array([7.5, 0.0])
                            + 0.5 * rng.uniform(size=(256, 2)))
    train = np.concatenate([home, between, [c], beyond]).astype(np.float32)
    train = torch.as_tensor(train)
    train = train[K.spatial_sort(train)]
    return K.prepare_bounded(train, torch.as_tensor(q[None]), 64, bins=256)


def test_bounded_source_at_the_allowance_edge(lib):
    """The skip's allowance at its edge: the other box's exact bound lies
    over the block's tau while its column c's computed distance lies under
    it (and c's key under every key of the home walk's boxes), so only the
    allowance keeps the box walked; the candidates are the unpruned
    kernel's, c first."""
    prep = _edge_problem()
    q = prep.q[:1]
    d = torch.clamp_min((prep.qsq[0] + prep.tsq[:768])
                        - 2.0 * (q[:, 0:1] * prep.tT[0:1, :768]
                                 + q[:, 1:2] * prep.tT[1:2, :768])[0], 0.0)
    chunk = (torch.arange(768) // 256).int()
    keys = (d.view(torch.int32) & ~prep.chunk_mask) | chunk
    # the home box (the query's Morton code lies in box 0), the home walk
    # (boxes 0 and 1, its neighbour) and tau; c's box is 2, not a neighbour
    grid = (prep.boxes.grid[:2], prep.boxes.grid[2:], prep.boxes.bits)
    code = K._morton_codes(q, grid=grid)
    assert int(torch.searchsorted(prep.boxes.first, code, right=True)) - 1 == 0
    low = (1 << 20) - 1
    tau = float(((keys[:512].min() & ~low) | low).view(torch.float32))
    assert tau == float(((keys[:256].min() & ~low) | low).view(torch.float32))
    lo, hi = prep.boxes.box[:2, 2].double(), prep.boxes.box[2:, 2].double()
    q64 = q[0].double()
    gap = torch.clamp_min(torch.maximum(lo - q64, q64 - hi), 0)
    bound = float((gap * gap).sum())
    c = int(torch.argmin(d[512:768])) + 512
    assert bound > tau >= float(d[c]), (bound, tau, float(d[c]))
    assert int(keys[c]) < int(keys[:512].min())
    _check(lib, prep, 1)
    idx, _ = emu.k3_bounded(lib, prep, 1)
    assert int(idx[0, 0]) == c


def _straddle_problem():
    """762 rows in a corner square of side 0.05 and 2048 in the far square
    [0.55, 1]^2, Morton-sorted: box 2 holds the corner's last 250 rows and
    the far square's first 6, so it straddles the curve's jump.  The query
    is the far square's third row: its home is box 2, and the rows around
    it on the curve continue in box 3."""
    rng = np.random.default_rng(5)
    corner = 0.05 * rng.uniform(size=(762, 2))
    far = 0.55 + 0.45 * rng.uniform(size=(2048, 2))
    train = torch.as_tensor(np.concatenate([corner, far]).astype(np.float32))
    train = train[K.spatial_sort(train)]
    return K.prepare_bounded(train, train[764:765], 64, bins=256)


@pytest.mark.parametrize("k", [9, 38])
def test_bounded_source_walks_the_home_boxes_neighbours(lib, k):
    """A query on the short run of a box that straddles a jump of the curve
    (``_straddle_problem``): the home walk takes the boxes on either side of
    its home, so its tau comes from the rows around it and its block walks
    those 3 boxes of 16 (with its home box alone, its tau reaches the
    corner and it walked 15).  Bit-equal to the unpruned kernel."""
    prep = _straddle_problem()
    grid = (prep.boxes.grid[:2], prep.boxes.grid[2:], prep.boxes.bits)
    code = K._morton_codes(prep.q[:1], grid=grid)
    assert int(torch.searchsorted(prep.boxes.first, code, right=True)) - 1 == 2
    lo, hi = prep.boxes.box[:2, 2], prep.boxes.box[2:, 2]
    assert (lo < 0.05).all() and (hi > 0.55).all()
    total, scored = _check(lib, prep, k)
    assert (total, scored) == (16, 3)


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
