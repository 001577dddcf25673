"""K3: the plain version of the packed-key candidate search and its glue
against the TPU kernels (muygpys_tpu.pallas.knn.knn_pallas and
knn_pallas_pruned, interpret mode) on the same numpy inputs, at the sizes of
tests/test_pallas_knn.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.pallas import knn as jknn
from muygpys_torch.gpu import _build
from muygpys_torch.gpu import knn as tknn

GEOM = dict(query_tile=128, train_tile=1024, bins=512)


@pytest.fixture(scope="module")
def problem(rng):
    train = rng.uniform(size=(5000, 3)).astype(np.float32)
    queries = rng.uniform(size=(257, 3)).astype(np.float32)
    return train, queries


def _same_sets(idx_a, idx_b):
    a, b = np.sort(np.asarray(idx_a), 1), np.sort(np.asarray(idx_b), 1)
    np.testing.assert_array_equal(a, b)


def _same_dists(d_a, d_b):
    np.testing.assert_allclose(
        np.sort(np.asarray(d_a), 1), np.sort(np.asarray(d_b), 1),
        rtol=0, atol=5e-5,
    )


@pytest.mark.parametrize("k", [40, 62])
def test_candidates_match_tpu_kernel(problem, k):
    train, queries = problem
    i0, d0 = jknn.knn_pallas(
        jnp.asarray(train), jnp.asarray(queries), k, interpret=True, **GEOM
    )
    _build.reset_launches()
    i1, d1 = tknn.knn_cuda(train, queries, k, device="cpu", **GEOM)
    assert sum(_build.launches.values()) == 0
    assert i1.shape == (257, k) and i1.dtype == torch.int64
    _same_sets(i1, i0)
    _same_dists(d1, d0)


@pytest.mark.parametrize("n_train,d", [(2048, 2), (5000, 3)])
def test_pruned_candidates_match_tpu_kernel(problem, n_train, d):
    train, queries = problem
    train, queries = train[:n_train, :d], queries[:, :d]
    perm = np.asarray(jknn.spatial_sort(jnp.asarray(train)))
    np.testing.assert_array_equal(
        tknn.spatial_sort(torch.as_tensor(train)).numpy(), perm
    )
    ts = train[perm]
    i0, d0 = jknn.knn_pallas_pruned(
        jnp.asarray(ts), jnp.asarray(queries), 40, interpret=True, **GEOM
    )
    i1, d1 = tknn.knn_cuda_pruned(ts, queries, 40, device="cpu", **GEOM)
    _same_sets(i1, i0)
    _same_dists(d1, d0)
    # pruning is conservative: the same candidates as the unpruned search
    i2, _ = tknn.knn_cuda(ts, queries, 40, device="cpu", **GEOM)
    _same_sets(i1, i2)


def test_pruning_skips_tiles(problem):
    train, queries = problem
    ts = train[np.asarray(jknn.spatial_sort(jnp.asarray(train[:, :2])))][:, :2]
    prep = tknn.prepare_pruned(
        torch.as_tensor(ts), torch.as_tensor(queries[:, :2]), 40, **GEOM
    )
    run = prep.lb <= prep.ub[:, None]
    assert prep.lb.shape == (3, 5) and 0 < int(run.sum()) < run.numel()
    # skipping never changes the merged candidates
    pruned = prep.candidates()
    full = prep._replace(lb=None, ub=None).candidates()
    _same_sets(
        tknn._merge_decode(*pruned, 40, prep)[0],
        tknn._merge_decode(*full, 40, prep)[0],
    )


def test_glue_matches_jax(problem):
    train, queries = problem
    pts = train[:1000, :2]
    np.testing.assert_array_equal(
        tknn._morton_codes(torch.as_tensor(pts)).numpy(),
        np.asarray(jknn._morton_codes(jnp.asarray(pts))),
    )
    lo_t, hi_t = tknn._tile_bboxes(torch.as_tensor(pts), 100)
    lo_j, hi_j = jknn._tile_bboxes(jnp.asarray(pts), 100)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    q_lo, q_hi = tknn._tile_bboxes(torch.as_tensor(queries[:256, :2]), 128)
    np.testing.assert_array_equal(
        tknn._bbox_lb2(q_lo, q_hi, lo_t, hi_t).numpy(),
        np.asarray(jknn._bbox_lb2(
            jnp.asarray(q_lo.numpy()), jnp.asarray(q_hi.numpy()), lo_j, hi_j
        )),
    )


def test_small_train_degenerate_regime(problem):
    """train < 2 * bins: unfillable slots come back with +inf distance and
    an in-range index, as in the JAX package."""
    train, queries = problem
    small = train[:700]
    i0, d0 = jknn.knn_pallas(
        jnp.asarray(small), jnp.asarray(queries[:50]), 20, interpret=True,
        **GEOM,
    )
    i1, d1 = tknn.knn_cuda(small, queries[:50], 20, device="cpu", **GEOM)
    _same_sets(i1, i0)
    assert int(i1.max()) < 700
    _, d_inf = tknn.knn_cuda(train[:300], queries[:8], 700, device="cpu", **GEOM)
    assert torch.isinf(d_inf).any()


def test_geometry_errors(problem):
    train, queries = problem
    with pytest.raises(ValueError, match="2\\*bins"):
        tknn.knn_cuda(train, queries, 1025, device="cpu", **GEOM)
    with pytest.raises(ValueError, match="must divide train_tile"):
        tknn.knn_cuda(
            train, queries, 10, device="cpu", query_tile=128,
            train_tile=1000, bins=512,
        )
    with pytest.raises(ValueError, match="chunk bits"):
        tknn.knn_cuda(
            np.zeros((40000, 2), np.float32), queries, 4, device="cpu",
            query_tile=128, train_tile=4, bins=2,
        )


def test_wrapper_device_rules(problem, monkeypatch):
    train, queries = problem
    prep = tknn.prepare(torch.as_tensor(train), torch.as_tensor(queries), 40, **GEOM)
    meta = prep._replace(q=torch.empty(prep.q.shape, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        meta.candidates()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tknn.knn_cuda(train, queries, 40)


@pytest.mark.parametrize(
    "feat,k,bins,want",
    [
        (2, 38, 512, "fused"),   # the server, with re-rank
        (2, 30, 256, "fused"),   # the server, without re-rank
        (2, 62, 1024, "fused"),  # NN_Wrapper
        (2, 63, 1024, "fused"),  # NN_Wrapper, batch neighbours
        (4, 64, 1024, "fused"),
        (1, 1, 256, "fused"),
        (5, 38, 512, "keys"),    # too many features
        (2, 65, 1024, "keys"),   # too many neighbours
        (2, 38, 128, "keys"),    # bins outside {256, 512, 1024}
        (2, 38, 2048, "keys"),
    ],
)
def test_knn_design_rule(feat, k, bins, want):
    assert tknn.knn_design(feat, k, bins) == want


def test_select_on_the_cpu_is_the_plain_merge(problem):
    """knn_select on CPU tensors is knn_select_plain: the keys mirror and
    the exact merge, in ascending distance order; no kernel launches."""
    train, queries = problem
    prep = tknn.prepare(torch.as_tensor(train), torch.as_tensor(queries), 40,
                        **GEOM)
    _build.reset_launches()
    idx, d2 = tknn.knn_select(prep, 40)
    assert sum(_build.launches.values()) == 0
    ip, dp = tknn.knn_select_plain(prep, 40)
    assert torch.equal(idx, ip) and torch.equal(d2, dp)
    assert idx.shape == (prep.q.shape[0], 40)
    assert bool((torch.diff(d2, dim=1) >= 0).all())


@pytest.mark.parametrize("pruned", [False, True])
def test_train_index_gives_the_per_request_candidates(problem, pruned):
    """A train index built once gives the candidates the per-request path
    computes, request after request."""
    train, queries = problem
    ts = train[np.asarray(jknn.spatial_sort(jnp.asarray(train)))]
    fn = tknn.knn_cuda_pruned if pruned else tknn.knn_cuda
    index = tknn.build_index(
        torch.as_tensor(ts), GEOM["train_tile"], GEOM["bins"], pruned=pruned
    )
    assert (index.sub is not None) == (index.boxes is not None) == pruned
    for part in (queries[:100], queries[100:]):
        i0, d0 = fn(ts, part, 40, device="cpu", **GEOM)
        i1, d1 = fn(None, part, 40, device="cpu", train_index=index, **GEOM)
        assert torch.equal(i0, i1) and torch.equal(d0, d1)


def test_shard_boxes_take_the_sort_grid():
    """A row shard of a Morton-sorted set (``FastServer(shard="train")``)
    indexed on the grid the whole set was sorted on: its boxes' first codes
    rise with the rows, as the bounded route's home search needs, and equal
    the whole set's codes of those rows; the shard's own grid is the
    default."""
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.uniform(size=(20_000, 2)).astype(np.float32))
    pts = pts[tknn.spatial_sort(pts)]
    grid = tknn._morton_grid(pts)
    codes = tknn._morton_codes(pts, grid=grid)
    for start in (0, 10_000):
        shard = pts[start:start + 10_000]
        index = tknn.build_index(shard, pruned=True, grid=grid)
        first = index.boxes.first
        assert bool((torch.diff(first) >= 0).all())
        real = first[: -(-10_000 // tknn.BOX)]
        assert torch.equal(real, codes[start:start + 10_000:tknn.BOX])
        own = tknn.build_index(shard, pruned=True).boxes
        assert torch.equal(own.grid, torch.cat(tknn._morton_grid(shard)[:2]))


@pytest.mark.parametrize(
    "device,count,feat,route",
    [("cuda", 8192, 2, "kernel"),   # the bulk and fast-mean buckets
     ("cuda", 256, 2, "kernel"),    # the small bucket
     ("cuda", 1, 1, "kernel"),
     ("cuda", 8191, 3, "kernel"),
     ("cuda", 4096, 4, "kernel"),
     ("cuda", 8193, 2, "torch"),    # past one block's shared memory
     ("cuda", 50_000, 2, "torch"),  # NN_Wrapper's batch searches
     ("cuda", 0, 2, "torch"),
     ("cuda", 256, 5, "torch"),
     ("cpu", 256, 2, "torch"),
     ("cpu", 8192, 2, "torch")],
)
def test_query_order_route_rule(device, count, feat, route):
    """The bounded route orders its queries by the kernel on a card at 1 to
    4 features and 1 to ORDER_CAP queries, else by plain PyTorch."""
    assert tknn.ORDER_CAP == 8192
    assert tknn.query_order_route(count, feat, device) == route
    assert tknn.query_order_route(count, feat, torch.device(device)) == route


@pytest.mark.parametrize("route", ["bounded", "table"])
def test_query_inverse_composes_to_the_identity(problem, route):
    """Both pruned searches carry the queries' permutation and its inverse:
    each composed with the other is the identity."""
    train, queries = problem
    ts = torch.as_tensor(train)[tknn.spatial_sort(torch.as_tensor(train))]
    q = torch.as_tensor(queries)
    prep = (tknn.prepare_bounded(ts, q, 40, GEOM["train_tile"], GEOM["bins"])
            if route == "bounded" else tknn.prepare_pruned(ts, q, 40, **GEOM))
    ident = torch.arange(len(queries))
    assert prep.qinv.dtype == prep.qperm.dtype == torch.int64
    assert torch.equal(prep.qperm[prep.qinv], ident)
    assert torch.equal(prep.qinv[prep.qperm], ident)


def test_query_order_on_the_cpu_is_the_plain_sort(problem):
    """knn_query_order on CPU tensors: the plain sort, padded to blocks of
    8, and argsort's inverse; no launch, and no order counted as left to
    PyTorch on a card."""
    _, queries = problem
    q = torch.as_tensor(queries)
    _build.reset_launches()
    q_pad, qperm, qinv = tknn.knn_query_order(q.double())
    assert sum(_build.launches.values()) == 0
    want_pad, want_perm = tknn._sorted_queries(q, 8)
    assert q_pad.dtype == torch.float32 and q_pad.shape == (264, 3)
    assert torch.equal(q_pad, want_pad) and torch.equal(qperm, want_perm)
    assert torch.equal(qinv, torch.argsort(want_perm))


def test_pruned_search_on_the_cpu_is_unchanged(problem):
    """knn_cuda_pruned on the CPU: the skip table's candidates of the sorted
    queries, mapped back by the argsort of the permutation, as before the
    queries' inverse rode in the prepared search; no launch counted."""
    train, queries = problem
    ts = torch.as_tensor(train)[tknn.spatial_sort(torch.as_tensor(train))]
    _build.reset_launches()
    idx, d2 = tknn.knn_cuda_pruned(ts, queries, 40, device="cpu", **GEOM)
    assert sum(_build.launches.values()) == 0
    prep = tknn.prepare_pruned(ts, torch.as_tensor(queries), 40, **GEOM)
    i0, d0 = tknn.knn_select(prep, 40)
    back = torch.argsort(prep.qperm)
    assert torch.equal(idx, i0[: len(queries)][back])
    assert torch.equal(d2, d0[: len(queries)][back])


def test_train_index_refuses_another_geometry(problem):
    train, queries = problem
    index = tknn.build_index(torch.as_tensor(train), 1024, 512)
    with pytest.raises(ValueError, match="train_index was built"):
        tknn.knn_cuda(None, queries, 40, device="cpu", train_index=index,
                      query_tile=128, train_tile=1024, bins=256)
    with pytest.raises(ValueError, match="train_index was built"):
        tknn.knn_cuda_pruned(None, queries, 40, device="cpu",
                             train_index=index, **GEOM)


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(tknn, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(tknn, name, spy)
    return calls


@pytest.mark.parametrize("spatial_sort", [True, False])
def test_server_builds_its_train_index_once(problem, monkeypatch,
                                            spatial_sort):
    """FastServer(engine="fused") builds the search's train side (norms,
    tile boxes, the subsample's own) when it is built, never per request,
    and every request's candidates are those of the per-request path."""
    from muygpys_torch import serve as tserve
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    train, queries = problem
    train, queries = train[:2048, :2].astype(np.float64), queries[:, :2]
    targets = np.sin(6 * train[:, :1])
    model = muygps_from_arrays(length_scale=0.3, noise=1e-3, smoothness=1.5)
    nbrs = NN_Wrapper(train, 10, device="cpu")
    built = []
    real_build = tserve.build_index
    monkeypatch.setattr(
        tserve, "build_index",
        lambda *a, **kw: built.append(1) or real_build(*a, **kw),
    )
    name = "knn_cuda_pruned" if spatial_sort else "knn_cuda"
    searches = []
    real_search = getattr(tserve, name)

    def search(*args, **kwargs):
        out = real_search(*args, **kwargs)
        searches.append((args, kwargs, out))
        return out

    monkeypatch.setattr(tserve, name, search)
    norms = _count_calls(monkeypatch, "_norms")
    server = FastServer(model, nbrs, train, targets, bucket=64,
                        engine="fused", spatial_sort=spatial_sort,
                        device="cpu")
    assert len(built) == 1
    at_build = len(norms)
    assert at_build == (2 if spatial_sort else 1)
    server.predict(queries[:150])  # three buckets
    assert len(built) == 1 and len(norms) == at_build
    assert len(searches) == 3
    train_t = torch.as_tensor(train)
    if spatial_sort:
        train_t = train_t[tknn.spatial_sort(train_t)]
    for args, kwargs, (idx, d2) in searches:
        assert args[0] is None and kwargs["train_index"] is not None
        kwargs = dict(kwargs, train_index=None)
        i0, d0 = real_search(train_t, *args[1:], **kwargs)
        assert torch.equal(idx, i0) and torch.equal(d2, d0)


def test_nn_wrapper_builds_its_train_index_once(problem, monkeypatch):
    """NN_Wrapper(nn_method="kernel") builds the train side once per index
    and returns the neighbours the exact method does."""
    from muygpys_torch.neighbors import NN_Wrapper

    train, queries = problem
    built = _count_calls(monkeypatch, "build_index")
    norms = _count_calls(monkeypatch, "_norms")
    nbrs = NN_Wrapper(train[:, :2], 10, nn_method="kernel", device="cpu")
    at_build = (len(built), len(norms))
    assert at_build == (2, 2)  # the pruned index and its subsample's
    i1, d1 = nbrs.get_nns(queries[:, :2])
    i2, _ = nbrs.get_batch_nns(np.arange(0, 5000, 101))
    assert (len(built), len(norms)) == at_build
    exact = NN_Wrapper(train[:, :2], 10, device="cpu")
    np.testing.assert_array_equal(i1, exact.get_nns(queries[:, :2])[0])
    np.testing.assert_array_equal(
        i2, exact.get_batch_nns(np.arange(0, 5000, 101))[0])


# the exact kernel's plain mirror and NN_Wrapper's route to it

def _uniform(n, q, d, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(size=(n, d)).astype(np.float32)),
            torch.as_tensor(rng.uniform(size=(q, d)).astype(np.float32)))


def _tiled_exact(train, queries, k):
    """The tiled route of NN_Wrapper's exact search: candidates through the
    Gram identity, then the re-rank by direct differences."""
    from muygpys_torch.neighbors import _brute_force_knn, _refine_knn

    cand, _ = _brute_force_knn(train, queries, min(k + 32, train.shape[0]))
    return _refine_knn(train, queries, cand, k)


@pytest.mark.parametrize("k", [1, 30, 31, 64])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_knn_exact_plain_matches_the_tiled_search(d, k):
    """On uniform rows (2125: a ragged last tile of 77 at 256 rows a tile)
    the plain mirror of the exact kernel gives _brute_force_knn ->
    _refine_knn's neighbours in the same order and their distances bit for
    bit."""
    from muygpys_torch.gpu import knn_exact as X

    train, queries = _uniform(2125, 150, d, seed=10 * d + k)
    index = X.build_exact_index(train)
    assert X.tile_count(index) == 9 and index.tile == 256
    idx, d2 = X.knn_exact_select(index, queries, k)
    ir, dr = _tiled_exact(train, queries, k)
    assert idx.dtype == torch.int64 and d2.dtype == torch.float32
    assert torch.equal(idx, ir) and torch.equal(d2, dr)


def _ties(case):
    rng = np.random.default_rng(3)
    if case == "duplicated":
        rows = rng.uniform(size=(1100, 2)).astype(np.float32)
        train = np.concatenate([rows, rows[rng.permutation(1100)]])
    else:  # a 48 x 48 grid
        g = np.arange(48, dtype=np.float32) / 47
        train = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    queries = np.concatenate([train[:40], rng.uniform(size=(40, 2))])
    return (torch.as_tensor(train),
            torch.as_tensor(queries.astype(np.float32)))


@pytest.mark.parametrize("case", ["duplicated", "grid"])
def test_knn_exact_plain_agrees_up_to_ties(case):
    """Where many rows lie at equal distances the sets agree with the tiled
    search's up to ties: the sorted distances are the same bits, each row
    only one of them returns lies at the k-th distance, and at every row
    both return the distances are the same bits."""
    from muygpys_torch.gpu import knn_exact as X

    train, queries = _ties(case)
    k = 31  # odd: the k-th row's twin is left out
    idx, d2 = X.knn_exact_select(X.build_exact_index(train), queries, k)
    ir, dr = _tiled_exact(train, queries, k)
    assert torch.equal(d2, dr)
    differ = 0
    for qi in range(len(queries)):
        mine = dict(zip(idx[qi].tolist(), d2[qi].tolist()))
        theirs = dict(zip(ir[qi].tolist(), dr[qi].tolist()))
        assert len(mine) == k
        for row in mine.keys() & theirs.keys():
            assert mine[row] == theirs[row]
        for row in mine.keys() ^ theirs.keys():
            differ += 1
            assert mine.get(row, theirs.get(row)) == float(d2[qi, -1])
    assert differ > 0, "no tie was tested"


def _refusals():
    from muygpys_torch.gpu import knn_exact as X

    train, queries = _uniform(2100, 8, 2, seed=1)
    index = X.build_exact_index(train)
    wide = index._replace(tT=torch.zeros((5, 2100)))
    return {
        "k65": (index, queries, 65, "1 to 64 neighbours"),
        "d5": (wide, torch.zeros((8, 5)), 30, "1 to 4 features"),
        "features": (index, queries[:, :1].contiguous(), 30, "do not match"),
        "float64": (index, queries.double(), 30, "float32"),
        "strided": (index, queries.T.contiguous().T, 30, "contiguous"),
        "device": (index, torch.empty((8, 2), device="meta"), 30,
                   "the index on cpu"),
    }


@pytest.mark.parametrize(
    "case", ["k65", "d5", "features", "float64", "strided", "device"])
def test_knn_exact_refuses_what_the_kernel_does_not_take(case):
    from muygpys_torch.gpu import knn_exact as X

    index, queries, k, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        X.knn_exact_select(index, queries, k)


def test_knn_exact_index_refuses_five_features():
    from muygpys_torch.gpu import knn_exact as X

    with pytest.raises(ValueError, match="1 to 4 features"):
        X.build_exact_index(torch.zeros((3000, 5)))


@pytest.mark.parametrize("d", [2, 5])
def test_nn_wrapper_on_the_cpu_takes_the_tiled_search(monkeypatch, d):
    """On the CPU, at d <= 4 as at d = 5, NN_Wrapper's exact search is
    _brute_force_knn -> _refine_knn, and its index has no exact kernel's
    side."""
    from muygpys_torch import neighbors
    from muygpys_torch.gpu import knn_exact as X

    calls = []
    for module, name in ((neighbors, "_brute_force_knn"),
                         (X, "knn_exact_select")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    train, queries = _uniform(3000, 20, d, seed=d)
    nbrs = neighbors.NN_Wrapper(train.numpy(), 10, device="cpu")
    assert nbrs._exact is None and nbrs._tiles is not None
    nbrs.get_nns(queries.numpy())
    nbrs.get_batch_nns(np.arange(5))
    assert calls == ["_brute_force_knn"] * 2
    assert nbrs.stats == {"searches": 2, "queries": 25, "tiles_total": 0,
                          "tiles_scored": 0}


@pytest.mark.parametrize(
    "device,d,n,dtype,route",
    [("cuda", 2, 10**6, torch.float32, True),
     ("cuda", 4, 2048, torch.float32, True),
     ("cuda", 1, 2048, torch.float32, True),
     ("cpu", 2, 10**6, torch.float32, False),
     ("cuda", 5, 10**6, torch.float32, False),
     ("cuda", 2, 2047, torch.float32, False),
     ("cuda", 2, 10**6, torch.float64, False)],
)
def test_exact_kernel_route_rule(device, d, n, dtype, route):
    """The exact kernel takes an index on a card at d <= 4, n >= 2048 and
    float32 rows; everything else keeps the tiled search."""
    from types import SimpleNamespace

    from muygpys_torch.gpu import knn_exact as X

    train = SimpleNamespace(device=torch.device(device), shape=(n, d),
                            dtype=dtype)
    assert X.takes(train) == route


def test_nn_wrapper_exact_route_glue():
    """The exact route's glue, driven on the CPU through the plain mirror
    (an exact index put in place of the tiled one): the neighbours of the
    tiled search, the tiles counted; a request of more than 64 neighbours
    goes the tiled way, its train tiles built once."""
    from muygpys_torch.gpu import knn_exact as X
    from muygpys_torch.neighbors import NN_Wrapper

    train, queries = _uniform(3000, 40, 2, seed=5)
    tiled = NN_Wrapper(train.numpy(), 30, device="cpu")
    nbrs = NN_Wrapper(train.numpy(), 30, device="cpu")
    nbrs._exact, nbrs._tiles = X.build_exact_index(nbrs._train_dev), None
    nt = X.tile_count(nbrs._exact)
    for got, want in ((nbrs.get_nns(queries.numpy()),
                       tiled.get_nns(queries.numpy())),
                      (nbrs.get_batch_nns(np.arange(0, 3000, 97)),
                       tiled.get_batch_nns(np.arange(0, 3000, 97)))):
        assert got[0].dtype == want[0].dtype == np.int64
        assert got[1].dtype == want[1].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    searched = 40 + len(range(0, 3000, 97))
    assert nbrs.stats == {"searches": 2, "queries": searched,
                          "tiles_total": searched * nt,
                          "tiles_scored": searched * nt}
    nbrs.nn_count = 64  # get_batch_nns asks for 65
    idx, _ = nbrs.get_batch_nns(np.arange(3))
    tiled.nn_count = 64
    np.testing.assert_array_equal(idx, tiled.get_batch_nns(np.arange(3))[0])
    assert nbrs.stats["tiles_total"] == searched * nt
    # the tiled search's train side is built at the first such request, once
    tiles = nbrs._tiles
    assert tiles is not None
    nbrs.get_batch_nns(np.arange(3, 6))
    assert nbrs._tiles is tiles
