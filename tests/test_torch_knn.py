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
    assert (index.sub is not None) == pruned
    for part in (queries[:100], queries[100:]):
        i0, d0 = fn(ts, part, 40, device="cpu", **GEOM)
        i1, d1 = fn(None, part, 40, device="cpu", train_index=index, **GEOM)
        assert torch.equal(i0, i1) and torch.equal(d0, d1)


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
