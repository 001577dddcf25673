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
