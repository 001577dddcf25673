"""muygpys_torch.neighbors.NN_Wrapper against muygpys_tpu.neighbors (f64)."""

import numpy as np
import pytest
import torch

from muygpys_tpu.neighbors import NN_Wrapper as JaxNN
from muygpys_torch.neighbors import NN_Wrapper


@pytest.fixture(scope="module")
def data(rng):
    train = rng.uniform(size=(3000, 2))
    test = rng.uniform(size=(200, 2))
    return train, test


def test_exact_matches_jax(data):
    train, test = data
    i_t, d_t = NN_Wrapper(train, 15, device="cpu").get_nns(test)
    i_j, d_j = JaxNN(train, 15).get_nns(test)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-12, atol=1e-15)
    assert i_t.shape == (200, 15) and np.all(np.diff(d_t, axis=1) >= 0)


def test_batch_nns_drop_self(data):
    train, _ = data
    batch = np.arange(0, 3000, 97)
    i_t, d_t = NN_Wrapper(train, 10, device="cpu").get_batch_nns(batch)
    i_j, d_j = JaxNN(train, 10).get_batch_nns(batch)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    assert not np.any(i_t == batch[:, None])


@pytest.mark.parametrize("spatial_sort", [None, False])
def test_kernel_method_is_exact_after_rerank(data, spatial_sort):
    """The candidate kernel (pruned or not) + exact re-rank returns the
    exact neighbors, as the JAX package's "pallas" method does."""
    train, test = data
    nb = NN_Wrapper(
        train, 15, nn_method="kernel", device="cpu", spatial_sort=spatial_sort
    )
    assert nb._spatial == (spatial_sort is None)
    i_k, d_k = nb.get_nns(test)
    i_e, d_e = JaxNN(train, 15).get_nns(test)
    np.testing.assert_array_equal(np.sort(i_k, 1), np.sort(np.asarray(i_e), 1))
    np.testing.assert_allclose(d_k, np.asarray(d_e), rtol=1e-12, atol=1e-15)


def test_one_dimensional_and_small(data):
    train, test = data
    i_t, _ = NN_Wrapper(train[:500, 0], 5, nn_method="kernel",
                        device="cpu").get_nns(test[:, 0])
    i_j, _ = JaxNN(train[:500, 0], 5).get_nns(test[:, 0])
    np.testing.assert_array_equal(i_t, np.asarray(i_j))


def test_unported_methods_and_device(data, monkeypatch):
    """An unknown method raises NotImplementedError naming it, as in JAX;
    without a card every method refuses to start unless the caller asks for
    the CPU."""
    train, _ = data
    with pytest.raises(NotImplementedError, match="kdtree-foo"):
        NN_Wrapper(train, 5, nn_method="kdtree-foo", device="cpu")
    with pytest.raises(NotImplementedError):
        JaxNN(train, 5, nn_method="kdtree-foo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method in ("exact", "brute", "kernel", "sklearn", "hnsw"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NN_Wrapper(train, 5, nn_method=method)


def test_sklearn_matches_jax(data):
    """scikit-learn's exact index through both wrappers, index for index,
    squared distances; only JAX's keyword set reaches it."""
    train, test = data
    i_t, d_t = NN_Wrapper(train, 15, nn_method="sklearn", device="cpu",
                          leaf_size=20, spatial_sort=True).get_nns(test)
    i_j, d_j = JaxNN(train, 15, nn_method="sklearn",
                     leaf_size=20).get_nns(test)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)
    i_e, d_e = NN_Wrapper(train, 15, device="cpu").get_nns(test)
    np.testing.assert_array_equal(i_t, i_e)
    np.testing.assert_allclose(d_t, d_e, rtol=1e-10, atol=1e-14)
    b_t, _ = NN_Wrapper(train, 10, nn_method="sklearn",
                        device="cpu").get_batch_nns(np.arange(40))
    b_j, _ = JaxNN(train, 10, nn_method="sklearn").get_batch_nns(
        np.arange(40)
    )
    np.testing.assert_array_equal(b_t, b_j)


def test_sklearn_missing_names_it(data, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.split(".")[0] == "sklearn":
            raise ImportError("No module named 'sklearn'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    with pytest.raises(ImportError, match="scikit-learn"):
        NN_Wrapper(data[0], 5, nn_method="sklearn", device="cpu")


def test_brute_is_exact(data):
    train, test = data
    nb = NN_Wrapper(train, 12, nn_method="BRUTE", device="cpu")
    assert nb.nn_method == "brute"
    i_b, d_b = nb.get_nns(test)
    i_e, d_e = NN_Wrapper(train, 12, device="cpu").get_nns(test)
    np.testing.assert_array_equal(i_b, i_e)
    np.testing.assert_array_equal(d_b, d_e)


@pytest.fixture(scope="module")
def scan_data(rng):
    return rng.normal(size=(3000, 6)), rng.normal(size=(137, 6))


def test_scan_equals_one_block_and_jax_after_rerank(scan_data):
    """JAX's own scan test shape (query tiles of 64, train tiles of 512):
    the scan's candidates (exact top-k per tile) re-rank to the one-block
    search's sets and to JAX's exact path; the scan's own distances equal
    the one block's."""
    import jax.numpy as jnp

    from muygpys_torch.neighbors import (
        _brute_force_knn,
        _refine_knn,
        _train_tiles,
    )
    from muygpys_tpu.neighbors import _brute_force_knn_scan as jax_scan
    from muygpys_tpu.neighbors import _refine_knn as jax_refine

    train, queries = scan_data
    t, q = torch.as_tensor(train), torch.as_tensor(queries)
    assert _train_tiles(t, 512)[2] == 504  # six tiles, none padded
    bi, bd = _brute_force_knn(t, q, 9 + 32, train_tile=len(train))
    si, sd = _brute_force_knn(t, q, 9 + 32, query_tile=64, train_tile=512)
    assert si.shape == (137, 41) and si.dtype == torch.int64
    np.testing.assert_allclose(sd.numpy(), bd.numpy(), rtol=1e-12,
                               atol=1e-12)
    ri, rd = _refine_knn(t, q, si, 9)
    oi, od = _refine_knn(t, q, bi, 9)
    np.testing.assert_array_equal(ri.numpy(), oi.numpy())
    np.testing.assert_array_equal(rd.numpy(), od.numpy())
    jt, jq = jnp.asarray(train), jnp.asarray(queries)
    ji, _ = jax_scan(jt, jq, 9 + 32, query_tile=64, train_tile=512)
    ki, kd = jax_refine(jt, jq, ji, 9)
    np.testing.assert_array_equal(ri.numpy(), np.asarray(ki))
    np.testing.assert_allclose(rd.numpy(), np.asarray(kd), rtol=1e-12,
                               atol=1e-14)


def test_scan_pads_a_partial_tile(scan_data):
    """530 rows in tiles of at most 512: two tiles of 272, the last padded
    with 14 rows whose +inf norms keep them out of every set."""
    from muygpys_torch.neighbors import _brute_force_knn, _train_tiles

    train, queries = scan_data
    t, q = torch.as_tensor(train[:530]), torch.as_tensor(queries[:20])
    rows, norms, tile = _train_tiles(t, 512)
    assert tile == 272 and rows.shape == (544, 6)
    assert torch.isinf(norms[530:]).all() and torch.isfinite(norms[:530]).all()
    si, sd = _brute_force_knn(t, q, 30, query_tile=8, train_tile=512)
    bi, bd = _brute_force_knn(t, q, 30, train_tile=len(t))
    assert int(si.max()) < 530
    np.testing.assert_array_equal(np.sort(si.numpy(), 1),
                                  np.sort(bi.numpy(), 1))
    np.testing.assert_allclose(sd.numpy(), bd.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_exact_scans_past_one_train_tile(monkeypatch, rng):
    """NN_Wrapper("exact") over more than 16,384 rows scans two train
    tiles, built once with the index and reused by every call, and gives
    JAX's sets."""
    import muygpys_torch.neighbors as port_neighbors

    train = rng.uniform(size=(16385 + 300, 2))
    test = rng.uniform(size=(50, 2))
    calls = []
    real = port_neighbors._brute_force_knn

    def spy(*args, **kwargs):
        rows, _, tile = kwargs["tiles"]
        calls.append((id(kwargs["tiles"]), rows.shape[0], tile))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_neighbors, "_brute_force_knn", spy)
    nbrs = NN_Wrapper(train, 10, device="cpu")
    i_t, d_t = nbrs.get_nns(test)
    nbrs.get_nns(test[:5])
    assert calls[0] == calls[1] == (id(nbrs._tiles), 2 * 8344, 8344)
    i_j, d_j = JaxNN(train, 10).get_nns(test)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-12, atol=1e-15)


def test_pallas_is_the_kernel_method(data):
    """JAX's ``nn_method="pallas"`` builds the port's K3 index: the same
    neighbors as ``"kernel"``, and JAX's exact sets."""
    train, test = data
    nb = NN_Wrapper(train, 15, nn_method="pallas", device="cpu")
    assert nb.nn_method == "kernel" and nb._knn_index is not None
    i_p, d_p = nb.get_nns(test)
    i_k, d_k = NN_Wrapper(train, 15, nn_method="kernel",
                          device="cpu").get_nns(test)
    np.testing.assert_array_equal(i_p, i_k)
    np.testing.assert_array_equal(d_p, d_k)
    i_j, _ = JaxNN(train, 15).get_nns(test)
    np.testing.assert_array_equal(np.sort(i_p, 1), np.sort(np.asarray(i_j), 1))
