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
    train, _ = data
    for method in ("sklearn", "hnsw"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            NN_Wrapper(train, 5, nn_method=method, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NN_Wrapper(train, 5)
