"""muygpys_torch.optimize.batch against muygpys_tpu.optimize.batch: the
same numpy generator draws the same batch, with the same neighbors."""

import numpy as np
import pytest

from muygpys_tpu.neighbors import NN_Wrapper as JaxNN
from muygpys_tpu.optimize import batch as jb
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.optimize import batch as tb


@pytest.fixture(scope="module")
def data(rng):
    x = rng.uniform(size=(600, 2))
    labels = (x[:, 0] > 0.5).astype(int) + (x[:, 1] > 0.7).astype(int)
    return x, labels, NN_Wrapper(x, 8, device="cpu"), JaxNN(x, 8)


@pytest.mark.parametrize("batch_count", [128, 600, 1000])
def test_sample_batch_matches_jax(data, batch_count):
    x, _, nbrs, jnbrs = data
    bi, bnn = tb.sample_batch(nbrs, batch_count, len(x),
                              rng=np.random.default_rng(4))
    jbi, jbnn = jb.sample_batch(jnbrs, batch_count, len(x),
                                rng=np.random.default_rng(4))
    np.testing.assert_array_equal(bi, jbi)
    np.testing.assert_array_equal(bnn, np.asarray(jbnn))
    assert bnn.shape == (min(batch_count, len(x)), 8)


def test_filtered_and_balanced_batches_match_jax(data):
    x, labels, nbrs, jnbrs = data
    for t, j in (
        (tb.full_filtered_batch(nbrs, labels),
         jb.full_filtered_batch(jnbrs, labels)),
        (tb.sample_balanced_batch(nbrs, labels, 90,
                                  rng=np.random.default_rng(5)),
         jb.sample_balanced_batch(jnbrs, labels, 90,
                                  rng=np.random.default_rng(5))),
        (tb.get_balanced_batch(nbrs, labels, 90,
                               rng=np.random.default_rng(6)),
         jb.get_balanced_batch(jnbrs, labels, 90,
                               rng=np.random.default_rng(6))),
        (tb.get_balanced_batch(nbrs, labels, 5000),
         jb.get_balanced_batch(jnbrs, labels, 5000)),
    ):
        np.testing.assert_array_equal(t[0], np.asarray(j[0]))
        np.testing.assert_array_equal(t[1], np.asarray(j[1]))
