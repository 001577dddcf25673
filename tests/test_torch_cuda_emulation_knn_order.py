"""The bounded route's query order (``csrc/knn.cu:knn_query_order_kernel``),
run on the CPU one thread per CUDA thread (``_cuda_emulation``): the sorted
and edge-padded queries, the permutation and its inverse bit for bit
against the plain path (``knn._sorted_queries`` and ``torch.argsort``) at 1
to 4 features, on uniform queries of one to three warps, rows repeated
(equal codes, so stability shows), a feature with one value (the grid's
1e-30 floor) and a cluster in a square of side 0.01.  Its ThreadSanitizer
launch is ``"k3-query-order"`` in ``_cuda_emulation.RACE_LAUNCHES``.
Skipped where ``g++`` lacks C++20 ``<barrier>``."""

import ctypes

import numpy as np
import pytest
import torch

import _cuda_emulation as emu
from muygpys_torch.gpu import knn as K


@pytest.fixture(scope="module")
def lib():
    return ctypes.CDLL(emu.build("knn"))


def _check(lib, queries):
    """One launch against the plain path, every output bit for bit."""
    queries = torch.as_tensor(queries)
    q_pad, qperm, qinv = emu.knn_order_run(lib, queries)
    want_pad, want_perm = K._sorted_queries(queries, 8)
    assert torch.equal(qperm, want_perm)
    assert torch.equal(q_pad, want_pad)
    assert torch.equal(qinv, torch.argsort(want_perm))
    assert torch.equal(qperm[qinv], torch.arange(len(queries)))


@pytest.mark.parametrize("count", [1, 7, 9, 37, 600])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_order_source_is_the_plain_sort(lib, d, count):
    """Uniform queries: one warp (up to 256 queries, 1, 7 and 9 in one
    round of 32 slots, 37 in two) and three (600, the counts scanned
    across warps)."""
    rng = np.random.default_rng(10 * d + count)
    _check(lib, rng.uniform(-2.0, 3.0, size=(count, d)).astype(np.float32))


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_order_source_keeps_equal_codes_in_row_order(lib, d):
    """37 queries drawn from 5 rows, a few moved within their cell: many
    equal Morton codes, which the stable sort keeps in row order."""
    rng = np.random.default_rng(d)
    rows = rng.uniform(size=(5, d)).astype(np.float32)
    queries = rows[rng.integers(0, 5, size=37)]
    queries[::6] += np.float32(1e-7)
    codes = K._morton_codes(torch.as_tensor(queries))
    assert len(torch.unique(codes)) <= 10
    _check(lib, queries)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_order_source_on_a_feature_of_one_value(lib, d):
    """The last feature holds one value (hi == lo: the grid's scale takes
    the 1e-30 floor); at d = 1 every code is 0."""
    rng = np.random.default_rng(40 + d)
    queries = rng.uniform(size=(37, d)).astype(np.float32)
    queries[:, -1] = 0.625
    _check(lib, queries)


def test_order_source_on_a_cluster(lib):
    """Small's traffic: 37 queries in a square of side 0.01 around a random
    centre, edge-padded to its bucket of 40 rows as the server pads."""
    rng = np.random.default_rng(7)
    centre = rng.uniform(0.0, 0.99, size=2)
    queries = (centre + 0.01 * rng.uniform(size=(37, 2))).astype(np.float32)
    _check(lib, np.concatenate([queries, queries[-1:].repeat(3, 0)]))
