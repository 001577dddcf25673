"""The exact search's CUDA source (``csrc/knn_exact.cu``), run on the CPU one
thread per CUDA thread (``_cuda_emulation``), against its plain version
``knn_exact_select_plain`` (its ThreadSanitizer launch is in
test_torch_cuda_emulation_races.py).  Skipped where ``g++`` lacks C++20
``<barrier>``."""

import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

import _cuda_emulation as emu
from muygpys_torch.gpu import knn_exact as X


@pytest.fixture(scope="module")
def lib():
    return ctypes.CDLL(emu.build("knn_exact"))


@pytest.mark.parametrize("k", [1, 30, 31, 64])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_knn_exact_source_matches_plain(lib, d, k):
    """2125 uniform rows in tiles of 64 (the last ragged, 13 rows) and 9
    queries (a partial block): the distances are the plain version's bits,
    in ascending order, the index sets equal; the counter holds the tiles
    scored, fewer than all of them."""
    index, queries = emu.knn_exact_problem(2125, 9, d, tile=64, seed=d)
    nt = X.tile_count(index)
    assert nt == 34 and 2125 % 64 == 13
    idx, d2 = emu.knn_exact_run(lib, index, queries, k)
    scored = int(index.scored)
    ip, dp = X.knn_exact_select_plain(index, queries, k)
    assert torch.equal(d2, dp)
    assert torch.equal(torch.sort(idx, 1).values, torch.sort(ip, 1).values)
    assert 9 * 2 <= scored < 9 * nt


def _ties_problem(case):
    rng = np.random.default_rng(7)
    if case == "duplicated":
        rows = rng.uniform(size=(1100, 2)).astype(np.float32)
        train = np.concatenate([rows, rows[rng.permutation(1100)]])
    else:  # a 48 x 48 grid
        g = np.arange(48, dtype=np.float32) / 47
        train = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
        train = train[rng.permutation(len(train))]
    queries = np.concatenate([train[:6], rng.uniform(size=(6, 2))])
    return (torch.as_tensor(train),
            torch.as_tensor(queries.astype(np.float32)))


@pytest.mark.parametrize("case", ["duplicated", "grid"])
def test_knn_exact_source_on_ties(lib, case):
    """On duplicated rows and on a grid, where many rows lie at equal
    distances: the distances are the plain version's bits, and any row one
    returns and the other does not lies at the k-th distance (a tie)."""
    train, queries = _ties_problem(case)
    with mock.patch.object(X, "TILE", 64):
        index = X.build_exact_index(train)
    k = 30
    idx, d2 = emu.knn_exact_run(lib, index, queries, k)
    ip, dp = X.knn_exact_select_plain(index, queries, k)
    assert torch.equal(d2, dp)
    for qi, q in enumerate(queries):
        a, b = set(idx[qi].tolist()), set(ip[qi].tolist())
        assert len(a) == k
        for row in a ^ b:
            t = train[row]
            dist = (q[0] - t[0]) ** 2 + (q[1] - t[1]) ** 2
            assert float(dist) == float(d2[qi, -1]), (qi, row)
