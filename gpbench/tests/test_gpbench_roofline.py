"""The frozen counts equal ``chip_smoke.py``'s functions at the cells'
shapes, and the interval arithmetic sums unions."""

import sys
from pathlib import Path

import pytest

from gpbench.roofline import busy, counts, peaks

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("n,d,r", [(30, 2, 1), (30, 2, 2), (50, 3, 1)])
def test_k1_count(n, d, r):
    assert counts.k1_ops_per_query(n, d, r) == chip_smoke.k1_ops_per_query(
        n, d, r)
    assert (counts.k1_ops_per_query(n, d, r, coords=False)
            == chip_smoke.k1_ops_per_query(n, d, r, coords=False))


@pytest.mark.parametrize("n,r,free", [(30, 1, True), (30, 1, False),
                                      (40, 2, True)])
def test_k2_count(n, r, free):
    assert counts.k2_ops_per_point(n, 0, r, free) == (
        chip_smoke.k2_ops_per_point(n, 0, r, free))


@pytest.mark.parametrize("m,o", [(90, 3), (60, 3), (24, 3)])
def test_k5_count(m, o):
    assert counts.k5_flops_per_query(m, o) == chip_smoke.k5_flops_per_query(
        m, o)


def test_byte_rules_at_the_cells_shapes():
    # chip_smoke.py's phase 3 (K1), phase 6 (K2) and phase 13 (K5) rules
    n, d, r, B = 30, 2, 1, 8192
    assert counts.k1_bytes(n, d, r, B) == ((n * d + d + n * r + r + 1) * 4
                                           * B + (d + 1) * 4)
    rows = len(chip_smoke.k2_row_names(1, ["length_scale"]))
    assert counts.k2_rows(1) == rows
    assert counts.k2_bytes(n, r, 2048, rows) == (
        (n * (n + 1) // 2 + n + n * r + rows) * 2048 + 3) * 4
    assert counts.k5_bytes(90, 3, 2048) == (90 * 90 + 270 + 90 + 3 + 9) * 4 * 2048
    assert peaks.FP32_FLOPS == chip_smoke.FP32_FLOPS
    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert busy.union_s(spans) == 3.0
    assert busy.union_s(spans, 0.5, 3.5) == 2.0
    assert busy.gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                           (4.0, 5.0)]
    assert busy.idle_share(3.0, 4.0) == 0.25
