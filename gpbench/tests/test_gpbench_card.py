"""On the card: the control (the reference, in the precision below the
configuration's, in the program's place) fails the comparison, and the
program at the same size passes it; at a size a test run holds (200,000
points).  Skips without a card."""

from pathlib import Path

import pytest

from gpbench.harness import core

ROOT = Path(__file__).resolve().parents[2]
SIZE = {"points": 200_000}
pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["sky2d-serve-bulk", "shear-serve",
                                  "sky2d-serve-small"])
def test_control_fails_and_program_passes(card, cell):
    limits = core.load_json("workloads", cell)["check"]["limits"]
    for solve_only in (False, True):
        control = core.control_run(ROOT, cell, 2**31 + 5, overrides=SIZE,
                                   solve_only=solve_only)
        assert any(control[k] > limits[k] for k in limits), control
    result = core.run_cell(ROOT, cell, 2**31 + 6, 1.0, False, overrides=SIZE)
    assert result["correct"], result["checks"]
