"""A run driven without the harness's look for a card, on the CPU at a
small size (the kernels' plain versions): sound, ``correct`` is true; with
the timed path broken underneath by each fault the cell can have, it is
false."""

from pathlib import Path

import pytest

from gpbench import faults
from gpbench.harness import core

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"points": 4096}
SERVE = ["sky2d-serve-bulk", "shear-serve", "sky2d-serve-small"]


def run(cell, seed, fault=None):
    return core.run_cell(ROOT, cell, seed, 0.2, False, device="cpu",
                         overrides=SMALL, fault=fault)


@pytest.mark.parametrize("cell", SERVE)
def test_sound_run_is_correct(cell):
    result = run(cell, 2**31 + 17)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SERVE
                                        for f in ("answer", "half")])
def test_fault_is_caught(cell, fault):
    result = run(cell, 2**31 + 29, faults.FAULTS[fault])
    assert not result["correct"], result["checks"]


def test_failed_call_is_counted():
    def broken(entry):
        def fail(request):
            raise RuntimeError("planted")

        entry.call = fail

    with pytest.raises(RuntimeError):
        # the warm-up's failure stops the run before its window
        run("sky2d-serve-small", 3, broken)
