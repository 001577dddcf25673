"""The ``sky2d-fastmean-serve`` cell: its plain reference against a direct
dense solve, its specification, a sound run and the faults on the CPU at
a small size, the TF32 control, and on the card the control against the
program at 200,000 points (skips without a card)."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from gpbench import faults
from gpbench.harness import core
from gpbench.reference import fastmean

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "sky2d-fastmean-serve"
SMALL = {"points": 4096}
RNG = np.random.default_rng(23)
X = RNG.uniform(size=(400, 2))
Y = np.sin(6 * X[:, 0]) + 0.1 * RNG.standard_normal(400)
Q = RNG.uniform(size=(25, 2))
NN = 12


def matern32(r, ls):
    u = math.sqrt(3) * r / ls
    return (1 + u) * np.exp(-u)


def test_reference_against_a_dense_solve():
    """Each query from its nearest point's neighbourhood (the point and
    its 11 nearest others), solved again densely in numpy."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    sets, row = fastmean.neighbourhoods(t(X), t(Q), NN)
    got = fastmean.posterior_mean(t(X), t(Y), t(Q), sets, row, 0.3, 1e-2,
                                  1.5).numpy()
    d = np.linalg.norm(X[:, None] - X[None], axis=-1)
    for b, q in enumerate(Q):
        j = int(np.argmin(np.linalg.norm(X - q, axis=-1)))
        others = [i for i in np.argsort(d[j], kind="stable") if i != j]
        nb = np.array([j] + others[:NN - 1])
        assert sorted(sets[row[b]].tolist()) == sorted(nb.tolist())
        p = X[nb]
        K = matern32(np.linalg.norm(p[:, None] - p[None], axis=-1), 0.3)
        C = np.linalg.solve(K + 1e-2 * np.eye(NN), Y[nb])
        want = matern32(np.linalg.norm(p - q, axis=-1), 0.3) @ C
        np.testing.assert_allclose(got[b], want, rtol=1e-10, atol=1e-12)


def test_specification():
    """One configuration and one cell, reported by the end-to-end metrics
    of the serve cells and by the per-layer metrics that read it; the
    precompute's reading moves ``setup_s``, which every cell reports."""
    cfg = next(c for c in BENCH["configs"]
               if c["name"] == "matern32-fastmean-sky2d-1m")
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    body = json.loads((ROOT / cfg["file"]).read_text())
    bulk = core.load_json("configs", "matern32-sky2d-1m")
    for key in ("points", "dim", "field", "field_noise", "kernel",
                "smoothness", "nn_count", "served", "dtype"):
        assert body[key] == bulk[key], key
    assert body["predict"] == "fast_mean" and body["nn_method"] == "exact"
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["traffic"], cell["chips"]) == ("closed-8192-uniform", 1)
    reported = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
                if CELL in m.get("workloads", [CELL])}
    assert reported >= {"preds_per_s", "request_p95_ms", "setup_s",
                        "idle_share.serve", "search_device_ms.serve",
                        "stage_ms.serve", "readback_idle_ms.serve",
                        "precompute_s.fastmean",
                        "contract_device_ms.fastmean",
                        "contract_roofline.fastmean", "mfu.fastmean"}
    assert not reported & {"mfu.serve", "k1_roofline.serve"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for metric in BENCH["per_layer"]:
        if not metric["name"].endswith(".fastmean"):
            continue
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))


def run(seed, fault=None):
    return core.run_cell(ROOT, CELL, seed, 0.2, False, device="cpu",
                         overrides=SMALL, fault=fault)


def test_sound_run_is_correct():
    result = run(2**31 + 17)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == {"mean_gap", "mean_miss"}


@pytest.mark.parametrize("fault", ["answer", "half"])
def test_fault_is_caught(fault):
    result = run(2**31 + 29, faults.FAULTS[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("solve_only", [False, True])
def test_tf32_control_fails(solve_only):
    """The reference in TF32 in the program's place (its operands rounded
    as TF32's products read them, on the CPU too) misses the limits."""
    limits = core.load_json("workloads", CELL)["check"]["limits"]
    control = core.control_run(ROOT, CELL, 2**31 + 5, device="cpu",
                               overrides=SMALL, solve_only=solve_only)
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card(card):
    limits = core.load_json("workloads", CELL)["check"]["limits"]
    for solve_only in (False, True):
        control = core.control_run(ROOT, CELL, 2**31 + 5,
                                   overrides={"points": 200_000},
                                   solve_only=solve_only)
        assert any(control[k] > limits[k] for k in limits), control
    result = core.run_cell(ROOT, CELL, 2**31 + 6, 1.0, False,
                           overrides={"points": 200_000})
    assert result["correct"], result["checks"]
