"""The ``sky2d-serve-nu12`` cell: its specification, a sound run on the
CPU at a small size, the program served at the nearest closed form
(ν = 3/2 in place of 1.2) and the TF32 control each breaking a limit, and
on the card the control against the program at 200,000 points (skips
without a card).

At the CPU's 4,096 points the length scale is scaled with the points'
spacing (0.002 x sqrt(10^6 / 4096) ≈ 0.03), so the neighbourhoods straddle
K4's split as at the cell's size; requests of 512 queries keep the
reference's quadrature to seconds."""

import json
import math
from pathlib import Path

import pytest

from gpbench.entries import serve
from gpbench.harness import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "sky2d-serve-nu12"
CONFIG = "matern-nu1.2-sky2d-1m"
POINTS = 4096
SMALL = {"points": POINTS,
         "served": {"length_scale": 0.002 * math.sqrt(1e6 / POINTS),
                    "noise": 0.001, "scale": 1.0}}
TRAFFIC = {"sizes": {"fixed": 512}, "pool": 8}


def test_specification():
    """One configuration and one cell, reported by the serve cells'
    end-to-end and per-layer metrics and by ``k1gen_roofline.serve``, not
    by the closed form's counts."""
    cfg = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    body = core.load_json("configs", CONFIG)
    bulk = core.load_json("configs", "matern32-sky2d-1m")
    for key in ("points", "dim", "field", "field_noise", "kernel",
                "nn_count", "dtype"):
        assert body[key] == bulk[key], key
    assert body["smoothness"] == 1.2
    assert body["served"] == {"length_scale": 0.002, "noise": 0.001,
                              "scale": 1.0}
    assert body["trained"]["smoothness_bounds"] == [0.1, 2.5]
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "closed-8192-uniform", 1)
    spec = core.load_json("workloads", CELL)
    assert spec["entry"] == "serve_nu" and spec["server"] == {
        "engine": "fused", "rerank": True, "bucket": 8192}
    assert spec["check"]["launched"] == ["fused_predict_coords/gen",
                                         "knn_candidates_pruned"]
    reported = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
                if CELL in m.get("workloads", [CELL])}
    assert reported == {"preds_per_s", "request_p95_ms", "setup_s",
                        "idle_share.serve", "search_device_ms.serve",
                        "stage_ms.serve", "readback_idle_ms.serve",
                        "k1gen_roofline.serve", "mfu_gen.serve"}


def test_k1gen_counts():
    """The mean evaluation over K1's 495 values at n = 30 (30 diagonal at
    1 operation, 435 pairs and 30 crosswise at their frozen tail shares,
    64 operations a series value and 90 a tail value), and the reader
    reads nothing from an untraced run."""
    from types import SimpleNamespace

    from gpbench.roofline import counts, k1gen_counts as kg

    pair = 0.5478 * 90 + 0.4522 * 64
    cross = 0.3051 * 90 + 0.6949 * 64
    want = (30 + 435 * pair + 30 * cross) / 495
    assert kg.eval_ops(30) == pytest.approx(want, rel=1e-12)
    assert kg.k1gen_ops_per_query(30, 2, 1) == pytest.approx(
        counts.k1_ops_per_query(30, 2, 1, eval_ops=want), rel=1e-12)
    assert kg.k1gen_bytes(30, 2, 1, 8192) == (
        counts.k1_bytes(30, 2, 1, 8192) + 73 * 4)
    for name in ("k1gen_roofline.serve", "mfu_gen.serve"):
        reader = core.metric_reader(name)
        assert reader(SimpleNamespace(trace=None, calls=[])) is None, name


def run(seed, fault=None):
    return core.run_cell(ROOT, CELL, seed, 0.2, False, device="cpu",
                         overrides=SMALL, traffic_overrides=TRAFFIC,
                         fault=fault)


def test_sound_run_is_correct():
    result = run(2**31 + 17)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == {"mean_gap", "var_gap", "mean_miss"}


def test_entry_refuses_a_program_without_the_counter(monkeypatch):
    """A program that does not count K1's general-order launches cannot
    show the cell's path: the entry refuses it before building a server."""
    from muygpys_torch.gpu import _build

    monkeypatch.delitem(_build.launches, "fused_predict_coords/gen")
    with pytest.raises(RuntimeError, match="general-order launches"):
        run(2**31 + 41)


def test_nearest_closed_form_breaks_a_limit(monkeypatch):
    """The server built at ν = 3/2, judged against the ν = 1.2
    reference."""
    build = serve.Entry.__init__

    def at_three_halves(self, cfg, *rest):
        build(self, dict(cfg, smoothness=1.5), *rest)

    monkeypatch.setattr(serve.Entry, "__init__", at_three_halves)
    result = run(2**31 + 29)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("solve_only", [False, True])
def test_tf32_control_fails(solve_only):
    limits = core.load_json("workloads", CELL)["check"]["limits"]
    control = core.control_run(ROOT, CELL, 2**31 + 5, device="cpu",
                               overrides=SMALL, traffic_overrides=TRAFFIC,
                               solve_only=solve_only)
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card(card):
    size = {"points": 200_000,
            "served": {"length_scale": 0.002 * math.sqrt(5.0),
                       "noise": 0.001, "scale": 1.0}}
    limits = core.load_json("workloads", CELL)["check"]["limits"]
    for solve_only in (False, True):
        control = core.control_run(ROOT, CELL, 2**31 + 5, overrides=size,
                                   solve_only=solve_only)
        assert any(control[k] > limits[k] for k in limits), control
    result = core.run_cell(ROOT, CELL, 2**31 + 6, 1.0, False,
                           overrides=size)
    assert result["correct"], result["checks"]
