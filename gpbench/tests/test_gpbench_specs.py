"""Every file of the benchmark loads, every name is legal, and
BENCHMARK.json meets the contract's shape."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
GPBENCH = ROOT / "gpbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def one_line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(one_line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_are_legal_and_unique():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(NAME.match(w["traffic"]) for w in BENCH["workloads"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"gpbench/configs/{cfg['name']}.json"
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    assert (ROOT / body["reference"]).exists()
    assert one_line(cfg["source"]) and one_line(cfg["why"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and one_line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    spec = json.loads((GPBENCH / "workloads" / f"{cell['name']}.json")
                      .read_text())
    assert (spec["config"], spec["traffic"]) == (cell["config"],
                                                 cell["traffic"])
    assert (GPBENCH / "entries" / f"{spec['entry']}.py").exists()
    assert spec["check"]["limits"] and spec["check"]["calls"] >= 1
    from gpbench.harness import traffic

    kind = traffic.kind(traffic.load(cell["traffic"]))
    assert callable(kind.pool) and callable(kind.drive)
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]])
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    from gpbench.harness import core

    assert callable(core.metric_reader(metric["name"]))
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert one_line(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved["workloads"])


def test_every_file_under_paths_has_a_legal_name():
    for path in GPBENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", rel), rel
