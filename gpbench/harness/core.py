"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell
(``gpbench/workloads/<cell>.json``: its configuration and traffic mix, as
``BENCHMARK.json`` names them, its entry, the entry's options, how many
calls are checked and the limits), its configuration
(``gpbench/configs/<config>.json``), its traffic mix
(``gpbench/traffic/<traffic>.json``) and the kind of traffic that drives
it (``gpbench/traffic/<kind>.py``, see ``gpbench.harness.traffic``), its
entry (``gpbench/entries/<entry>.py``) and each metric's reader
(``gpbench/metrics/<metric>.py``); ``BENCHMARK.json`` says which metrics a
cell reports (none, for a cell it does not list).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from gpbench.harness import data as _data
from gpbench.harness import traffic as _traffic
from gpbench.harness.tracing import Trace, Tracer

GPBENCH = Path(__file__).resolve().parents[1]
# a traced run profiles at most this long, and at most this many calls, of
# its window: enough for every per-layer reading, and a trace the run can
# reduce well inside its time limit
TRACE_SECONDS = 4.0
TRACE_CALLS = 400
clock = time.perf_counter


def load_json(kind: str, name: str) -> dict:
    return json.loads((GPBENCH / kind / f"{name}.json").read_text())


def benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_reader(name: str) -> Callable:
    """``read(run) -> float | None`` of ``gpbench/metrics/<name>.py``."""
    path = GPBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: dict
    config: dict
    calls: List[_traffic.Call]
    window_s: float
    setup_s: float
    trace: Optional[Trace]
    entry: object


class Sample:
    """A sample of the window's calls, drawn from the seed (reservoir
    sampling: every call equally likely), kept with their outputs."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(_data.derive(seed, 3))
        self.items: list = []
        self.seen = 0

    def offer(self, request, output):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((request, output))
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            self.items[j] = (request, output)


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_process: float = None,
             overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None, fault=None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``overrides`` and ``traffic_overrides`` replace keys of the
    configuration and of the traffic mix (the CPU tests' small sizes);
    ``fault(entry)`` breaks the timed path underneath (the tests' faults)."""
    import torch

    t_process = clock() if t_process is None else t_process
    bench = benchmark(root)
    cell = load_json("workloads", cell_name)
    cfg = dict(load_json("configs", cell["config"]), **(overrides or {}))
    mix = dict(_traffic.load(cell["traffic"]), **(traffic_overrides or {}))
    kind = _traffic.kind(mix)
    entry_mod = importlib.import_module(f"gpbench.entries.{cell['entry']}")

    from muygpys_torch.gpu import _build

    phases = {"imports": clock() - t_process}
    dev = torch.device(device)
    x, y = _data.make(cfg, seed, dev)
    pool = kind.pool(mix, seed, cfg["points"], dev)
    _sync(dev)
    phases["data"] = clock() - t_process - sum(phases.values())
    tracer = Tracer(trace, cuda=dev.type == "cuda")
    entry = entry_mod.Entry(cfg, cell, x, y, dev, tracer)
    if fault is not None:
        fault(entry)
    _sync(dev)
    phases["entry"] = clock() - t_process - sum(phases.values())
    # warm-up: the pool's first requests, of the cell's own shapes (the
    # first call of a server builds its kernels and captures its bucket)
    for request in pool[:cell.get("warm", 2)]:
        entry.call(request)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    sample = Sample(cell["check"]["calls"], seed)
    setup_s = clock() - t_process
    phases["warm"] = setup_s - sum(phases.values())
    print("setup " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr, flush=True)
    if trace:
        budget, max_calls = min(seconds, TRACE_SECONDS), TRACE_CALLS
    else:
        budget, max_calls = seconds, 1 << 62
    with tracer.window(clock):
        calls, window_s, failures = kind.drive(
            entry, pool, budget, max_calls, sample.offer, tracer, clock)
    launches = dict(_build.launches)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    run = Run(cell=cell, config=cfg, calls=calls, window_s=window_s,
              setup_s=setup_s, trace=tracer.trace, entry=entry)
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    path = entry.path() if dev.type == "cuda" else {}
    requests = [r for r, _ in sample.items]
    outputs = [o for _, o in sample.items]
    entry.close()
    del entry, run
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _checks(cell, path, launches, dev,
                     entry_mod.compare(cfg, cell["check"], x, y, requests,
                                       outputs)
                     if requests else {})
    result = {
        "correct": bool(requests) and not failures and all(
            c["ok"] for c in checks.values()),
        "attempted": len(calls),
        "failed": len(failures),
        "metrics": metrics,
        "device": _device(dev, memory_peak, tracer.trace),
    }
    if tracer.trace is not None:
        result["breakdown"] = {"device_ops": tracer.trace.top_ops(),
                               "idle_gaps": tracer.trace.idle_gaps()}
    if failures:
        result["failures"] = failures[:3]
    result["checks"] = checks
    return result


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _checks(cell, path, launches, dev, gaps) -> dict:
    """Every number compared, beside its limit: the gaps (at most their
    limit) and, on a card, the path the window must have taken (a captured
    bucket, each named kernel launched at least once)."""
    out = {}
    for name, value in gaps.items():
        limit = cell["check"]["limits"][name]
        out[name] = {"value": value, "limit": limit, "ok": value <= limit}
    for name, value in path.items():
        out[name] = {"value": int(value), "limit": 1, "ok": bool(value)}
    if dev.type == "cuda":
        for kernel in cell["check"].get("launched", ()):
            n = launches.get(kernel, 0)
            out[f"launches.{kernel}"] = {"value": n, "limit": 1,
                                         "ok": n >= 1}
    return out


def _device(dev, memory_peak, trace) -> dict:
    import torch

    if dev.type != "cuda":
        out = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    else:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1, "memory_peak_bytes": int(memory_peak),
               "power_limit_w": _power_limit()}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s
    return out


def _power_limit():
    """The card's power limit in watts, as nvidia-smi reads it (None where
    it cannot be read)."""
    import subprocess

    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(text.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def control_run(root: Path, cell_name: str, seed: int,
                device: str = "cuda", overrides: Optional[dict] = None,
                traffic_overrides: Optional[dict] = None,
                solve_only: bool = False):
    """The control in the program's place: the reference, computed in the
    precision below the configuration's (with ``solve_only``, only its
    solve), answers as many of the seed's requests as a run checks, and
    the same comparison judges them.  Returns the numbers compared."""
    cell = load_json("workloads", cell_name)
    cfg = dict(load_json("configs", cell["config"]), **(overrides or {}))
    entry_mod = importlib.import_module(f"gpbench.entries.{cell['entry']}")
    import torch

    dev = torch.device(device)
    x, y = _data.make(cfg, seed, dev)
    mix = dict(_traffic.load(cell["traffic"]), **(traffic_overrides or {}))
    pool = _traffic.kind(mix).pool(mix, seed, cfg["points"], dev)
    rng = np.random.default_rng(_data.derive(seed, 3))
    pick = rng.choice(len(pool), cell["check"]["calls"], replace=False)
    requests = [pool[i] for i in pick]
    outputs = entry_mod.control(cfg, x, y, requests, solve_only)
    return entry_mod.compare(cfg, cell["check"], x, y, requests, outputs)
