"""Traffic: a mix's parameters (``gpbench/traffic/<mix>.json``) and the
kind of traffic that drives them (``gpbench/traffic/<kind>.py``, named by
the mix's ``kind``), found by name.

A kind's module has

- ``pool(spec, seed, points, device) -> list``: the requests it will send,
  made from the seed (most kinds call :func:`queries`);
- ``drive(entry, pool, seconds, max_calls, answered, tracer, clock)
  -> (calls, window_s, failures)``: sends them to ``entry.call`` for
  ``seconds`` (or ``max_calls`` calls), each call inside the tracer's
  ``call`` span, hands each answered request and its output to
  ``answered(request, output)``, and returns a :class:`Call` for each call,
  the window's seconds and the tracebacks of the calls that failed.

Parameters every kind reads through :func:`queries`:

- ``sizes``: ``{"fixed": n}``, or ``{"range": [lo, hi]}`` (every size from
  lo to hi once, in an order drawn from the seed, so that every seed sends
  the same set of sizes);
- ``placement``: ``{"kind": "uniform"}`` over the unit square, or
  ``{"kind": "cluster", "side": s}``: uniform in a square of side ``s``
  around a centre uniform over the square's interior;
- ``pool``: how many distinct requests (a ``range`` makes one per size).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

import numpy as np

from gpbench.harness.data import derive

ROOT = Path(__file__).resolve().parents[1] / "traffic"


@dataclasses.dataclass
class Call:
    start: float
    end: float
    size: int  # queries answered
    ok: bool

    @property
    def seconds(self) -> float:
        return self.end - self.start


def load(name: str) -> dict:
    return json.loads((ROOT / f"{name}.json").read_text())


def kind(spec: dict):
    """The module of the mix's kind, ``gpbench/traffic/<kind>.py``."""
    name = spec["kind"]
    module_spec = importlib.util.spec_from_file_location(
        "gpbench_traffic_" + name.replace("-", "_"), ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def sizes(spec: dict, rng: np.random.Generator) -> List[int]:
    s = spec["sizes"]
    if "fixed" in s:
        return [int(s["fixed"])] * int(spec["pool"])
    lo, hi = s["range"]
    return [int(v) for v in rng.permutation(np.arange(lo, hi + 1))]


def queries(spec: dict, seed: int, device) -> list:
    """The mix's requests, float32 ``(count, 2)`` host numpy arrays of
    points to predict at, made on ``device`` from the seed."""
    import torch

    rng = np.random.default_rng(derive(seed, 1))
    g = torch.Generator(device=device).manual_seed(derive(seed, 2))
    place = spec["placement"]
    if place["kind"] not in ("uniform", "cluster"):
        raise ValueError(f"unknown placement {place['kind']!r}")
    out = []
    for count in sizes(spec, rng):
        u = torch.rand((count, 2), generator=g, device=device,
                       dtype=torch.float32)
        if place["kind"] == "cluster":
            side = float(place["side"])
            centre = torch.rand((1, 2), generator=g, device=device,
                                dtype=torch.float32)
            centre = side / 2 + (1 - side) * centre
            u = centre + side * (u - 0.5)
        out.append(u.cpu().numpy())
    return out
