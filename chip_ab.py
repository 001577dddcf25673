#!/usr/bin/env python3
"""End-to-end rates of two checkouts of the port on one NVIDIA GPU,
alternated, so that the host's speed (which sets these rates) is the same
for both.

    python3 chip_ab.py OTHER_ROOT [--rounds 2] [--reps 7]

OTHER_ROOT is a second checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory); the
checkout holding this script is the other side.  Each round runs a fresh
process per side in the order other, this, this, other.  A process builds
its checkout's kernels, sets up the chip_smoke.py headlines and measures,
``--reps`` times each after a warm-up:

- fixed-smoothness training (phase 7's headline: the 50,000-point field, a
  LOO batch of 2048, Matern 3/2, free length scale and noise, f32):
  objective evaluations per second of ``Fused_L_BFGS_B_optimize`` (the
  probe at x0 and scipy's nfev over the optimization's host-clock time);
- shear serving (phase 14's headline: the 50,000-point sky, ShearKernel,
  ``FastServer(engine="kernel", bucket=2048)``, three requests of 2048,
  2048 and 1000): predictions per second between CUDA events.

Both sides use this checkout's chip_smoke.py for the data and the models,
and only the public API of the checkout under test.  Prints the card's name
and power limit, one JSON line per process, and last a JSON summary with
the median of each side's per-process medians.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def smoke_helpers():
    """This checkout's chip_smoke.py, loaded by path (the checkout under
    test may hold its own)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def probe(root: str, reps: int) -> dict:
    """Measure both rates with the muygpys_torch of ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    cs = smoke_helpers()
    from muygpys_torch.gpu import _build
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.optimize import Fused_L_BFGS_B_optimize, sample_batch
    from muygpys_torch.optimize.fused_objective import (
        make_fused_train_objective,
    )
    from muygpys_torch.serve import FastServer

    import muygpys_torch

    assert os.path.realpath(os.path.dirname(os.path.dirname(
        muygpys_torch.__file__))) == os.path.realpath(root)
    _build.build()
    # chip_smoke.py's headline data: the same draws in the same order
    rng = np.random.default_rng(1)
    train = rng.uniform(size=(cs.TRAIN, cs.D)).astype(np.float32)
    rng.standard_normal((cs.TRAIN, 1))  # the serving targets
    rng.uniform(size=(cs.QUERIES + 8192 + 5000, cs.D))  # the queries
    y_train = (
        np.sin(2 * np.pi * train[:, 0]) * np.cos(2 * np.pi * train[:, 1])
        + 0.1 * rng.standard_normal(cs.TRAIN)
    )[:, None]
    nbrs = NN_Wrapper(train, cs.NN)
    bi, bnn = sample_batch(nbrs, cs.TRAIN_BATCH, cs.TRAIN,
                           rng=np.random.default_rng(2))
    train_d = torch.as_tensor(train, device="cuda")
    y_d = torch.as_tensor(y_train, dtype=torch.float32, device="cuda")
    import scipy.optimize  # noqa: F401

    cw, pw, bt, bnt = cs.train_model().make_train_tensors(bi, bnn, train_d, y_d)
    make_fused_train_objective(cs.train_model(), bt, bnt, cw, pw)[0]({})
    train_rates = []
    for _ in range(reps + 1):  # the first optimization is a warm-up
        report = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(report):
            Fused_L_BFGS_B_optimize(cs.train_model(), bt, bnt, cw, pw,
                                    engine="kernel", verbose=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        evals = 1 + int(re.search(r"\bnfev:\s*(\d+)", report.getvalue())[1])
        train_rates.append(evals / seconds)

    sky, sky_targets, requests = cs.shear_sky(np)
    server = FastServer(cs.shear_model(), NN_Wrapper(sky, cs.SHEAR_NN), sky,
                        sky_targets, bucket=cs.SHEAR_BATCH, engine="kernel")
    server.predict(requests[-1])  # warm-up
    shear_rates = [cs.serve(torch, server, requests)[2] for _ in range(reps)]
    return dict(
        root=root,
        train_evals_per_s=train_rates[1:],
        train_median=statistics.median(train_rates[1:]),
        shear_preds_per_s=shear_rates,
        shear_median=statistics.median(shear_rates),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", nargs="?")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--probe", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.probe:
        print(json.dumps(probe(args.probe, args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.other:
        print("chip_ab: needs a CUDA device and a second checkout",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    sides = {"other": os.path.abspath(args.other), "this": HERE}
    results = {"other": [], "this": []}
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--probe",
                 sides[side], "--reps", str(args.reps)],
                check=True, stdout=subprocess.PIPE, text=True,
            ).stdout.strip().splitlines()[-1]
            print(f"{side}: {out}", flush=True)
            results[side].append(json.loads(out))
    print(json.dumps({
        side: dict(
            root=sides[side],
            train_evals_per_s=statistics.median(
                r["train_median"] for r in runs),
            shear_preds_per_s=statistics.median(
                r["shear_median"] for r in runs),
            train_by_process=[r["train_median"] for r in runs],
            shear_by_process=[r["shear_median"] for r in runs],
        ) for side, runs in results.items()
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
