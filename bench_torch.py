#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:

    python3 bench_torch.py

Prints ONE JSON line with the fields of the JAX package's ``bench.py``
headline, each timed on the card by
:func:`muygpys_torch.performance.headline.measure` (one iteration captured
as a CUDA graph, 200 replays between CUDA events, 5 repeats; a rate is the
work of one iteration over its least per-iteration time, and a spread
gives the repeats' median, least and most):

- ``value`` (``posterior_predictions_per_sec_per_chip``): K1 on 8192
  queries' gathered neighbour coordinates (nn = 30, d = 2, Matern 3/2);
- ``end_to_end_preds_per_sec``: K3p over 50,000 Morton-sorted points, one
  gather, the exact re-rank of 8 extra candidates and K1; ``_approx``
  without the re-rank (256 bins); ``_1m`` the same without the re-rank over
  1,000,000 points and 4096 queries;
- ``train_steps_per_sec``: one K2 LOO value and analytic gradient step
  (lool, batch 2048); ``_gen`` with a free smoothness (K4's constructor and
  the d/dnu rows);
- ``kernel_preds_per_sec_gen``: K1 with K4 inlined at nu = 1.2;
- ``shear_preds_per_sec``: the shear block assembly and K5 at batch 2048.

``device`` is the card's name and power limit as ``nvidia-smi`` gives
them.  A kernel that does not build or launch raises, and without a card
the script exits non-zero: nothing falls back to another engine.
"""

import json
import subprocess
import sys


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def _rate_spread(spread, scale):
    """A seconds spread as a rate spread (the least seconds is the most
    rate)."""
    def rate(sec):
        return round(scale / sec, 1)

    return {
        "repeats": spread["repeats"],
        "median": rate(spread["median"]),
        "min": rate(spread["max"]),
        "max": rate(spread["min"]),
    }


def main() -> dict:
    """Measure every headline field on the card, print the JSON line and
    return it as a dict."""
    import functools

    from muygpys_torch.performance import headline as h

    best, serve_spread = h.measure(
        h.pallas_coords_loop, h.make_coords_inputs(), stats=True
    )
    serve_inputs = h.make_serve_inputs()
    e2e = h.measure(h.end_to_end_loop, serve_inputs)
    e2e_approx = h.measure(
        functools.partial(h.end_to_end_loop, rerank=False), serve_inputs
    )
    del serve_inputs
    train_inputs = h.make_train_inputs()
    train_step, train_spread = h.measure(
        h.fused_train_loop, train_inputs, stats=True
    )
    train_gen_step, train_gen_spread = h.measure(
        h.fused_train_loop_gen, train_inputs, stats=True
    )
    del train_inputs
    e2e_1m = h.measure(
        functools.partial(h.end_to_end_loop, rerank=False),
        h.make_serve_1m_inputs(),
    )
    gen_best = h.measure(h.pallas_coords_gen_loop, h.make_coords_inputs())
    shear_best = h.measure(
        functools.partial(h.shear_serve_loop, engine="pallas"),
        h.make_shear_inputs(),
    )

    out = {
        "metric": "posterior_predictions_per_sec_per_chip",
        "value": round(h.BATCH / best, 1),
        "unit": "predictions/sec",
        "value_spread": _rate_spread(serve_spread, h.BATCH),
        "train_spread": _rate_spread(train_spread, 1.0),
        "train_gen_spread": _rate_spread(train_gen_spread, 1.0),
        "end_to_end_preds_per_sec": round(h.BATCH / e2e, 1),
        "end_to_end_preds_per_sec_approx": round(h.BATCH / e2e_approx, 1),
        "end_to_end_train_count": h.TRAIN_COUNT,
        "end_to_end_preds_per_sec_1m": round(h.Q_1M / e2e_1m, 1),
        "train_steps_per_sec": round(1.0 / train_step, 1),
        "train_steps_per_sec_gen": round(1.0 / train_gen_step, 1),
        "kernel_preds_per_sec_gen": round(h.BATCH / gen_best, 1),
        "shear_preds_per_sec": round(h.SHEAR_BATCH / shear_best, 1),
        "train_batch": h.TRAIN_BATCH,
        "device": card(),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device", file=sys.stderr)
        sys.exit(2)
    main()
