"""The benchmark of muygpys_torch: one run of one cell on one NVIDIA card.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The run makes its data and traffic from
the seed on the card, builds the cell's system, warms the shapes the cell
uses, serves or fits in a closed loop for ``--seconds``, checks a sample
of what the window produced against the plain reference
(``gpbench/reference/``), and prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
from a profiler trace), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, every number compared beside its limit (also the last
lines of standard error).  It refuses to run without a CUDA card, and
fails if JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "muygpys_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from gpbench.harness import core

    spec = next((w for w in core.benchmark(ROOT)["workloads"]
                 if w["name"] == args.workload), None)
    if spec is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < spec["chips"]):
        print(f"{args.workload} needs {spec['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = core.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"loaded in the process that reports: {found}",
              file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})"
              f"{'' if check['ok'] else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
