"""Weak-scaling harness for the sharded programs.

Counterpart of :mod:`muygpys_tpu.performance.scaling`: steps per second at
each rank count, the weak-scaling efficiency against the first count, and
the collective bytes per step, for three programs:

- ``"xla_train"``: the generic LOO train step (the composed objective's
  value and its ``torch.autograd`` gradient) on a batch sharded over the
  ranks.  Cross-rank traffic: the loss's and sigma^2's scalar all-reduces
  (forward and backward) and the parameters' gradient all-reduce.
- ``"fused_train"``: the K2 objective (:mod:`muygpys_torch.gpu.fused_train`)
  on each rank's rows; its epilogue all-reduces two short vectors of sums.
- ``"fused_serve_shard_train"``: ``FastServer(engine="fused",
  shard="train")``, one bucket a step: per-shard candidates, the
  all-gather of the candidate rows (``O(ranks x bucket x candidates)``
  bytes, independent of the training size), the union merge, the K1
  solve of each rank's slice, the outputs' all-gather.

Each rank count is one world: ``torch.multiprocessing.spawn`` starts its
ranks, brought up by :func:`muygpys_torch.parallel.initialize_distributed`
on a free local port.  On cards the backend is NCCL with one rank a card
(counts up to ``torch.cuda.device_count()``); ``device="cpu"`` runs gloo
ranks on the CPU; ``backend="gloo"`` on a card lets ranks share it.  Ranks
that share cores or a card measure mechanics (sharding, collectives, the
byte account), not efficiency.

Torch has no HLO module to read: :func:`collective_bytes` counts the bytes
the port's own collective wrappers move during one call
(:data:`muygpys_torch.parallel.comm.bytes_moved`: an all-reduce counts its
tensor, an all-gather its gathered output, as the JAX harness counts an HLO
module's result shapes).

Usage::

    python -m muygpys_torch.performance.scaling            # every card
    python -m muygpys_torch.performance.scaling 1 2        # given counts
    python -m muygpys_torch.performance.scaling --device cpu 1 2 4
    python -m muygpys_torch.performance.scaling --backend gloo 1 2
"""

from __future__ import annotations

import json
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

TRAIN_PROGRAMS = ("xla_train", "fused_train")


def collective_bytes(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Bytes moved on this rank by each collective kind (``"all-reduce"``,
    ``"all-gather"``) during one call ``fn(*args, **kwargs)``; ``{}`` where
    it issues none (a group of one issues none)."""
    from muygpys_torch.parallel import comm

    before = dict(comm.bytes_moved)
    fn(*args, **kwargs)
    moved = {k: v - before.get(k, 0) for k, v in comm.bytes_moved.items()}
    return {k: v for k, v in moved.items() if v}


def _problem(batch: int, nn: int, dtype, device):
    """The JAX harness's training problem (seed 0): the port's model and
    training tensors on ``device``."""
    import torch

    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise

    rng = np.random.default_rng(0)
    train_count = max(4 * nn, 256)
    xtr = rng.uniform(size=(train_count, 2)).astype(dtype)
    ytr = rng.standard_normal((train_count, 1)).astype(dtype)
    bi = rng.choice(train_count, batch, replace=True)
    bni = np.stack(
        [rng.choice(train_count, nn, replace=False) for _ in range(batch)]
    )
    model = MuyGPS(
        kernel=Matern(
            smoothness=Parameter(1.5),
            deformation=Isotropy(
                l2, length_scale=Parameter(0.7, (0.05, 5.0))
            ),
        ),
        noise=HomoscedasticNoise(2e-3, (1e-5, 1e-1)),
        scale=AnalyticScale(),
    )
    tensors = model.make_train_tensors(
        bi, bni, torch.as_tensor(xtr, device=device),
        torch.as_tensor(ytr, device=device),
    )
    return model, tensors


def _train_step(program, model, tensors, mesh, device):
    """One step of a train program on the sharded batch, returning the
    value as a float (which waits for the device)."""
    import torch

    from muygpys_torch.optimize import L_BFGS_B_optimize, lool_fn
    from muygpys_torch.optimize.fused_objective import (
        make_fused_train_objective,
    )
    from muygpys_torch.parallel import shard_batch_global

    cw, pw, bt, bnt = shard_batch_global(tensors, mesh)
    if program == "xla_train":
        obj = L_BFGS_B_optimize.make_obj_fn(model, bt, bnt, cw, pw,
                                            loss_fn=lool_fn)
        dtype = pw.dtype

        def step():
            p = {
                "length_scale": torch.tensor(
                    0.7, dtype=dtype, device=device, requires_grad=True),
                "noise": torch.tensor(
                    2e-3, dtype=dtype, device=device, requires_grad=True),
            }
            val = obj(**p)
            torch.autograd.grad(val, list(p.values()))
            return float(val.detach())

        return step
    fused, _ = make_fused_train_objective(
        model, bt, bnt, cw, pw, loss="lool", device=device
    )

    def step():
        v, _ = fused({"length_scale": 0.7, "noise": 2e-3})
        return float(v)

    return step


def _serve_step(n, cfg, mesh, device):
    """One bucket of the train-sharded fused server, as a step."""
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import FixedScale, Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    rng = np.random.default_rng(0)
    scale = FixedScale()
    scale._set(1.0)
    model = MuyGPS(
        kernel=Matern(
            smoothness=Parameter(1.5),
            deformation=Isotropy(l2, length_scale=Parameter(0.5)),
        ),
        noise=HomoscedasticNoise(1e-3),
        scale=scale,
    )
    train_count = cfg["train_per_device"] * n
    bucket = cfg["bucket_per_device"] * n
    xtr = rng.uniform(size=(train_count, 2)).astype(np.float32)
    ytr = rng.standard_normal((train_count, 1)).astype(np.float32)
    queries = rng.uniform(size=(bucket, 2)).astype(np.float32)
    # FastServer(engine="fused") reads the index's nn_count alone
    nbrs = NN_Wrapper(xtr[:cfg["nn"] + 1], cfg["nn"], device=device)
    server = FastServer(model, nbrs, xtr, ytr, bucket=bucket,
                        engine="fused", mesh=mesh, shard="train",
                        device=device)

    def step():
        server.predict(queries)

    return step, {"bucket": bucket, "train_count": train_count}


def world_records(programs, cfg, mesh, device) -> List[Dict]:
    """Every program in turn on the ranks of ``mesh`` (every rank calls
    this), one record each (rank 0's times; the steps synchronize the
    ranks through their collectives).  ``cfg`` holds the sizes:
    ``batch_per_device``, ``bucket_per_device``, ``train_per_device``,
    ``nn``, ``steps``, ``warmup``."""
    import torch.distributed as dist

    from muygpys_torch.parallel.mesh import mesh_size

    n = mesh_size(mesh)
    dtype = np.float64 if device.type == "cpu" else np.float32
    records = []
    for program in programs:
        if program == "fused_serve_shard_train":
            step, shape = _serve_step(n, cfg, mesh, device)
            count = shape["bucket"]
        else:
            batch = cfg["batch_per_device"] * n
            model, tensors = _problem(batch, cfg["nn"], dtype, device)
            step = _train_step(program, model, tensors, mesh, device)
            shape, count = {"batch": batch}, batch
        for _ in range(cfg["warmup"]):
            step()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(cfg["steps"]):
            step()
        dt = (time.perf_counter() - t0) / cfg["steps"]
        rate = "preds_per_sec" if "bucket" in shape else "rows_per_sec"
        records.append({
            "program": program, "devices": n, **shape, "step_seconds": dt,
            rate: count / dt,
            "collective_bytes_per_step": collective_bytes(step),
        })
    return records


def _rank_main(rank, n, port, programs, cfg, queue):
    """One rank of a world of ``n``: :func:`world_records`; rank 0 puts
    the records on ``queue``."""
    import torch
    import torch.distributed as dist

    from muygpys_torch import config
    from muygpys_torch.parallel import initialize_distributed, make_mesh
    from muygpys_torch.parallel.mesh import rank_device

    if cfg["device"] == "cpu":
        torch.set_num_threads(1)
    config.update("ftype", cfg["ftype"])
    initialize_distributed(
        device=cfg["device"], backend=cfg["backend"],
        coordinator_address=f"localhost:{port}", num_processes=n,
        process_id=rank,
    )
    try:
        records = world_records(programs, cfg, make_mesh(), rank_device())
        if rank == 0:
            for rec in records:
                queue.put(rec)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _default_counts(device, backend) -> List[int]:
    import torch

    if device == "cpu" or backend == "gloo":
        top = 2
    else:
        top = torch.cuda.device_count()
    return [n for n in (1, 2, 4, 8, 16, 32, 64, 128) if n <= top]


def _sweep(programs, device_counts, cfg) -> List[Dict]:
    """One world per rank count, every program inside it; records with
    their efficiency against the first count, per program."""
    import torch
    import torch.multiprocessing as mp

    from muygpys_torch import config

    dev = config.device(cfg["device"])
    cfg = dict(cfg, device=dev.type, ftype=config.state.ftype)
    if device_counts is None:
        device_counts = _default_counts(dev.type, cfg["backend"])
    if dev.type == "cuda":
        from muygpys_torch.gpu import _build

        # every kernel built once, before the ranks start
        _build.build()
        if cfg["backend"] != "gloo":
            over = [n for n in device_counts
                    if n > torch.cuda.device_count()]
            if over:
                raise ValueError(
                    f"NCCL puts one rank on a card: {over} ranks exceed the "
                    f"{torch.cuda.device_count()} visible; pass "
                    "backend='gloo' to share cards"
                )
    ctx = mp.get_context("spawn")
    records: List[Dict] = []
    for n in device_counts:
        queue = ctx.SimpleQueue()
        mp.spawn(_rank_main, args=(n, _free_port(), list(programs), cfg,
                                   queue), nprocs=n, join=True)
        for _ in programs:
            records.append(queue.get())
    return with_efficiency(records)


def with_efficiency(records: List[Dict]) -> List[Dict]:
    """Each record's weak-scaling efficiency against its program's FIRST
    record (sweeps like '2 4' need not start at one rank)."""
    base: Dict[str, tuple] = {}
    for rec in records:
        rate = rec.get("rows_per_sec", rec.get("preds_per_sec"))
        b = base.setdefault(rec["program"], (rate, rec["devices"]))
        rec["efficiency"] = rate / (b[0] * rec["devices"] / b[1])
    return records


def measure_scaling(
    device_counts: Optional[Sequence[int]] = None,
    batch_per_device: int = 1024,
    nn: int = 30,
    steps: int = 10,
    warmup: int = 2,
    program: str = "xla_train",
    device=None,
    backend: Optional[str] = None,
) -> List[Dict]:
    """Weak-scaling sweep for a TRAIN program (``"xla_train"`` or
    ``"fused_train"``); one record per rank count.  ``device`` (default
    ``"cuda"``) and ``backend`` as in
    :func:`muygpys_torch.parallel.initialize_distributed`."""
    if program not in TRAIN_PROGRAMS:
        raise ValueError(f"unknown train program {program!r}")
    return _sweep([program], device_counts, dict(
        batch_per_device=batch_per_device, nn=nn, steps=steps,
        warmup=warmup, device=device, backend=backend,
    ))


def measure_serve_scaling(
    device_counts: Optional[Sequence[int]] = None,
    bucket_per_device: int = 512,
    train_per_device: int = 2048,
    nn: int = 30,
    steps: int = 5,
    warmup: int = 1,
    device=None,
    backend: Optional[str] = None,
) -> List[Dict]:
    """Weak-scaling sweep of the fused ``shard="train"`` serving chain;
    the accounted collectives are the all-gather of the candidate rows and
    of the outputs."""
    return _sweep(["fused_serve_shard_train"], device_counts, dict(
        bucket_per_device=bucket_per_device,
        train_per_device=train_per_device, nn=nn, steps=steps,
        warmup=warmup, device=device, backend=backend,
    ))


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Every program at the given rank counts (default: every card, one
    rank each); one JSON line a record, then the worst efficiency of each
    program."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(prog="muygpys_torch.performance.scaling")
    parser.add_argument("counts", nargs="*", type=int)
    parser.add_argument("--device", default=None)
    parser.add_argument("--backend", default=None)
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    counts = args.counts or None
    base = dict(nn=30, device=args.device, backend=args.backend)
    records = _sweep(TRAIN_PROGRAMS, counts, dict(
        base, batch_per_device=1024, steps=10, warmup=2))
    records += _sweep(["fused_serve_shard_train"], counts, dict(
        base, bucket_per_device=512, train_per_device=2048, steps=5,
        warmup=1))
    for rec in records:
        print(json.dumps(rec))
    by_prog: Dict[str, List[Dict]] = {}
    for r in records:
        by_prog.setdefault(r["program"], []).append(r)
    for prog, recs in by_prog.items():
        if len(recs) > 1:
            worst = min(r["efficiency"] for r in recs[1:])
            print(f"# {prog}: weak-scaling efficiency (worst) = "
                  f"{worst:.3f}")
    if args.device == "cpu" or args.backend == "gloo":
        print("# NOTE: ranks that share CPU cores or one card measure "
              "mechanics (sharding, collectives, the byte account), not "
              "scaling efficiency")
    return records


if __name__ == "__main__":
    main()
