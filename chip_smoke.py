#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (muygpys_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the serving path (one nvcc per
   source, started together) and report the seconds;
3. K1 (fused coords solve) against its plain PyTorch version on the card at
   the serving shape (n=30, d=2, r=1, B=8192) for every closed form, RBF on
   F2 and a heteroscedastic case, in f32 and f64;
4. K3 (packed-key KNN candidates), unpruned and pruned, against its plain
   version at 50,000 x 8192, d=2, plus the cdist + topk yardstick;
5. end to end: FastServer(engine="fused") at the headline configuration
   (50k Morton-sorted training points, d=2, nn=30, bucket 8192, Matern 3/2,
   ls 0.5, noise 1e-3, f32) answers three requests, one not a multiple of
   the bucket; the same with engine="kernel" over an exact NN_Wrapper; both
   held against the f64 reference engine on the same exact neighbours
   (mean and variance each against its own limit); a torch.profiler trace
   of the fused requests gives device time by kernel and the idle share;
6. the kernels line: one JSON object with every kernel's launches on the
   fused path, error against its plain version, times and bound;
7. the last line: {"ok": true, "device": {...}}.

Times are CUDA-event medians.  Bounds use the H100 SXM data-sheet peaks
(3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor cores).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

TRAIN, QUERIES, D, NN = 50_000, 8192, 2, 30
LS, NOISE, NU = 0.5, 1e-3, 1.5
# f32 posterior mean floor at noise 1e-3 (kernel-evaluation rounding, the
# bound bench.py records): within 5e-3 of the f64 reference
MEAN_TOL_F32 = 5e-3
# f32 posterior variance: 1 - zc.zc loses ~eps_f32 absolute (2.5e-7 against
# f64 at the headline), while the variances themselves are ~3e-5..1e-2; the
# gate sits 8x above that spread and must stay under a tenth of the smallest
# variance compared, so a zero or wrongly scaled variance fails
VAR_TOL_F32 = 2e-6


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def k1_ops_per_query(n, d, r):
    """Floating-point operations of one K1 query (exp counted as one).

    The symmetric K needs n(n+1)/2 kernel evaluations, kc another n."""
    m = n + 1 + r
    kernel_entries = n * (n + 1) // 2 + n
    assembly = kernel_entries * (3 * d + 1 + 6)
    elimination = sum(
        (m - j) + (n - 1 - j) + 2 * (n - 1 - j) * (m - 1 - j) + 1
        for j in range(n)
    )
    return assembly + elimination + 2 * n * (r + 1)


def phase_k1(torch, knn_inputs):
    from muygpys_torch.gpu.fused_predict import (
        fused_predict_coords_bl,
        fused_predict_coords_bl_plain,
    )

    nf32, q32, y32 = knn_inputs
    n, d, B = nf32.shape
    r = y32.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(7)
    noise_nn32 = (
        torch.rand((n, B), generator=gen, device="cuda") * 1e-2 + 1e-4
    )
    cases = [
        (0.5, 1, False), (1.5, 1, False), (2.5, 1, False),
        (math.inf, 1, False), ("rbf", 2, False), (1.5, 1, True),
    ]
    # (mean, variance) limits.  f64: both sides exact to ~1e-16 x the
    # neighborhood conditioning (<= ~1e5 at noise 1e-3); f32: the floors
    # above
    tol = {torch.float64: (1e-8, 1e-10), torch.float32: (MEAN_TOL_F32, VAR_TOL_F32)}
    row = None
    for dtype in (torch.float32, torch.float64):
        nf, q, y = (t.to(dtype).contiguous() for t in (nf32, q32, y32))
        noise_nn = noise_nn32.to(dtype)
        for nu, power, hetero in cases:
            params = torch.tensor([LS] * d + [NOISE], dtype=dtype, device="cuda")
            args = (nf, q, y, params, noise_nn if hetero else None)
            kw = dict(smoothness=nu, metric_power=power)
            mk, vk = fused_predict_coords_bl(*args, **kw)
            torch.cuda.synchronize()
            mp, vp = fused_predict_coords_bl_plain(*args, **kw)
            assert torch.isfinite(mk).all() and torch.isfinite(vk).all()
            err_m = float((mk - mp).abs().max())
            err_v = float((vk - vp).abs().max())
            err = max(err_m, err_v)
            tol_m, tol_v = tol[dtype]
            v_min = float(vp.abs().min())
            log(f"K1 {str(dtype)[6:]} nu={nu} power={power} hetero={hetero}: "
                f"mean max_abs_err={err_m:.3e} (tol {tol_m:.0e}), var "
                f"max_abs_err={err_v:.3e} (tol {tol_v:.0e}; var min "
                f"{v_min:.3e} median {float(vp.median()):.3e})")
            assert tol_v <= 0.1 * v_min, "variance gate too loose to see a wrong var"
            assert err_m <= tol_m, f"K1 mean disagrees with its plain version: {err_m}"
            assert err_v <= tol_v, f"K1 var disagrees with its plain version: {err_v}"
            if dtype == torch.float32 and nu == NU and not hetero:
                ms = time_ms(lambda: fused_predict_coords_bl(*args, **kw))
                plain_ms = time_ms(
                    lambda: fused_predict_coords_bl_plain(*args, **kw), reps=5
                )
                nbytes = (n * d + d + n * r + r + 1) * 4 * B + (d + 1) * 4
                ops = k1_ops_per_query(n, d, r) * B
                byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
                op_ms = ops / FP32_FLOPS * 1e3
                row = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(byte_ms, op_ms),
                    bound_by="bytes" if byte_ms > op_ms else "operations",
                    library_ms=None,
                )
                log(f"K1 f32 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                    f"{nbytes} B, {ops} flop)")
    return row


def phase_k3(torch, train_sorted, queries, cand_count):
    from muygpys_torch.gpu import knn as K

    rows = {}
    lib_ms = time_ms(
        lambda: torch.topk(
            torch.cdist(queries, train_sorted), cand_count, dim=1,
            largest=False,
        ),
        reps=5,
    )
    log(f"K3 yardstick torch.cdist + torch.topk: {lib_ms:.4f} ms")
    for name, prep in (
        ("knn_candidates", K.prepare(train_sorted, queries, cand_count)),
        ("knn_candidates_pruned",
         K.prepare_pruned(train_sorted, queries, cand_count)),
    ):
        s1k, s2k = prep.candidates()
        torch.cuda.synchronize()
        s1p, s2p = K.knn_candidates_plain(
            prep.q, prep.qsq, prep.tT, prep.tsq, prep.bins, prep.train_tile,
            prep.query_tile, prep.chunk_mask, prep.lb, prep.ub,
        )
        equal = float(((s1k == s1p) & (s2k == s2p)).float().mean())
        ik, dk = K._merge_decode(s1k, s2k, cand_count, prep)
        ip, dp = K._merge_decode(s1p, s2p, cand_count, prep)
        same_idx = float(
            (torch.sort(ik, 1).values == torch.sort(ip, 1).values)
            .float().mean()
        )
        finite = torch.isfinite(dk) & torch.isfinite(dp)
        err = float((dk - dp)[finite].abs().max())
        log(f"K3 {name}: s1/s2 equal on {equal:.6f} of slots, index slots "
            f"agree {same_idx:.6f}, max_abs_err (decoded d2) {err:.3e}")
        # the kernel repeats the plain version's rounding order: keys are
        # bitwise equal, else candidate sets must agree on >= 99.9% of slots
        assert equal == 1.0 or same_idx >= 0.999, f"K3 {name} disagrees"
        ms = time_ms(prep.candidates)
        plain_ms = time_ms(
            lambda: K.knn_candidates_plain(
                prep.q, prep.qsq, prep.tT, prep.tsq, prep.bins,
                prep.train_tile, prep.query_tile, prep.chunk_mask,
                prep.lb, prep.ub,
            ),
            reps=5,
        )
        q_count, feat = prep.q.shape
        t_count = prep.tT.shape[1]
        if prep.lb is None:
            pairs = q_count * t_count
            extra = 0
        else:
            run = (prep.lb <= prep.ub[:, None]).sum().item()
            pairs = run * prep.query_tile * prep.train_tile
            extra = (prep.lb.numel() + prep.ub.numel()) * 4
        nbytes = (
            (q_count * (feat + 1) + t_count * (feat + 1)) * 4
            + 2 * q_count * prep.bins * 4 + extra
        )
        ops = pairs * (2 * feat + 3)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = ops / FP32_FLOPS * 1e3
        rows[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms > op_ms else "operations",
            library_ms=lib_ms,
        )
        log(f"K3 {name} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']};"
            f" {pairs} pairs visited of {q_count * t_count})")
    return rows


def serve(torch, server, requests):
    """Answer the requests; returns (means, vars, predictions per second)."""
    outs = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for req in requests:
        outs.append(server.predict(req))
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    count = sum(len(r) for r in requests)
    import numpy as np

    return (
        np.concatenate([o[0] for o in outs]),
        np.concatenate([o[1] for o in outs]),
        count / seconds,
    )


def device_trace(torch, server, requests):
    """Where the device time of the requests goes, from a profiler trace.

    Only device activities (kernels, copies) are summed, never the host ops
    that launched them, so no kernel counts twice; busy time is the union of
    their intervals.  The idle share divides it by the median wall time of
    the same requests without the profiler, which slows the host."""
    acts = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    # the first profiling session pays the tracer's start-up: discard it
    with torch.profiler.profile(activities=acts):
        server.predict(requests[2])
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for req in requests:
            server.predict(req)
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy_us, reach = 0.0, -math.inf
    by_name = {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        key = name.replace("(anonymous namespace)::", "").split("(")[0][:80]
        by_name[key] = by_name.get(key, 0.0) + (end - start)
    wall_ms = time_ms(
        lambda: [server.predict(r) for r in requests], reps=5, warmup=1
    )
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        device_busy_us=busy_us if spans else None,
        wall_us=wall_ms * 1e3,
        device_idle_share=1 - busy_us / (wall_ms * 1e3) if spans else None,
        device_activities=len(spans),
        top_device_us=top,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "muygpys_torch")):
        print("chip_smoke: muygpys_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import numpy as np

    from muygpys_torch import config
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu.knn import spatial_sort
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # headline data: uniform 2-D field, seed 1
    rng = np.random.default_rng(1)
    train = rng.uniform(size=(TRAIN, D)).astype(np.float32)
    targets = rng.standard_normal((TRAIN, 1)).astype(np.float32)
    queries = rng.uniform(size=(QUERIES + 8192 + 5000, D)).astype(np.float32)
    nbrs = NN_Wrapper(train, NN)
    exact_idx, _ = nbrs.get_nns(queries[:QUERIES])

    # 3. K1 on real neighborhoods of the headline set
    train_d = torch.as_tensor(train, device="cuda")
    targets_d = torch.as_tensor(targets, device="cuda")
    idx_d = torch.as_tensor(exact_idx, device="cuda")
    nf = train_d[idx_d].permute(1, 2, 0).contiguous()  # (n, d, B)
    q = torch.as_tensor(queries[:QUERIES], device="cuda").T.contiguous()
    y = targets_d[idx_d].permute(1, 2, 0).contiguous()
    rows = {"fused_predict_coords": phase_k1(torch, (nf, q, y))}

    # 4. K3 at the fused path's geometry on the Morton-sorted set
    perm = spatial_sort(train_d)
    train_sorted = train_d[perm].contiguous()
    cand_count = NN + 8
    rows.update(phase_k3(
        torch, train_sorted, torch.as_tensor(queries[:QUERIES], device="cuda"),
        cand_count,
    ))

    # 5. end to end
    model = muygps_from_arrays(
        length_scale=LS, noise=NOISE, scale=1.0, smoothness=NU
    )
    requests = [
        queries[:QUERIES], queries[QUERIES:QUERIES + 8192],
        queries[QUERIES + 8192:],
    ]
    config.update("ftype", 64)
    reference = FastServer(
        model, nbrs, train, targets, bucket=QUERIES, engine="reference"
    )
    config.update("ftype", 32)
    ref_outs = [reference.predict(r) for r in requests]
    m_ref = np.concatenate([o[0] for o in ref_outs])
    v_ref = np.concatenate([o[1] for o in ref_outs])
    all_q = np.concatenate(requests)

    # neighbour sets the fused path conditions on (K3 pruned + exact
    # re-rank), to hold it to the reference where they equal the exact ones
    from muygpys_torch.gpu.knn import knn_cuda_pruned
    from muygpys_torch.neighbors import _refine_knn

    q_all_d = torch.as_tensor(all_q, device="cuda")
    cand, _ = knn_cuda_pruned(train_sorted, q_all_d, cand_count)
    fused_idx, _ = _refine_knn(train_sorted, q_all_d, cand, NN)
    fused_sets = np.sort(perm[fused_idx].cpu().numpy(), 1)
    exact_sets = np.sort(nbrs.get_nns(all_q)[0], 1)
    same = (fused_sets == exact_sets).all(1)
    log(f"fused neighbour sets equal the exact ones on {same.mean():.6f} of "
        f"queries ({(fused_sets == exact_sets).mean():.6f} of slots)")
    assert same.mean() >= 0.98

    launches_by_path = {}
    e2e = {}
    for engine in ("fused", "kernel"):
        server = FastServer(
            model, nbrs, train, targets, bucket=QUERIES, engine=engine
        )
        server.predict(requests[2])  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        mean, var, rate = serve(torch, server, requests)
        launches_by_path[engine] = dict(_build.launches)
        assert mean.shape == (len(all_q), 1) and var.shape == (len(all_q),)
        assert np.isfinite(mean).all() and np.isfinite(var).all()
        mask = same if engine == "fused" else np.ones(len(all_q), bool)
        err_m = float(np.abs(mean - m_ref)[mask].max())
        err_v = float(np.abs(var - v_ref)[mask].max())
        e2e[engine] = dict(
            preds_per_sec=rate, mean_max_abs_err=err_m,
            var_max_abs_err=err_v, launches=launches_by_path[engine],
        )
        v_min = float(np.abs(v_ref)[mask].min())
        log(f"e2e {engine}: {rate:.1f} predictions/s over "
            f"{len(all_q)} queries in 3 requests; vs f64 reference on the "
            f"same exact neighbours: mean {err_m:.3e} (tol {MEAN_TOL_F32}), "
            f"var {err_v:.3e} (tol {VAR_TOL_F32}; reference var min "
            f"{v_min:.3e} median {float(np.median(v_ref)):.3e}); "
            f"launches {launches_by_path[engine]}")
        assert VAR_TOL_F32 <= 0.1 * v_min, "variance gate too loose"
        assert err_m <= MEAN_TOL_F32, f"e2e {engine} mean off: {err_m}"
        assert err_v <= VAR_TOL_F32, f"e2e {engine} var off: {err_v}"
        if engine == "fused":
            trace = device_trace(torch, server, requests)
            e2e[engine]["trace"] = trace
            log(f"e2e fused device trace: {json.dumps(trace)}")
    fused_launches = launches_by_path["fused"]
    assert fused_launches["fused_predict_coords"] > 0
    assert fused_launches["knn_candidates"] > 0
    assert fused_launches["knn_candidates_pruned"] > 0
    assert launches_by_path["kernel"]["fused_predict_coords"] > 0
    log("e2e: " + json.dumps(e2e))

    # 6. kernels line
    meta = {
        "fused_predict_coords": (
            "muygpys_torch/gpu/csrc/fused_predict.cu",
            "muygpys_tpu/pallas/fused_predict.py:373",
        ),
        "knn_candidates": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:217",
        ),
        "knn_candidates_pruned": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:451",
        ),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=fused_launches[name],
            paths={p: c[name] for p, c in launches_by_path.items()},
            **rows[name],
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
