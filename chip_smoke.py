#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (muygpys_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the serving and training paths (one
   nvcc per source, started together), report the seconds and the
   registers and spills of each kernel, design and instantiation;
3. K1 (fused coords solve) against its plain PyTorch version on the card at
   the serving shape (n=30, d=2, r=1, B=8192) for every closed form, RBF on
   F2 and a heteroscedastic case, in f32 and f64;
4. K3 (packed-key KNN candidates), unpruned and pruned, against its plain
   version at 50,000 x 8192, d=2, plus the cdist + topk yardstick;
5. serving end to end: FastServer(engine="fused") at the headline
   configuration (50k Morton-sorted training points, d=2, nn=30, bucket
   8192, Matern 3/2, ls 0.5, noise 1e-3, f32) answers three requests, one
   not a multiple of the bucket; the same with engine="kernel" over an
   exact NN_Wrapper; both held against the f64 reference engine on the same
   exact neighbours (mean and variance each against its own limit); a
   torch.profiler trace of the fused requests gives device time by kernel
   and the idle share;
6. K2 (fused LOO statistics and analytic derivatives) against its plain
   version at the training shape (n=30, B=2048) on real neighbourhoods of
   the 50k set: every closed form, RBF on F2, noise free on and off,
   heteroscedastic, anisotropic (d=2) and r=2, in f32 and f64, each row
   against its own limit, through the register design; one n=40 case
   through the shared-memory design; the design each case took; the
   headline timed through both designs and through the library yardstick
   (torch.linalg.cholesky + cholesky_solve + einsum);
7. training end to end at the training headline (the same 50k points with
   a smooth target field plus N(0, 0.1^2) noise, a LOO batch of 2048 from
   sample_batch, Matern 3/2, free length scale and noise, lool, f32):
   NN_Wrapper -> sample_batch -> make_train_tensors ->
   Fused_L_BFGS_B_optimize(engine="kernel") -> optimize_scale, held against
   the same chassis on the CPU in f64 (K2's plain version); a profiler
   trace of K2 objective evaluations;
8. serving the trained model: FastServer(engine="fused") against the f64
   reference engine with the same model;
9. general smoothness, K4 (the traced-nu surrogate, csrc/matern_nu.cuh)
   inside K1, K1b and K2: K1 under "gen" against its plain version at the
   serving shape for nu in {0.31, 1.2, 2.0 (the clamp zone), 4.8}, f32 and
   f64; K4 alone against scipy.special.kv through the f64 and f32 kernels on
   a t grid; K1b (the solve from distances) against its plain version,
   closed form, RBF and gen; K2 under "gen", a fixed and a free nu,
   isotropic and anisotropic, at the headline's length scale (every entry
   on K4's series branch) and at one near the neighbour spacing (entries on
   both branches), each row group (the d/dnu rows included) against its own
   limit, through the register design (the free-nu headline also timed
   through the shared-memory design);
10. the distance-tensor workflow: make_predict_tensors -> fused_predict_bl
   (K1b) on the first request; in f32 held against the f64 plain version on
   the same distance tensors, in f64 against the f64 reference engine;
11. serving nu = 1.2 at the serving headline through the fused engine,
   against the f64 reference engine (the exact Bessel path);
12. training a free smoothness at the training headline: length scale, noise
   and nu together (nu 1.2 in (0.31, 5)), lool, f32, through K2; K2's f64
   value and gradients at one point against the exact-Bessel lanes
   objective on the card; the objective reached against the lanes engine's
   (capped at 10 L-BFGS iterations, to keep the run short), both judged by
   the exact f64 objective; where the time of one evaluation
   goes (coefficient constructor, K2, epilogue); the trained model served;
13. K5 (the fused multi-output block solve of the lensing shear family)
   against its plain version on real shear blocks at the shear serving
   shape (B=2048, nn=30: m=90 for the 3-in/3-out kernel, m=60 for
   2-in/3-out) through the register design (m=60 in f64 through the
   shared-memory design) and at nn=8 (m=24, B=1000) through the
   shared-memory design, f32 and f64, through both entries (batch-last and
   frontend); a batch with one block made singular by duplicated rows
   through each design; m=90 timed through the shared-memory design too,
   in f32 and f64; the library yardstick (torch.linalg.cholesky + solve_triangular) and the
   lanes engine's eager block Cholesky, timed once;
14. shear serving end to end: the 50,000-point sky of
   scripts/shear_sky_demo.py (ShearKernel, ls 0.05, ShearNoise33 at 1e-3 of
   2/ls^4, nn=30, f32), FastServer(engine="kernel", bucket=2048) over an
   exact NN_Wrapper answers three requests (2048, 2048, 1000); mean
   (count, 3) and covariance (count, 3, 3) held against the lanes engine in
   f64 on the same neighbours; one request of ShearKernel2in3out; a
   profiler trace of the three requests;
15. shear training, then serving the trained model: a LOO batch of 2048,
   Fused_L_BFGS_B_optimize(loss="mse") with the length scale free, on the
   card in f32, held against the same chassis on the CPU in f64; one lool
   evaluation and gradient of the batched layout against the lanes layout
   in f64; the trained model served through K5;
16. the kernels line: one JSON object with every kernel's launches on its
   path, error against its plain version, times and bound; for K2 and K5
   each design's launches over the run (both must have run) and registers;
17. the last line: {"ok": true, "device": {...}}.

Kernel times are CUDA-event medians over back-to-back launches (time_ms);
for K2 and K5 also the kernel's own device time, each call queued behind
a device-side sleep (device_ms), which time_ms exceeds where a call's host
work outlasts the kernel; wall times are medians of single runs.  Bounds use the H100 SXM
data-sheet peaks (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor cores;
fp64 counted at the same rate, so an f64 bound is optimistic).
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
# general smoothness: the served order and the free-smoothness start value
# (away from the closed forms), its bounds, and the orders K4 is checked at
NU_GEN, NU_BOUNDS = 1.2, (0.31, 5.0)
GEN_NUS = (0.31, 1.2, 2.0, 4.8)
# a length scale near the neighbour spacing of the 50k set, for the K2 cases
# whose scaled distances straddle K4's series/tail split
LS_TAIL = 0.01
T0_GEN, NTAIL_GEN = 2.0, 40
# f32 posterior mean floor at noise 1e-3 (kernel-evaluation rounding, the
# bound bench.py records): within 5e-3 of the f64 reference
MEAN_TOL_F32 = 5e-3
# f32 posterior variance: 1 - zc.zc loses ~eps_f32 absolute (2.5e-7 against
# f64 at the headline), while the variances themselves are ~3e-5..1e-2; the
# gate sits 8x above that spread and must stay under a tenth of the smallest
# variance compared, so a zero or wrongly scaled variance fails
VAR_TOL_F32 = 2e-6

# the distance-tensor workflow in f64 against the f64 reference engine (the
# same distance assembly, so K1b's f64 limits against its plain version)
DISTS_F64_TOL = (1e-7, 1e-9)
# the same workflow in f32 against the f64 reference engine: the floor of the
# Gram-identity distance assembly in f32 (|a|^2 + |b|^2 - 2 a.b loses
# ~eps_f32 absolute on squared distances of ~2e-5 between neighbours of the
# 50k set), 1.6x and 2.2x the mean and variance spread measured on the H100
# (1.224e-2, 1.796e-6; PERF.md, Findings)
DISTS_F32_GRAM_FLOOR = (2e-2, 4e-6)

# training headline: LOO batch, start values and bounds of the free
# length scale and noise (tests/test_pallas_train.py's bounds)
TRAIN_BATCH = 2048
LS_BOUNDS, NOISE_BOUNDS = (0.01, 5.0), (1e-6, 1e-1)
# K2 against its plain version: each row group's limit as a fraction of
# the row's magnitude (the smallest value of the positive rows var and q,
# the largest |value| of the others).  f64: both orders are exact to
# ~1e-16 x the conditioning (measured <= 2.9e-11); f32: 7-10x the largest
# spread measured on the H100 (PERF.md, PR 2)
K2_REL = {
    "float64": dict.fromkeys(
        ("mean", "var", "q", "dls/mean", "dls/var", "dls/q", "dnoise/mean",
         "dnoise/var"), 1e-9,
    ),
    "float32": {
        "mean": 1e-3, "var": 5e-2, "q": 5e-2, "dls/mean": 5e-3,
        "dls/var": 5e-3, "dls/q": 5e-3, "dnoise/mean": 5e-2,
        "dnoise/var": 5e-3,
    },
}
# K2 under "gen" against its plain version, as above.  f64: the small
# branch's P + expm1 w^n Q cancellation costs another ~e^2 over a closed
# form (measured <= 3.3e-10).  f32: both sides read the same (truncated)
# coefficients, but that cancellation (~6e-6 relative on phi against ~1e-7
# for a closed form) makes the two rounding orders differ more; each row's
# limit is 5-10x the largest spread measured on the H100 at the headline's
# length scale (mean 5.8e-5, var 3.6e-3, q 1.1e-3, d/dls 4.0e-4, dnoise/mean
# 3.2e-3, dnoise/var 1.3e-4, d/dnu 3.9e-4; PERF.md, Findings)
K2_GEN_REL = {
    "float64": dict.fromkeys(
        ("mean", "var", "q", "dls/mean", "dls/var", "dls/q", "dnoise/mean",
         "dnoise/var", "dnu/mean", "dnu/var", "dnu/q"), 1e-8,
    ),
    "float32": {
        "mean": 5e-4, "var": 2e-2, "q": 1e-2, "dls/mean": 3e-3,
        "dls/var": 3e-3, "dls/q": 3e-3, "dnoise/mean": 2e-2,
        "dnoise/var": 1e-3, "dnu/mean": 3e-3, "dnu/var": 3e-3,
        "dnu/q": 3e-3,
    },
}
# the same in f32 at LS_TAIL: neighbours decorrelate (phi down to ~1e-3), the
# LOO variance nears its prior and every row loses digits; 4-7x the largest
# spread measured there (mean 4.3e-4, var 1.2e-2, q 7.8e-3, d/dls 1.5e-3,
# dnoise/mean under 3.2e-3, dnoise/var 2.5e-4, d/dnu 1.5e-3; PERF.md,
# Findings)
K2_GEN_REL_TAIL_F32 = {
    "mean": 2e-3, "var": 5e-2, "q": 5e-2, "dls/mean": 1e-2, "dls/var": 1e-2,
    "dls/q": 1e-2, "dnoise/mean": 2e-2, "dnoise/var": 2e-3, "dnu/mean": 1e-2,
    "dnu/var": 1e-2, "dnu/q": 1e-2,
}
# K4 against scipy's kv on a t grid, mixed error |got - want| / max(|want|,
# floor): tests/test_matern_nu.py's bounds (f64 1e-8 away from integers,
# 1e-6 at them where the 1e-7 clamp is the floor; f32 with the host constructor
# 4e-6)
K4_F64_TOL, K4_F64_TOL_INTEGER, K4_F32_TOL = 1e-8, 1e-6, 4e-6
# free-smoothness training: K2 in f64 against the exact-Bessel lanes
# objective at one point, and the objective reached against the lanes
# engine's, judged by the exact f64 objective (tests/test_pallas_train.py)
GEN_VALUE_RTOL, GEN_GRAD_RTOL, GEN_OBJECTIVE_RTOL = 1e-7, 1e-5, 5e-3
# the f64 objective at the card's optimum against the CPU f64 optimum's
OBJECTIVE_RTOL = 1e-3
# the card's f32 optimum against the CPU f64 optimum: 2x the spread measured
# on the H100 (length scale 1.0e-2 along the flat ridge, noise 2.9e-4;
# PERF.md, PR 2), under the length scale's 3.3e-2 from its start value;
# the same chassis in f64 on the card: tests/test_pallas_train.py's
# tolerances
F32_PARAM_RTOL = {"length_scale": 2e-2, "noise": 1e-2}
F64_PARAM_RTOL = {"length_scale": 1e-3, "noise": 1e-2}
# the exact-Bessel lanes optimization of the free-smoothness phase stops
# after this many L-BFGS iterations (it is a reference, not a path of the
# port; uncapped it took 19-26 iterations and 44-56 s on the H100, capped
# at 10 it came within 2.9e-6 of K2's optimum in 27-36 s)
LANES_REFERENCE_ITERATIONS = 10
# the lanes layout of the shear lool objective is checked on this many
# points of the batch: its autograd graph holds every step of the block
# Cholesky
SHEAR_LANES_BATCH = 512

# the lensing shear family: the serving batch and neighbour count of the JAX
# package's shear headline, the demo's length scale (it enters the kernel as
# the SQUARED RBF length scale) and its nugget, 1e-3 * 2 / ls^4; the sky of
# scripts/shear_sky_demo.py cut to the 50,000 points of the other headlines
SHEAR_BATCH, SHEAR_NN = 2048, 30
SHEAR_LS, SHEAR_LS_BOUNDS = 0.05, (0.005, 0.5)
SHEAR_NOISE = 1e-3 * 2.0 / SHEAR_LS**4
SHEAR_REQUESTS = (2048, 2048, 1000)
# K5 against its plain version on real shear blocks, mean and covariance
# each against its own limit, absolute.  The prior diagonal is 2/ls^2 = 800
# and the nugget 320; posterior means are ~0.1-1, posterior variances
# 11-13.  Each limit is ~10x the spread measured on the H100 (f32: mean
# 9.5e-7, covariance 1.2e-4, the rounding of S = zc^T zc, whose entries are
# of the prior's size; f64: 2.0e-15 and 3.4e-13, held at 1e-12 and 1e-10;
# PERF.md, Findings) and under a tenth of the quantity it guards
K5_TOL = {"float64": (1e-12, 1e-10), "float32": (1e-5, 1e-3)}
# the singular batch (unit-scale A A^T blocks with condition numbers ~10):
# the other blocks absolutely (measured 3.8e-6 in f32, 1.1e-14 in f64), the
# singular block relative to its own (huge) values (measured 2.8e-8, 2.2e-16)
K5_SINGULAR_OTHERS = {"float64": 1e-12, "float32": 5e-5}
K5_SINGULAR_REL = {"float64": 1e-12, "float32": 1e-6}
# shear serving in f32 through K5 against the lanes engine in f64 on the
# same neighbours, mean and covariance absolute, as multiples of the prior
# diagonal 2/ls^2 (the f32 rounding of S scales with it, and a trained
# length scale of 0.0072 raises it 48x against the fixed nugget): ~10x the
# spread measured on the H100 at ls 0.05 (mean 1.0e-6, covariance 1.5e-4 on
# a prior of 800) and 6-13x at the trained length scale (3.7e-5, 1.4e-2 on
# 38,400); PERF.md, Findings
SHEAR_MEAN_REL_F32, SHEAR_COV_REL_F32 = 1.25e-8, 2e-6
# shear training: tests/test_shear_objective.py's tolerance on the length
# scale, and the f64 objective at the card's optimum against the CPU's
SHEAR_LS_RTOL, SHEAR_OBJECTIVE_RTOL = 5e-3, 1e-3
# one lool evaluation, batched layout against lanes layout, f64
# (tests/test_shear_objective.py's tolerances)
SHEAR_LOOL_RTOL = (1e-9, 1e-7)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=20, warmup=3, trials=5):
    """CUDA-event time of one ``fn()`` in milliseconds: the median over
    ``trials`` of ``reps`` calls queued back to back between two events, so
    the host's launch overhead hides behind the device's work instead of
    being counted as device time (a single call between two events counts
    the wrapper's Python work whenever the device waits for it)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, reps=11):
    """Median device time in milliseconds of the work one ``fn()`` queues,
    whatever the host spends preparing it: each call is queued behind a
    device-side sleep that outlasts the host's Python work, so the events
    around it bracket the device's work alone.  ``time_ms`` counts the host
    instead wherever one call's Python work outlasts the kernel."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms of device time
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def ptxas_report(text):
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, keyed by the kernel's name and template arguments (f = float, d =
    double, then the compile-time sizes): e.g. ``fused_train_stats_regs_kernel
    f 1`` is the register design of K2 in f32 for one right-hand side."""
    import re

    out, kernel = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            found = re.search(r"\d+([a-z_]+?_kernel)I([fd])((?:Li\d+E)*)",
                              entry.group(1))
            kernel = (" ".join([found.group(1), found.group(2)]
                               + re.findall(r"Li(\d+)E", found.group(3)))
                      if found else entry.group(1)[:60])
            out[kernel] = {}
            continue
        if kernel is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out[kernel]["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[kernel]["registers"] = int(regs.group(1))
    return out


def k4_ops(counts, nt, need_dt=False, need_dnu=False):
    """Floating-point operations of K4 over elements counted by branch
    (``counts`` = elements with t <= 0, 0 < t <= T0, t > T0), exp and log
    counted as one: each element takes one branch.  Small branch: w, log,
    expm1, w^n, two 14-term Horner chains and the combination; its d/dt two
    13-term chains and 14 more; its d/dnu two 14-term chains and 6 more.
    Tail: the argument, an ``nt``-term Clenshaw recurrence (3 a term), exp;
    each derivative one more recurrence.  Plus t = coef[0] u."""
    _, small, tail = counts
    small_ops = 63 + (62 if need_dt else 0) + (58 if need_dnu else 0)
    tail_ops = (3 * nt + 5 + ((3 * nt + 3) if need_dt else 0)
                + ((3 * nt + 1) if need_dnu else 0))
    return small * (small_ops + 1) + tail * (tail_ops + 1)


def k4_branch_counts(t):
    """How many of the elements ``t`` take each branch of K4."""
    zero = int((t <= 0).sum())
    small = int(((t > 0) & (t <= T0_GEN)).sum())
    return zero, small, t.numel() - zero - small


def k1_ops_per_query(n, d, r, eval_ops=6.0, coords=True):
    """Floating-point operations of one K1 (or, without the coordinate
    assembly, K1b) query, exp counted as one.

    The symmetric K needs n(n+1)/2 kernel evaluations, kc another n, each
    ``eval_ops`` operations (6 for a closed form; under "gen" the mean of
    :func:`k4_ops` over this run's entries)."""
    m = n + 1 + r
    kernel_entries = n * (n + 1) // 2 + n
    assembly = kernel_entries * ((3 * d + 1 if coords else 1) + eval_ops)
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
                    lambda: fused_predict_coords_bl_plain(*args, **kw),
                    reps=3, trials=3,
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
        reps=3, trials=3,
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
            reps=3, trials=3,
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


def device_trace(torch, run):
    """Where the device time of ``run()`` goes, from a profiler trace.

    Only device activities (kernels, copies) are summed, never the host ops
    that launched them, so no kernel counts twice; busy time is the union of
    their intervals.  The idle share divides it by the median wall time of
    the same work without the profiler, which slows the host."""
    acts = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    # the first profiling session pays the tracer's start-up: discard it
    with torch.profiler.profile(activities=acts):
        run()
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
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
    wall_ms = time_ms(run, reps=1, warmup=1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        device_busy_us=busy_us if spans else None,
        wall_us=wall_ms * 1e3,
        device_idle_share=1 - busy_us / (wall_ms * 1e3) if spans else None,
        device_activities=len(spans),
        top_device_us=top,
    )


def k2_ops_per_point(n, d_feat, r, noise_free, eval_ops=9.0, nu_free=False):
    """Floating-point operations of one K2 point (exp and sqrt counted as
    one), the least the algorithm needs: K and its derivative fields are
    symmetric, so n(n+1)/2 + n kernel evaluations of ``eval_ops`` operations
    each (9 for a closed form's K and H; under "gen" the mean of
    :func:`k4_ops` over this run's entries, plus H and S).  A free nu adds
    one more group of contractions."""
    dd = d_feat or 1
    scale = 3 * d_feat + 1 if d_feat else 1  # scaled distance
    # K, H, the G fields
    evaluation = scale + eval_ops + (4 * dd if d_feat else 2)
    chol = sum((n - j) * 2 * j + (n - j) for j in range(n)) + 2 * n
    solves = 2 * (1 + r) * n * n  # forward + backward, 1 + r columns
    stats = 2 * n * (2 * r + 1)  # mean, var, q
    second = (chol + 2 * r * n * n + 2 * n * r) if noise_free else 0
    per_group = 2 * n * n + 4 * n * r + 4 * n + r * (2 * n * n + 2 * n)
    noise_rows = 2 * n * (r + 1)
    return ((n * (n + 1) // 2 + n) * evaluation + chol + solves + stats
            + second + (dd + nu_free) * per_group + noise_rows)


def k2_row_names(r, ls_keys, nu_free=False):
    names = [f"mean{k}" for k in range(r)] + ["var", "q"]
    for key in ls_keys:
        names += [f"d{key}/mean{k}" for k in range(r)]
        names += [f"d{key}/var", f"d{key}/q"]
    names += [f"dnoise/mean{k}" for k in range(r)] + ["dnoise/var"]
    if nu_free:
        names += [f"dnu/mean{k}" for k in range(r)] + ["dnu/var", "dnu/q"]
    return names


def k2_check_rows(out, ref, names, limits, worst, tname):
    """Each K2 row against its own limit, a fraction of the row's magnitude
    (the smallest value of the positive rows var and q, the largest |value|
    of the others).  Returns (largest error as a share of its limit, the
    row it is in, the rows over their limit)."""
    ratios, over = [], []
    for i, name in enumerate(names):
        err = float((out[i] - ref[i]).abs().max())
        positive = name in ("var", "q")
        mag = float(ref[i].abs().min() if positive else ref[i].abs().max())
        kind = "/".join(part.rstrip("0123456789") for part in name.split("/"))
        ratios.append(err / mag / limits[kind])
        key = f"{tname}/{kind}"
        worst[key] = max(worst.get(key, 0.0), err / mag)
        if err > limits[kind] * mag:
            over.append(f"{name}: {err:.3e} > {limits[kind]:.0e} x {mag:.3e}")
    top = max(ratios)
    return top, names[ratios.index(top)], over


def k2_library(torch, pw, cw, y, params):
    """K2's rows at the training headline (Matern 3/2, isotropic, noise
    free) through library calls on K formed elementwise:
    torch.linalg.cholesky + torch.cholesky_solve + einsum, batch first.  A
    yardstick of speed (no pivot floor); the port never calls it."""
    ls, noise, noise0 = (float(v) for v in params)
    n = pw.shape[0]
    s3 = math.sqrt(3.0)

    def k_and_g(u):
        e = torch.exp(-s3 * u)
        return (1.0 + s3 * u) * e, (3.0 / ls) * u * u * e

    def rows():
        K, G = k_and_g(pw.permute(2, 0, 1) / ls)  # (B, n, n)
        kc, gc = k_and_g(cw.T / ls)  # (B, n)
        Y = y.permute(2, 0, 1)  # (B, n, r)
        eye = torch.eye(n, dtype=pw.dtype, device=pw.device)
        L = torch.linalg.cholesky(K + noise * eye)
        X = torch.cholesky_solve(torch.cat([kc[..., None], Y], 2), L)
        a, b = X[..., 0], X[..., 1:]
        b0 = torch.cholesky_solve(Y, torch.linalg.cholesky(K + noise0 * eye))
        Ga = torch.einsum("bij,bj->bi", G, a)
        return torch.cat([
            torch.einsum("bn,bnr->rb", kc, b),
            (1.0 - torch.einsum("bn,bn->b", kc, a))[None],
            torch.einsum("bnr,bnr->b", Y, b0)[None],
            torch.einsum("bn,bnr->rb", gc - Ga, b),
            (-2.0 * (gc * a).sum(1) + (Ga * a).sum(1))[None],
            -torch.einsum("bir,bij,bjr->b", b0, G, b0)[None],
            -torch.einsum("bn,bnr->rb", a, b),
            (a * a).sum(1)[None],
        ])

    return rows


# launches of each K2 and K5 design in the checks against the plain versions
# (designs_ran adds them up), by "<kernel>/<design>"
CHECK_LAUNCHES: dict = {}


def designs_ran(counter, launch):
    """Run ``launch``; return its result and the designs of ``counter``
    ("fused_train_stats" or "multiout_solve") it launched, read from the
    per-design launch counts, and add those launches to CHECK_LAUNCHES."""
    from muygpys_torch.gpu import _build

    before = dict(_build.launches)
    result = launch()
    ran = set()
    for d in ("registers", "shared"):
        key = f"{counter}/{d}"
        if _build.launches[key] > before[key]:
            ran.add(d)
            CHECK_LAUNCHES[key] = (CHECK_LAUNCHES.get(key, 0)
                                   + _build.launches[key] - before[key])
    return result, ran


def phase_k2(torch, train_d, y_d, bi, bnn):
    """K2 against its plain version on real neighbourhoods of the 50k set,
    each row against its own limit, through the design the launcher takes
    (the register design at n = 30; one n = 40 case through the
    shared-memory design); returns the kernels-line numbers of the training
    headline case (f32, isotropic Matern 3/2, noise free)."""
    from muygpys_torch.gpu import fused_train as K2
    from muygpys_torch.gpu.fused_train import (
        fused_train_stats_bl,
        fused_train_stats_bl_plain,
    )

    bi = torch.as_tensor(bi, device="cuda")
    bnn = torch.as_tensor(bnn, device="cuda")
    # 40 nearest neighbours of the same batch points (themselves excluded)
    # for the case past the register design's 32 rows
    dist = torch.cdist(train_d[bi], train_d)
    dist[torch.arange(len(bi), device="cuda"), bi] = math.inf
    bnn40 = dist.topk(40, dim=1, largest=False).indices
    del dist

    def tensors(nbr_idx):
        nbrs = train_d[nbr_idx]  # (B, n, 2)
        diff_p = (nbrs[:, :, None, :] - nbrs[:, None, :, :]).permute(1, 2, 3, 0)
        diff_c = (train_d[bi][:, None, :] - nbrs).permute(1, 2, 0)
        y1 = y_d[nbr_idx].permute(1, 2, 0)  # (n, 1, B) smooth field
        return diff_p, diff_c, y1

    sets = {30: tensors(bnn), 40: tensors(bnn40)}
    n, B = sets[30][2].shape[0], sets[30][2].shape[2]
    gen = torch.Generator(device="cuda").manual_seed(5)
    noise_nn = torch.rand((n, B), generator=gen, device="cuda") * 1e-2 + 1e-4
    # (smoothness, metric_power, noise_free, r, anisotropic, heteroscedastic,
    # neighbours)
    cases = [
        (0.5, 1, False, 1, False, False, 30),
        (1.5, 1, True, 1, False, False, 30),  # the training headline
        (1.5, 1, False, 1, False, False, 30),
        (2.5, 1, True, 1, False, False, 30),
        (math.inf, 1, False, 1, False, False, 30),
        ("rbf", 2, True, 1, False, False, 30),
        (1.5, 1, False, 1, False, True, 30),
        (1.5, 1, True, 1, True, False, 30),
        (2.5, 1, True, 2, False, False, 30),
        (1.5, 1, True, 1, False, False, 40),  # the shared-memory design
    ]
    row = None
    worst = {}
    designs = {}
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype)[6:]
        limits = K2_REL[tname]
        assert max(limits.values()) <= 0.1, (
            "a K2 limit must stay under a tenth of its row"
        )
        for nu, power, noise_free, r, aniso, hetero, nn in cases:
            diff_p, diff_c, y1 = sets[nn]
            f2_p, f2_c = (diff_p**2).sum(2), (diff_c**2).sum(1)
            y2 = torch.cat([y1, torch.cos(3.0 * y1)], dim=1)  # r = 2
            if aniso:
                pw, cw, d_feat, ls = diff_p, diff_c, 2, [LS, 0.7]
            else:
                pw, cw, d_feat, ls = (
                    f2_p.sqrt() if power == 1 else f2_p,
                    f2_c.sqrt() if power == 1 else f2_c, 0, [LS],
                )
            params = torch.tensor(
                ls + [2 * NOISE if noise_free else NOISE, NOISE],
                dtype=dtype, device="cuda",
            )
            args = [t.to(dtype).contiguous() for t in
                    (pw, cw, y2 if r == 2 else y1)] + [params]
            nn_arg = noise_nn.to(dtype) if hetero else None
            kw = dict(smoothness=nu, metric_power=power,
                      noise_free=noise_free, d_feat=d_feat)
            out, ran = designs_ran("fused_train_stats", lambda: (
                fused_train_stats_bl(*args, noise_nn=nn_arg, **kw)))
            torch.cuda.synchronize()
            design = "registers" if nn <= 32 else "shared"
            assert ran == {design}, ran
            ref = fused_train_stats_bl_plain(*args, noise_nn=nn_arg, **kw)
            assert torch.isfinite(out).all(), "K2 gave a non-finite row"
            names = k2_row_names(
                r, ["ls0", "ls1"] if aniso else ["ls"]
            )
            top, top_row, over = k2_check_rows(
                out, ref, names, limits, worst, tname
            )
            label = (f"{tname} nu={nu} power={power} noise_free={noise_free} "
                     f"r={r} aniso={aniso} hetero={hetero} n={nn}")
            designs[label] = design
            log(f"K2 {label} ({design} design): largest error as a share of "
                f"its limit {top:.3f} (row {top_row})")
            assert not over, f"K2 disagrees with its plain version: {over}"
            headline = (dtype == torch.float32 and nu == NU and noise_free
                        and not aniso and r == 1 and nn == NN)
            if headline:
                ms = time_ms(lambda: fused_train_stats_bl(
                    *args, noise_nn=nn_arg, **kw))
                code = K2._smoothness_code(nu, None, power, False)

                def kept():
                    return K2._launch(
                        *args, nn_arg, None, code, power, noise_free, False,
                        d_feat, design="shared")

                kept_ms = time_ms(kept)
                dev_ms = device_ms(torch, lambda: fused_train_stats_bl(
                    *args, noise_nn=nn_arg, **kw))
                kept_dev_ms = device_ms(torch, kept)
                # the wrapper's host work a call: the host clock over 20
                # calls queued without waiting, median of 5
                host = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(20):
                        fused_train_stats_bl(*args, noise_nn=nn_arg, **kw)
                    host.append((time.perf_counter() - t0) * 50.0)
                torch.cuda.synchronize()
                host_ms = sorted(host)[2]
                plain_ms = time_ms(lambda: fused_train_stats_bl_plain(
                    *args, noise_nn=nn_arg, **kw), reps=3, trials=3)
                library = k2_library(torch, *args)
                lib_rows = library()
                lib_ms = time_ms(library, reps=5, trials=3)
                lib_off = float(((lib_rows - out).abs().amax(1)
                                 / ref.abs().amax(1)).max())
                C = out.shape[0]
                # pw is symmetric, as k2_ops_per_point counts it: the n(n+1)/2
                # rows i >= j suffice, each a contiguous run of B values
                nbytes = ((n * (n + 1) // 2 + n + n * r + C) * B + 3) * 4
                ops = k2_ops_per_point(n, 0, r, True) * B
                row = bound_row(
                    nbytes, ops, max_abs_err=float((out - ref).abs().max()),
                    ms=ms, plain_ms=plain_ms, kept_design_ms=kept_ms,
                    device_ms=dev_ms, kept_design_device_ms=kept_dev_ms,
                    wrapper_host_ms=host_ms,
                )
                row["library_ms"] = lib_ms
                log(f"K2 f32 time: register design {ms:.4f} ms ({dev_ms:.4f} "
                    f"ms on the device alone; the wrapper's host work "
                    f"{host_ms:.4f} ms a call), shared-memory design "
                    f"{kept_ms:.4f} ms ({kept_dev_ms:.4f}), plain "
                    f"{plain_ms:.4f} ms, "
                    f"library (torch.linalg.cholesky + cholesky_solve + "
                    f"einsum, no pivot floor) {lib_ms:.4f} ms, off the kernel "
                    f"by {lib_off:.3e} of the largest row value; bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes} "
                    f"B, {ops} flop)")
    log("K2 worst error/magnitude by row: " + json.dumps(worst))
    log("K2 design by case: " + json.dumps(designs))
    return row


def bound_row(nbytes, ops, **numbers):
    """A kernels-line row from the bytes the function must move and the
    operations it does."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_FLOPS * 1e3
    return dict(
        bound_ms=max(byte_ms, op_ms),
        bound_by="bytes" if byte_ms > op_ms else "operations",
        library_ms=None, **numbers,
    )


def host_coeffs(torch, nu, dtype):
    """K4 coefficients as a server builds them: on the host in f64, cast."""
    import numpy as np

    from muygpys_torch.gpu.matern_nu import matern_nu_coeffs_host

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return torch.as_tensor(matern_nu_coeffs_host(nu, np_dtype), device="cuda")


def phase_k1_gen(torch, knn_inputs, closed_ms):
    """K1 under "gen" (K4 inlined) against its plain version at the serving
    shape; returns the kernels-line row of the served order in f32."""
    from muygpys_torch.gpu.fused_predict import (
        fused_predict_coords_bl,
        fused_predict_coords_bl_plain,
        serve_tail_terms,
    )

    nf32, q32, y32 = knn_inputs
    n, d, B = nf32.shape
    r = y32.shape[1]
    # (mean, variance) limits.  f64: as K1's closed forms with another ~10x
    # for the small branch's cancellation; f32: the serving floors
    tol = {torch.float64: (1e-7, 1e-9),
           torch.float32: (MEAN_TOL_F32, VAR_TOL_F32)}
    row = None
    for dtype in (torch.float32, torch.float64):
        nf, q, y = (t.to(dtype).contiguous() for t in (nf32, q32, y32))
        params = torch.tensor([LS] * d + [NOISE], dtype=dtype, device="cuda")
        for nu in GEN_NUS:
            co = host_coeffs(torch, nu, dtype)
            args = (nf, q, y, params, None, co)
            mk, vk = fused_predict_coords_bl(*args, smoothness="gen")
            torch.cuda.synchronize()
            mp, vp = fused_predict_coords_bl_plain(*args, smoothness="gen")
            assert torch.isfinite(mk).all() and torch.isfinite(vk).all()
            err_m = float((mk - mp).abs().max())
            err_v = float((vk - vp).abs().max())
            tol_m, tol_v = tol[dtype]
            v_min = float(vp.abs().min())
            log(f"K1 gen {str(dtype)[6:]} nu={nu}: mean max_abs_err="
                f"{err_m:.3e} (tol {tol_m:.0e}), var max_abs_err={err_v:.3e} "
                f"(tol {tol_v:.0e}; var min {v_min:.3e})")
            assert tol_v <= 0.1 * v_min, "variance gate too loose"
            assert err_m <= tol_m, f"K1 gen mean disagrees: {err_m}"
            assert err_v <= tol_v, f"K1 gen var disagrees: {err_v}"
            if dtype == torch.float32 and nu == NU_GEN:
                ms = time_ms(lambda: fused_predict_coords_bl(
                    *args, smoothness="gen"))
                plain_ms = time_ms(lambda: fused_predict_coords_bl_plain(
                    *args, smoothness="gen"), reps=3, trials=3)
                # K4's work by branch over the entries the function needs:
                # the upper triangle of K with its diagonal, and kc
                x = nf / LS
                iu = torch.triu_indices(n, n, device="cuda")
                up = (x[iu[0]] - x[iu[1]]).pow(2).sum(1).sqrt()
                uc = (x - (q / LS)[None]).pow(2).sum(1).sqrt()
                counts = k4_branch_counts(co[0] * torch.cat([up, uc]))
                entries = (n * (n + 1) // 2 + n) * B
                eval_ops = k4_ops(counts, serve_tail_terms(dtype)) / entries
                nbytes = ((n * d + d + n * r + r + 1) * B + d + 1 + 73) * 4
                ops = k1_ops_per_query(n, d, r, eval_ops) * B
                # K4 has no launch of its own: the difference to the closed
                # form over the n^2 + n elements a query evaluates
                k4_ns = (ms - closed_ms) * 1e6 / ((n * n + n) * B)
                row = bound_row(
                    nbytes, ops, max_abs_err=max(err_m, err_v), ms=ms,
                    plain_ms=plain_ms, k4_ns_per_element=k4_ns,
                    k4_branches=dict(zip(("zero", "small", "tail"), counts)),
                )
                log(f"K1 gen f32 time: kernel {ms:.4f} ms (closed form "
                    f"{closed_ms:.4f} ms: K4 costs {k4_ns:.4f} ns per "
                    f"element), plain {plain_ms:.4f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes} "
                    f"B, {ops:.0f} flop; entries by branch {counts})")
    return row


def phase_k4_scipy(torch):
    """K4 alone against scipy.special.kv on a t grid, through the kernel:
    K1b with one neighbor, unit length scale and no noise returns
    mean = phi(t) . 1 for y = 1.  f64 with the tensor constructor (what f64
    training evaluates), f32 with the host constructor (what a server
    evaluates), as tests/test_matern_nu.py certifies them."""
    import numpy as np
    import scipy.special

    from muygpys_torch.gpu.fused_predict import fused_predict_bl
    from muygpys_torch.gpu.matern_nu import matern_nu_coeffs

    ts = np.concatenate(
        [[0.0], np.logspace(-3, np.log10(41.9), 120), [45.0, 80.0]]
    )
    worst = {}
    for nu in GEN_NUS + (0.05, 0.5, 1.0, 3.7, 10.0):
        with np.errstate(all="ignore"):
            want = (2.0 ** (1 - nu) / scipy.special.gamma(nu) * ts**nu
                    * scipy.special.kv(nu, ts))
        want = np.where(ts <= 0, 1.0, want)
        for dtype, floor in ((torch.float64, 1e-6), (torch.float32, 1e-4)):
            if dtype == torch.float64:
                co = matern_nu_coeffs(torch.tensor(nu, dtype=dtype)).cuda()
            else:
                co = host_coeffs(torch, nu, dtype)
            cw = torch.as_tensor(ts / math.sqrt(2 * nu), dtype=dtype,
                                 device="cuda")[None, :]
            B = cw.shape[1]
            zeros = torch.zeros((1, 1, B), dtype=dtype, device="cuda")
            phi, _ = fused_predict_bl(
                zeros, cw, torch.ones_like(zeros),
                torch.tensor([1.0, 0.0], dtype=dtype, device="cuda"), co,
                smoothness="gen",
            )
            got = phi[0].double().cpu().numpy()
            assert np.isfinite(got).all() and got[0] == 1.0
            mixed = np.abs(got - want) / np.maximum(np.abs(want), floor)
            if dtype == torch.float32:
                err, limit = float(mixed.max()), K4_F32_TOL
            else:
                # beyond TMAX = 42 the tail extrapolates with e^{-t} decay
                # and phi < 4e-11: held absolutely there
                dom = ts <= 42.0
                assert np.abs(got - want)[~dom].max() < 1e-10
                err = float(mixed[dom].max())
                limit = K4_F64_TOL_INTEGER if nu == round(nu) else K4_F64_TOL
            key = str(dtype)[6:]
            worst[key] = max(worst.get(key, 0.0), err / limit)
            log(f"K4 {key} nu={nu}: mixed error against scipy kv "
                f"{err:.3e} (limit {limit:.0e}) on {B} points, t in [0, 80]")
            assert err <= limit, f"K4 is off scipy's kv at nu={nu}: {err}"
    return worst


def phase_k1b(torch, knn_inputs):
    """K1b (the solve from distances) against its plain version at the
    serving shape, on the distances of the same neighborhoods."""
    from muygpys_torch.gpu.fused_predict import (
        fused_predict_bl,
        fused_predict_bl_plain,
        serve_tail_terms,
    )

    nf32, q32, y32 = knn_inputs
    n, d, B = nf32.shape
    r = y32.shape[1]
    nf64, q64 = nf32.double(), q32.double()
    f2_p = (nf64[:, None] - nf64[None, :]).pow(2).sum(2)  # (n, n, B)
    f2_c = (nf64 - q64[None]).pow(2).sum(1)  # (n, B)
    tol = {torch.float64: (1e-7, 1e-9),
           torch.float32: (MEAN_TOL_F32, VAR_TOL_F32)}
    row = None
    for dtype in (torch.float32, torch.float64):
        y = y32.to(dtype).contiguous()
        params = torch.tensor([LS, NOISE], dtype=dtype, device="cuda")
        for nu, power in ((0.5, 1), (NU, 1), (2.5, 1), (math.inf, 1),
                          ("rbf", 2), (0.31, 1), (NU_GEN, 1), (4.8, 1)):
            gen = nu in GEN_NUS
            pw = (f2_p.sqrt() if power == 1 else f2_p).to(dtype).contiguous()
            cw = (f2_c.sqrt() if power == 1 else f2_c).to(dtype).contiguous()
            co = host_coeffs(torch, nu, dtype) if gen else None
            args = (pw, cw, y, params, co)
            kw = dict(smoothness="gen" if gen else nu, metric_power=power)
            mk, vk = fused_predict_bl(*args, **kw)
            torch.cuda.synchronize()
            mp, vp = fused_predict_bl_plain(*args, **kw)
            assert torch.isfinite(mk).all() and torch.isfinite(vk).all()
            err_m = float((mk - mp).abs().max())
            err_v = float((vk - vp).abs().max())
            tol_m, tol_v = tol[dtype]
            v_min = float(vp.abs().min())
            log(f"K1b {str(dtype)[6:]} nu={nu} power={power}: mean "
                f"max_abs_err={err_m:.3e} (tol {tol_m:.0e}), var "
                f"max_abs_err={err_v:.3e} (tol {tol_v:.0e}; var min "
                f"{v_min:.3e})")
            assert tol_v <= 0.1 * v_min, "variance gate too loose"
            assert err_m <= tol_m, f"K1b mean disagrees: {err_m}"
            assert err_v <= tol_v, f"K1b var disagrees: {err_v}"
            if dtype == torch.float32 and nu in (NU, NU_GEN):
                ms = time_ms(lambda: fused_predict_bl(*args, **kw))
                plain_ms = time_ms(
                    lambda: fused_predict_bl_plain(*args, **kw),
                    reps=3, trials=3,
                )
                entries = (n * (n + 1) // 2 + n) * B
                if gen:
                    iu = torch.triu_indices(n, n, device="cuda")
                    u = torch.cat([pw[iu[0], iu[1]], cw]) / LS
                    eval_ops = k4_ops(
                        k4_branch_counts(co[0] * u), serve_tail_terms(dtype)
                    ) / entries
                else:
                    eval_ops = 6.0
                # pw is symmetric: the n(n+1)/2 rows i >= j suffice
                nbytes = ((n * (n + 1) // 2 + n + n * r + r + 1) * B + 2
                          + (73 if gen else 0)) * 4
                ops = k1_ops_per_query(n, d, r, eval_ops, coords=False) * B
                numbers = bound_row(
                    nbytes, ops, max_abs_err=max(err_m, err_v), ms=ms,
                    plain_ms=plain_ms,
                )
                log(f"K1b f32 nu={nu} time: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {numbers['bound_ms']:.4f} ms "
                    f"({numbers['bound_by']}; {nbytes} B, {ops:.0f} flop)")
                if gen:
                    row["gen_ms"] = ms
                    row["gen_bound_ms"] = numbers["bound_ms"]
                else:
                    row = numbers
    return row


def phase_k2_gen(torch, train_d, y_d, bi, bnn):
    """K2 under "gen" against its plain version on the training batch's
    neighbourhoods, fixed and free nu, isotropic and anisotropic; returns
    the kernels-line row of the free-smoothness training headline (f32,
    isotropic, noise free, nu = 1.2)."""
    from muygpys_torch.gpu import fused_train as K2
    from muygpys_torch.gpu.fused_train import (
        fused_train_stats_bl,
        fused_train_stats_bl_plain,
        train_tail_terms,
    )
    from muygpys_torch.gpu.matern_nu import matern_nu_coeffs

    bi = torch.as_tensor(bi, device="cuda")
    bnn = torch.as_tensor(bnn, device="cuda")
    nbrs = train_d[bnn]
    diff_p = (nbrs[:, :, None, :] - nbrs[:, None, :, :]).permute(1, 2, 3, 0)
    diff_c = (train_d[bi][:, None, :] - nbrs).permute(1, 2, 0)
    l2_p, l2_c = (diff_p**2).sum(2).sqrt(), (diff_c**2).sum(1).sqrt()
    y1 = y_d[bnn].permute(1, 2, 0)
    n, B = y1.shape[0], y1.shape[2]
    r = 1
    # (nu, free nu, noise_free, anisotropic, length scale)
    cases = [
        (NU_GEN, False, True, False, LS),
        (NU_GEN, True, True, False, LS),  # the free-smoothness headline
        (0.31, True, False, True, LS),
        (4.8, True, True, True, LS),
        (2.0, True, True, False, LS),  # the clamp zone
        # at the headline's length scale every t = sqrt(2 nu) d / ls lies
        # under T0 (the series branch); a length scale near the neighbour
        # spacing sends entries through the tail branch and its derivatives
        (NU_GEN, True, True, False, LS_TAIL),
        (4.8, True, False, True, LS_TAIL),
    ]
    row = None
    worst = {}
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype)[6:]
        for nu, free, noise_free, aniso, ls0 in cases:
            limits = dict(K2_GEN_REL[tname])
            if dtype == torch.float32 and ls0 == LS_TAIL:
                limits = dict(K2_GEN_REL_TAIL_F32)
            if dtype == torch.float64 and nu == round(nu):
                # at an exact integer the f64 clamp leaves mu = 1e-7 and the
                # 1/mu-sized terms cancel to ~1e-16 / 1e-7 relative
                limits = dict.fromkeys(limits, 1e-5)
            assert max(limits.values()) <= 0.1
            if aniso:
                pw, cw, d_feat, ls = diff_p, diff_c, 2, [ls0, 1.4 * ls0]
            else:
                pw, cw, d_feat, ls = l2_p, l2_c, 0, [ls0]
            params = torch.tensor(
                ls + [2 * NOISE if noise_free else NOISE, NOISE],
                dtype=dtype, device="cuda",
            )
            # as the fused objective builds them: on the card, in the
            # data's dtype
            co = matern_nu_coeffs(
                torch.tensor(nu, dtype=dtype, device="cuda"), need_dnu=free
            )
            args = [t.to(dtype).contiguous() for t in (pw, cw, y1)] + [params]
            kw = dict(gen_coeffs=co, smoothness="gen", noise_free=noise_free,
                      smoothness_free=free, d_feat=d_feat)
            out, ran = designs_ran(
                "fused_train_stats", lambda: fused_train_stats_bl(*args, **kw))
            torch.cuda.synchronize()
            design = "registers"
            assert ran == {design}, ran
            ref = fused_train_stats_bl_plain(*args, **kw)
            assert torch.isfinite(out).all(), "K2 gen gave a non-finite row"
            names = k2_row_names(r, ["ls0", "ls1"] if aniso else ["ls"], free)
            assert len(names) == out.shape[0]
            top, top_row, over = k2_check_rows(
                out, ref, names, limits, worst, tname
            )
            branches = k4_branch_counts(
                co[0].to(dtype) * (l2_p.to(dtype) / ls0)
            )
            log(f"K2 gen {tname} nu={nu} free={free} noise_free={noise_free} "
                f"aniso={aniso} ls={ls0} ({design} design): largest error as "
                f"a share of its "
                f"limit {top:.3f} (row {top_row}); pairwise entries by "
                f"branch (zero, series, tail) {branches}")
            assert not over, f"K2 gen disagrees with its plain version: {over}"
            if ls0 == LS_TAIL:
                assert branches[1] > 0 and branches[2] > 0, (
                    "the tail case must exercise both branches"
                )
            if (dtype == torch.float32 and nu == NU_GEN and free
                    and not aniso and ls0 == LS):
                ms = time_ms(lambda: fused_train_stats_bl(*args, **kw))
                code = K2._smoothness_code("gen", co, 1, True)
                kept_ms = time_ms(lambda: K2._launch(
                    *args, None, co, code, 1, noise_free, True, d_feat,
                    design="shared"))
                dev_ms = device_ms(torch, lambda: fused_train_stats_bl(
                    *args, **kw))
                plain_ms = time_ms(lambda: fused_train_stats_bl_plain(
                    *args, **kw), reps=3, trials=3)
                iu = torch.triu_indices(n, n, device="cuda")
                u = torch.cat([args[0][iu[0], iu[1]], args[1]]) / LS
                counts = k4_branch_counts(co[0] * u)
                entries = (n * (n + 1) // 2 + n) * B
                # K4 with both derivatives, then H = t dphi/dt and
                # S = dphi/dnu + coef[4] H
                eval_ops = k4_ops(
                    counts, train_tail_terms(dtype), True, True
                ) / entries + 3
                C = out.shape[0]
                nbytes = ((n * (n + 1) // 2 + n + n * r + C) * B + 3 + 207) * 4
                ops = k2_ops_per_point(n, 0, r, True, eval_ops, True) * B
                row = bound_row(
                    nbytes, ops, max_abs_err=float((out - ref).abs().max()),
                    ms=ms, plain_ms=plain_ms, kept_design_ms=kept_ms,
                    device_ms=dev_ms,
                    k4_branches=dict(zip(("zero", "small", "tail"), counts)),
                )
                log(f"K2 gen f32 time: register design {ms:.4f} ms "
                    f"({dev_ms:.4f} ms on the device alone), "
                    f"shared-memory design {kept_ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                    f"({row['bound_by']}; {nbytes} B, {ops:.0f} flop; "
                    f"entries by branch {counts})")
    log("K2 gen worst error/magnitude by row: " + json.dumps(worst))
    return row


def train_model():
    """The training headline's model, still to be trained."""
    from muygpys_torch.convert import muygps_from_arrays

    return muygps_from_arrays(
        length_scale=LS, length_scale_bounds=LS_BOUNDS, noise=NOISE,
        noise_bounds=NOISE_BOUNDS, smoothness=NU, scale="analytic",
    )


def phase_train(torch, train, y_train, nbrs, bi, bnn):
    """Training end to end on the card, held against the same chassis on
    the CPU in f64; returns the trained model and the phase's numbers."""
    import contextlib
    import io
    import re

    from muygpys_torch.convert import arrays_from_muygps
    from muygpys_torch.gpu import _build
    from muygpys_torch.optimize import Fused_L_BFGS_B_optimize
    from muygpys_torch.optimize.fused_objective import (
        make_fused_train_objective,
    )

    model = train_model()
    train_d = torch.as_tensor(train, device="cuda")
    y_d = torch.as_tensor(y_train, dtype=torch.float32, device="cuda")
    # warm-up, outside the counted run: a process's first evaluation loads
    # the epilogue's PyTorch kernels and starts autograd's device thread,
    # and its first optimization imports scipy.optimize (~1.5 s)
    import scipy.optimize  # noqa: F401

    cw, pw, bt, bnt = model.make_train_tensors(bi, bnn, train_d, y_d)
    make_fused_train_objective(model, bt, bnt, cw, pw)[0]({})
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    cw, pw, bt, bnt = model.make_train_tensors(bi, bnn, train_d, y_d)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # objective evaluations, counted apart from K2's launch counter: the
    # probe at x0 and scipy's nfev, from the chassis's verbose report
    iters, report = [], io.StringIO()
    with contextlib.redirect_stdout(report):
        trained = Fused_L_BFGS_B_optimize(
            model, bt, bnt, cw, pw, engine="kernel", verbose=True,
            callback=lambda xk: iters.append(1),
        )
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trained.optimize_scale(pw, bnt)
    torch.cuda.synchronize()
    wall, opt_s = time.perf_counter() - t0, t2 - t1
    launches = dict(_build.launches)
    evals = 1 + int(re.search(r"\bnfev:\s*(\d+)", report.getvalue())[1])
    vals = arrays_from_muygps(trained)
    log(f"train (card, f32): length_scale {vals['length_scale']!r}, noise "
        f"{vals['noise']!r}, sigma^2 {vals['scale']!r}; {len(iters)} L-BFGS "
        f"iterations, {evals} objective evaluations, "
        f"{launches['fused_train_stats']} K2 launches; "
        f"Fused_L_BFGS_B_optimize {opt_s:.4f} s = {evals / opt_s:.1f} "
        f"evaluations/s; {wall:.4f} s with make_train_tensors and "
        "optimize_scale")
    assert evals > len(iters) and launches["fused_train_stats"] >= evals, (
        "K2 was not launched for every objective evaluation"
    )
    for key, (lo, hi) in (("length_scale", LS_BOUNDS),
                          ("noise", NOISE_BOUNDS)):
        assert lo < vals[key] < hi, f"trained {key} {vals[key]} at a bound"
        # the bijector keeps values inside; "at a bound" means within 1e-6
        # of the interval width of an end
        assert min(vals[key] - lo, hi - vals[key]) > 1e-6 * (hi - lo), (
            f"trained {key} {vals[key]} ran to a bound"
        )

    # the same chassis on the CPU in f64 (K2's plain version)
    train64 = torch.as_tensor(train, dtype=torch.float64)
    y64 = torch.as_tensor(y_train, dtype=torch.float64)
    cw64, pw64, bt64, bnt64 = train_model().make_train_tensors(
        bi, bnn, train64, y64
    )
    t0 = time.perf_counter()
    ref = Fused_L_BFGS_B_optimize(
        train_model(), bt64, bnt64, cw64, pw64, engine="kernel", device="cpu"
    )
    cpu_s = time.perf_counter() - t0
    ref_vals = arrays_from_muygps(ref)
    obj64, _ = make_fused_train_objective(
        train_model(), bt64, bnt64, cw64, pw64, device="cpu"
    )

    def f64_objective(v):
        return float(obj64({"length_scale": v["length_scale"],
                            "noise": v["noise"]})[0])

    v_card, v_cpu = f64_objective(vals), f64_objective(ref_vals)
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    log(f"train (CPU, f64, plain K2, {cpu_s:.1f} s): length_scale "
        f"{ref_vals['length_scale']!r}, noise {ref_vals['noise']!r}; f64 "
        f"objective at the card's optimum {v_card!r}, at the CPU's "
        f"{v_cpu!r}: relative difference {rel:.3e} (limit "
        f"{OBJECTIVE_RTOL:.0e})")
    assert rel <= OBJECTIVE_RTOL, "the card's optimum is not the f64 one"
    # how flat the f64 objective is along the length scale: the card's
    # length scale with the CPU optimum's noise
    v_ridge = f64_objective(dict(ref_vals, length_scale=vals["length_scale"]))
    ridge = abs(v_ridge - v_cpu) / abs(v_cpu)
    log(f"train: the card's f32 length scale alone moves the f64 objective "
        f"{ridge:.3e} relative (the objective is flat along the length "
        "scale near its optimum, and f32 rounding moves L-BFGS-B's stopping "
        "point along that ridge)")
    # the same chassis in f64 on the card: K2's f64 build against its plain
    # version, optimum against optimum
    f64_launches = _build.launches["fused_train_stats"]
    card64 = arrays_from_muygps(Fused_L_BFGS_B_optimize(
        train_model(), *(t.cuda() for t in (bt64, bnt64, cw64, pw64)),
        engine="kernel",
    ))
    assert _build.launches["fused_train_stats"] > f64_launches
    param_rel = {}
    for label, got, limits in (("f32", vals, F32_PARAM_RTOL),
                               ("f64", card64, F64_PARAM_RTOL)):
        for key, limit in limits.items():
            err = abs(got[key] / ref_vals[key] - 1)
            param_rel[f"{label}/{key}"] = err
            log(f"train: card {label} {key} {got[key]!r} against the CPU f64 "
                f"optimum: relative {err:.3e} (limit {limit:.0e})")
            assert err <= limit, (
                f"the card's {label} {key} is not at the CPU f64 optimum"
            )
    # the f32 gate sees a length scale that never left its start value
    assert abs(LS / ref_vals["length_scale"] - 1) > (
        F32_PARAM_RTOL["length_scale"]
    )

    # where the time of a K2 objective evaluation goes
    obj32, names = make_fused_train_objective(trained, bt, bnt, cw, pw)
    point = {n: vals[n] for n in names}
    trace = device_trace(torch, lambda: [obj32(point) for _ in range(5)])
    log(f"train: device trace of 5 objective evaluations: "
        f"{json.dumps(trace)}; unprofiled, "
        f"{5e6 / trace['wall_us']:.1f} evaluations/s")
    return trained, dict(
        length_scale=vals["length_scale"], noise=vals["noise"],
        scale=vals["scale"], iterations=len(iters), evaluations=evals,
        optimize_s=opt_s, evaluations_per_s=evals / opt_s, wall_s=wall,
        steady_evaluations_per_s=5e6 / trace["wall_us"],
        cpu_f64=dict(length_scale=ref_vals["length_scale"],
                     noise=ref_vals["noise"], seconds=cpu_s),
        objective_f64=dict(card=v_card, cpu=v_cpu, relative=rel,
                           length_scale_alone=ridge),
        card_f64=dict(length_scale=card64["length_scale"],
                      noise=card64["noise"]),
        parameters_relative=param_rel,
        launches=launches, trace=trace,
    )


def free_nu_model():
    """The free-smoothness training headline's model: length scale, noise
    and smoothness to be trained together."""
    from muygpys_torch.convert import muygps_from_arrays

    return muygps_from_arrays(
        length_scale=LS, length_scale_bounds=LS_BOUNDS, noise=NOISE,
        noise_bounds=NOISE_BOUNDS, smoothness=NU_GEN,
        smoothness_bounds=NU_BOUNDS, scale="analytic",
    )


def wall_ms(torch, fn, reps=5):
    """Median host-clock milliseconds of ``fn()`` ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_train_free_nu(torch, train, y_train, bi, bnn, k2_gen_ms):
    """Free-smoothness training end to end on the card through K2 (f32),
    held to the exact-Bessel lanes objective; returns the trained model and
    the phase's numbers."""
    import contextlib
    import io
    import re

    from muygpys_torch.convert import arrays_from_muygps
    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu.matern_nu import matern_nu_coeffs
    from muygpys_torch.optimize import (
        Fused_L_BFGS_B_optimize,
        make_fast_loo_objective,
    )
    from muygpys_torch.optimize.fused_objective import (
        make_fused_train_objective,
    )

    bounds = {"length_scale": LS_BOUNDS, "noise": NOISE_BOUNDS,
              "smoothness": NU_BOUNDS}
    model = free_nu_model()
    train_d = torch.as_tensor(train, device="cuda")
    y_d = torch.as_tensor(y_train, dtype=torch.float32, device="cuda")
    cw, pw, bt, bnt = model.make_train_tensors(bi, bnn, train_d, y_d)
    make_fused_train_objective(model, bt, bnt, cw, pw)[0]({})  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    iters, report = [], io.StringIO()
    with contextlib.redirect_stdout(report):
        trained = Fused_L_BFGS_B_optimize(
            model, bt, bnt, cw, pw, engine="kernel", verbose=True,
            callback=lambda xk: iters.append(1),
        )
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    trained.optimize_scale(pw, bnt)
    launches = dict(_build.launches)
    evals = 1 + int(re.search(r"\bnfev:\s*(\d+)", report.getvalue())[1])
    vals = arrays_from_muygps(trained)
    log(f"train free nu (card, f32): length_scale {vals['length_scale']!r}, "
        f"noise {vals['noise']!r}, smoothness {vals['smoothness']!r}, "
        f"sigma^2 {vals['scale']!r}; {len(iters)} L-BFGS iterations, {evals} "
        f"objective evaluations, {launches['fused_train_stats']} K2 "
        f"launches; Fused_L_BFGS_B_optimize {opt_s:.4f} s = "
        f"{evals / opt_s:.1f} evaluations/s")
    assert evals > len(iters) and launches["fused_train_stats"] >= evals, (
        "K2 was not launched for every objective evaluation"
    )
    for key, (lo, hi) in bounds.items():
        assert min(vals[key] - lo, hi - vals[key]) > 1e-6 * (hi - lo), (
            f"trained {key} {vals[key]} ran to a bound"
        )
    moved = {k: abs(vals[k] / v0 - 1) for k, v0 in
             (("length_scale", LS), ("noise", NOISE), ("smoothness", NU_GEN))}
    assert max(moved.values()) > 1e-2, f"no parameter left its start: {moved}"

    # K2 in f64 against the exact-Bessel lanes objective on the card, at one
    # point away from the start and from the optimum
    train64 = torch.as_tensor(train, dtype=torch.float64, device="cuda")
    y64 = torch.as_tensor(y_train, dtype=torch.float64, device="cuda")
    cw64, pw64, bt64, bnt64 = free_nu_model().make_train_tensors(
        bi, bnn, train64, y64
    )
    data64 = (bt64, bnt64, cw64, pw64)
    point = {"length_scale": 0.4, "noise": 2e-3, "smoothness": 1.81}
    k2_f64, names = make_fused_train_objective(free_nu_model(), *data64)
    lanes64, _ = make_fast_loo_objective(free_nu_model(), *data64)
    before = _build.launches["fused_train_stats"]
    v_k2, g_k2 = k2_f64(point)
    assert _build.launches["fused_train_stats"] == before + 1
    theta = {k: torch.tensor(v, dtype=torch.float64, device="cuda",
                             requires_grad=True) for k, v in point.items()}
    v_exact = lanes64(theta)
    v_exact.backward()
    rel_v = abs(float(v_k2) / float(v_exact.detach()) - 1)
    rel_g = {k: abs(float(g_k2[k]) / float(theta[k].grad) - 1) for k in names}
    log(f"train free nu: K2 f64 against the exact-Bessel lanes objective at "
        f"{point}: value {float(v_k2)!r} vs {float(v_exact)!r} (relative "
        f"{rel_v:.3e}, limit {GEN_VALUE_RTOL:.0e}); gradients relative "
        f"{json.dumps(rel_g)} (limit {GEN_GRAD_RTOL:.0e})")
    assert rel_v <= GEN_VALUE_RTOL, "K2 gen value is off the exact objective"
    assert max(rel_g.values()) <= GEN_GRAD_RTOL, (
        "K2 gen gradient is off the exact objective"
    )

    # the lanes engine (exact Bessel, autograd) on the card in f64, capped
    # at LANES_REFERENCE_ITERATIONS L-BFGS iterations (its evaluations are
    # bound by the host's dispatch, ~0.8 s each whatever the batch); both
    # optima judged by the exact f64 objective
    t0 = time.perf_counter()
    lanes_vals = arrays_from_muygps(Fused_L_BFGS_B_optimize(
        free_nu_model(), *data64, engine="lanes",
        options=dict(maxiter=LANES_REFERENCE_ITERATIONS),
    ))
    lanes_s = time.perf_counter() - t0

    def exact(v):
        with torch.no_grad():
            return float(lanes64({k: v[k] for k in names}))

    v_card, v_lanes, v_start = (
        exact(vals), exact(lanes_vals),
        exact({"length_scale": LS, "noise": NOISE, "smoothness": NU_GEN}),
    )
    short = (v_lanes - v_card) / abs(v_lanes)
    log(f"train free nu (lanes engine, card, f64, at most "
        f"{LANES_REFERENCE_ITERATIONS} iterations, {lanes_s:.1f} s): "
        f"length_scale {lanes_vals['length_scale']!r}, noise "
        f"{lanes_vals['noise']!r}, smoothness {lanes_vals['smoothness']!r}; "
        f"exact f64 objective at K2's f32 optimum {v_card!r}, at the lanes "
        f"optimum {v_lanes!r}, at the start {v_start!r}: K2's falls short by "
        f"{short:.3e} relative (limit {GEN_OBJECTIVE_RTOL:.0e}; the surface "
        "is ridge-flat in (length scale, nu), so parameters are reported, "
        "not asserted equal)")
    assert v_card > v_start, "training did not improve the exact objective"
    assert short <= GEN_OBJECTIVE_RTOL, (
        "K2's optimum is worse than the lanes engine's"
    )

    # where the time of one free-nu evaluation goes: the coefficient
    # constructor (on the card, where the objective runs it; on the CPU for
    # comparison), K2, the epilogue; and the device's idle share
    obj32, names32 = make_fused_train_objective(trained, bt, bnt, cw, pw)
    at = {n: vals[n] for n in names32}

    def build_on(device):
        nu = torch.tensor(vals["smoothness"], dtype=torch.float32,
                          device=device)
        return lambda: matern_nu_coeffs(nu, need_dnu=True)

    # medians of 3 and a trace of 2 evaluations: each evaluation is ~0.8 s
    # of host dispatch, and the trace runs its window eight times
    build_card_ms = wall_ms(torch, build_on("cuda"), reps=3)
    build_cpu_ms = wall_ms(torch, build_on("cpu"), reps=3)
    stats = obj32._stats_fn(torch.stack(
        [torch.tensor(float(at.get(k, v)), device="cuda")
         for k, v in obj32._defaults.items()]
    ))
    epilogue_ms = wall_ms(torch, lambda: obj32._epilogue(stats))
    eval_ms = wall_ms(torch, lambda: obj32(at), reps=3)
    trace = device_trace(torch, lambda: [obj32(at) for _ in range(2)])
    log(f"train free nu: one objective evaluation {eval_ms:.3f} ms on the "
        f"host's clock = coefficient constructor {build_card_ms:.3f} ms (on "
        f"the card, f32, with the nu-tangent sets; {build_cpu_ms:.3f} ms on "
        f"this host's CPU) + K2 {k2_gen_ms:.4f} ms + epilogue "
        f"{epilogue_ms:.3f} ms + "
        f"the rest; device trace of 2 evaluations: {json.dumps(trace)}")
    return trained, dict(
        length_scale=vals["length_scale"], noise=vals["noise"],
        smoothness=vals["smoothness"], scale=vals["scale"],
        iterations=len(iters), evaluations=evals, optimize_s=opt_s,
        evaluations_per_s=evals / opt_s,
        k2_f64_vs_exact=dict(value=rel_v, gradients=rel_g),
        lanes_f64=dict(lanes_vals, seconds=lanes_s),
        objective_f64=dict(card=v_card, lanes=v_lanes, start=v_start,
                           short=short),
        evaluation_ms=dict(whole=eval_ms, build_cpu=build_cpu_ms,
                           build_card=build_card_ms, k2=k2_gen_ms,
                           epilogue=epilogue_ms),
        launches=launches, trace=trace,
    )


def shear_model(family="33", ls=SHEAR_LS, free=False):
    """The shear headline's model: ShearKernel with ShearNoise33 ("33"), or
    ShearKernel2in3out with homoscedastic noise ("23"), the nugget 1e-3 of
    2/ls^4, a FixedScale; ``free`` leaves the length scale to be trained."""
    from muygpys_torch.convert import muygps_from_arrays

    return muygps_from_arrays(
        ls, length_scale_bounds=SHEAR_LS_BOUNDS if free else "fixed",
        noise=SHEAR_NOISE,
        kernel="shear" if family == "33" else "shear_2in3out",
        noise_model="shear33" if family == "33" else "homoscedastic",
    )


def k5_flops_per_query(m, o):
    """Floating-point operations of one K5 query: per pivot the sqrt and
    reciprocal, the scaled row and column, a multiply and a subtract over
    the trailing block of the augmented matrix; then the o + o^2 dot
    products."""
    W = m + o + 1
    elimination = sum(
        2 + (W - j) + (m - 1 - j) + 2 * (m - 1 - j) * (W - 1 - j)
        for j in range(m)
    )
    return elimination + 2 * m * (o + o * o) + m


def k5_singular_batch(torch, np, n):
    """K5 on a batch with one block made singular by duplicated rows (m =
    3 n: 24, and 60 in f64, go through the shared-memory design, 60 in f32
    through the register design): the other blocks absolutely, the singular block relative to
    its own (huge) values."""
    from muygpys_torch.gpu import multiout_solve as K5
    from muygpys_torch.ops.lanes_solver import multiout_frontend_bl

    rng = np.random.default_rng(3)
    B, I, O = 64, 3, 3
    m = I * n
    A = rng.standard_normal((B, m, 2 * m))
    flat = A @ A.transpose(0, 2, 1) / (2 * m) + 0.5 * np.eye(m)
    flat[3, 5, :] = flat[3, 4, :]
    flat[3, :, 5] = flat[3, :, 4]
    Kc_np = rng.standard_normal((B, I, n, O))
    y_np = rng.standard_normal((B, I, n))
    ok = [b for b in range(B) if b != 3]
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype)[6:]
        Kin = torch.as_tensor(flat.reshape(B, I, n, I, n), dtype=dtype, device="cuda")
        Kc = torch.as_tensor(Kc_np, dtype=dtype, device="cuda")
        y = torch.as_tensor(y_np, dtype=dtype, device="cuda")
        Kout = torch.eye(O, dtype=dtype, device="cuda") * 1.3 + 0.1
        (mean, cov), ran = designs_ran(
            "multiout_solve", lambda: K5.multiout_serve_cuda(Kin, Kc, Kout, y))
        torch.cuda.synchronize()
        design = ("registers" if (m, dtype) == (60, torch.float32)
                  else "shared")
        assert ran == {design}, ran
        bl = multiout_frontend_bl(Kin, Kc, y)
        mean_p, cov_p = K5.fused_multiout_solve_bl_plain(bl[0], bl[1], Kout, bl[2])
        mean_p, cov_p = mean_p.T, cov_p.permute(2, 0, 1)
        assert torch.isfinite(mean).all() and torch.isfinite(cov).all(), (
            "K5 gave a non-finite output on the singular batch"
        )
        ordinary = K5_SINGULAR_OTHERS[tname]
        err_ok = max(float((mean[ok] - mean_p[ok]).abs().max()),
                     float((cov[ok] - cov_p[ok]).abs().max()))
        big = float(mean_p[3].abs().max())
        rel_m = float((mean[3] - mean_p[3]).abs().max()) / big
        rel_c = float((cov[3] - cov_p[3]).abs().max()) / float(cov_p[3].abs().max())
        log(f"K5 {tname} singular batch (m={m}, B={B}, {design} design): "
            f"the other blocks "
            f"max_abs_err={err_ok:.3e} (tol {ordinary:.0e}); the singular "
            f"block, |mean| up to {big:.3e}: relative error mean {rel_m:.3e} "
            f"cov {rel_c:.3e} (tol {K5_SINGULAR_REL[tname]:.0e})")
        assert big > 1e3, "the pivot floor did not act on the singular block"
        assert err_ok <= ordinary, "K5 disagrees beside the singular block"
        assert max(rel_m, rel_c) <= K5_SINGULAR_REL[tname], (
            "K5 disagrees with its plain version on the singular block"
        )


def phase_k5(torch):
    """K5 against its plain version on real shear blocks at the shear
    serving shape, both entries, f32 and f64: m = 90, and m = 60 in f32,
    through the register design, m = 60 in f64 and m = 24 (nn = 8,
    tests/test_torch_cuda.py's shape) through the shared-memory design; a batch with a singular block through
    each design; returns the kernels-line row (f32, m = 90, the frontend
    entry the serving path uses)."""
    import numpy as np

    from muygpys_torch.gpu import multiout_solve as K5
    from muygpys_torch.ops.lanes_solver import (
        multiout_frontend_bl,
        serve_mean_and_variance_multiout_bl,
    )

    # the JAX package's shear serving inputs: seed 7, uniform queries,
    # neighbours scattered 0.03 around each, white-noise observations
    rng = np.random.default_rng(7)
    q = rng.uniform(size=(SHEAR_BATCH, 2))
    nf = q[:, None, :] + 0.03 * rng.standard_normal((SHEAR_BATCH, SHEAR_NN, 2))
    y3 = rng.standard_normal((SHEAR_BATCH, 3, SHEAR_NN))
    row, f64 = None, {}
    for family, I, nn, count in (("33", 3, SHEAR_NN, SHEAR_BATCH),
                                 ("23", 2, SHEAR_NN, SHEAR_BATCH),
                                 ("33", 3, 8, 1000)):
        model = shear_model(family)
        for dtype in (torch.float32, torch.float64):
            tname = str(dtype)[6:]
            q_d = torch.as_tensor(q[:count], dtype=dtype, device="cuda")
            nf_d = torch.as_tensor(nf[:count, :nn], dtype=dtype, device="cuda")
            y = torch.as_tensor(y3[:count, 3 - I:, :nn], dtype=dtype,
                                device="cuda")
            pw = nf_d[:, :, None, :] - nf_d[:, None, :, :]
            cw = q_d[:, None, :] - nf_d
            Kin = model.noise.perturb(model.kernel(pw)).contiguous()
            Kc = model.kernel(cw).contiguous()
            Kout = model.kernel.Kout().to(dtype=dtype, device="cuda")
            B, m, o = Kin.shape[0], I * nn, Kc.shape[-1]
            bl = [t.contiguous() for t in multiout_frontend_bl(Kin, Kc, y)]
            (mean_f, cov_f), ran_f = designs_ran(
                "multiout_solve", lambda: K5.multiout_serve_cuda(Kin, Kc, Kout, y))
            (mean_b, cov_b), ran_b = designs_ran(
                "multiout_solve",
                lambda: K5.fused_multiout_solve_bl(bl[0], bl[1], Kout, bl[2]))
            torch.cuda.synchronize()
            design = ("registers" if m == 90 or (m, dtype) == (60, torch.float32)
                      else "shared")
            assert ran_f == ran_b == {design}, (ran_f, ran_b)
            mean_p, cov_p = K5.fused_multiout_solve_bl_plain(
                bl[0], bl[1], Kout, bl[2]
            )
            assert torch.isfinite(mean_f).all() and torch.isfinite(cov_f).all()
            # one kernel, two sets of strides: the same arithmetic
            assert torch.equal(mean_f, mean_b.T), "K5's two entries differ"
            assert torch.equal(cov_f, cov_b.permute(2, 0, 1))
            err_m = float((mean_b - mean_p).abs().max())
            err_c = float((cov_b - cov_p).abs().max())
            tol_m, tol_c = K5_TOL[tname]
            diag = cov_p.diagonal(dim1=0, dim2=1)
            log(f"K5 {tname} m={m} o={o} B={B} ({design} design): mean "
                f"max_abs_err={err_m:.3e} "
                f"(tol {tol_m:.0e}; |mean| median "
                f"{float(mean_p.abs().median()):.3e}), cov max_abs_err="
                f"{err_c:.3e} (tol {tol_c:.0e}; posterior variance min "
                f"{float(diag.min()):.3e} median {float(diag.median()):.3e}, "
                f"prior diagonal {float(Kout.diagonal().max()):.1f})")
            assert float(diag.min()) > 0, "a posterior variance is not positive"
            assert tol_m <= 0.1 * float(mean_p.abs().median())
            assert tol_c <= 0.1 * float(diag.min()), "covariance gate too loose"
            assert err_m <= tol_m, f"K5 mean disagrees with its plain version: {err_m}"
            assert err_c <= tol_c, f"K5 cov disagrees with its plain version: {err_c}"
            if m in (60, 90) and dtype == torch.float64:
                # f64 from the frontend layout: m = 90 through both designs
                # (the register design is compiled there), m = 60 through
                # the shared-memory design the launcher takes
                frontend = (Kin.reshape(B, m, m), Kc.reshape(B, m, o),
                            y.reshape(B, m), m, o, B, False)
                f64[m] = {d: time_ms(lambda: K5._launch(*frontend, design=d))
                          for d in (("registers", "shared") if m == 90
                                    else ("shared",))}
                log(f"K5 f64 m={m} time from the frontend layout: "
                    + ", ".join(f"{d} design {t:.4f} ms"
                                for d, t in f64[m].items()))
            if dtype == torch.float32:
                ms = time_ms(lambda: K5.multiout_serve_cuda(Kin, Kc, Kout, y))
                bl_ms = time_ms(lambda: K5.fused_multiout_solve_bl(
                    bl[0], bl[1], Kout, bl[2]))
                nbytes = (m * m + m * o + m + o + o * o) * 4 * B
                ops = k5_flops_per_query(m, o) * B
                numbers = bound_row(nbytes, ops, ms=ms)
                kept = ""
                if m == 90:
                    frontend = (Kin.reshape(B, m, m), Kc.reshape(B, m, o),
                                y.reshape(B, m), m, o, B, False)
                    numbers["kept_design_ms"] = time_ms(
                        lambda: K5._launch(*frontend, design="shared"))
                    # the kernel alone (the entry also forms Kout - S)
                    numbers["device_ms"] = device_ms(
                        torch, lambda: K5._launch(*frontend))
                    kept = (f" ({numbers['device_ms']:.4f} ms on the device "
                            f"alone); the shared-memory design "
                            f"{numbers['kept_design_ms']:.4f} ms")
                log(f"K5 f32 m={m} time: kernel {ms:.4f} ms from the frontend "
                    f"layout, {bl_ms:.4f} ms from the batch-last layout{kept}; "
                    f"bound {numbers['bound_ms']:.4f} ms "
                    f"({numbers['bound_by']}; {nbytes} B, {ops} flop)")
            if dtype == torch.float32 and m == 90:
                plain_ms = time_ms(lambda: K5.fused_multiout_solve_bl_plain(
                    bl[0], bl[1], Kout, bl[2]), reps=2, trials=3, warmup=1)
                flat, rhs = Kin.reshape(B, m, m), torch.cat(
                    [Kc.reshape(B, m, o), y.reshape(B, m, 1)], dim=2)

                def library():
                    L = torch.linalg.cholesky(flat)
                    Z = torch.linalg.solve_triangular(L, rhs, upper=False)
                    zc, zy = Z[:, :, :o], Z[:, :, o]
                    return (torch.einsum("bmo,bm->bo", zc, zy),
                            Kout[None] - torch.einsum("bmo,bmp->bop", zc, zc))

                lib_mean, lib_cov = library()
                lib_ms = time_ms(library, reps=5, trials=3)
                # the lanes engine's eager block Cholesky: thousands of
                # launches a call, a yardstick for nothing; timed once
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve_mean_and_variance_multiout_bl(bl[0], bl[1], Kout, bl[2])
                torch.cuda.synchronize()
                lanes_ms = (time.perf_counter() - t0) * 1e3
                row = dict(
                    numbers, max_abs_err=max(err_m, err_c), plain_ms=plain_ms,
                    library_ms=lib_ms, batch_last_ms=bl_ms,
                    mean_max_abs_err=err_m, cov_max_abs_err=err_c,
                )
                log(f"K5 f32 m={m}: plain version {plain_ms:.4f} ms; library "
                    f"(torch.linalg.cholesky + solve_triangular + einsum, no "
                    f"pivot floor) {lib_ms:.4f} ms, off the kernel by mean "
                    f"{float((lib_mean - mean_f).abs().max()):.3e} cov "
                    f"{float((lib_cov - cov_f).abs().max()):.3e}; the lanes "
                    f"engine's eager block Cholesky {lanes_ms:.1f} ms (one "
                    "call, host clock)")
            if dtype == torch.float32 and m == 60:
                row["m60_ms"], row["m60_batch_last_ms"] = ms, bl_ms
            if dtype == torch.float32 and m == 24:
                row["m24_shared_design_ms"] = ms
    row["f64_ms"] = f64[90]["registers"]
    row["f64_shared_design_ms"] = f64[90]["shared"]
    row["m60_f64_shared_design_ms"] = f64[60]["shared"]

    # a batch with one block made singular by duplicated rows, through each
    # design
    for n in (8, 20):
        k5_singular_batch(torch, np, n)
    return row


def shear_sky(np):
    """The sky of scripts/shear_sky_demo.py on TRAIN points: seed 0
    positions, a smooth three-component field plus N(0, 0.02^2); and the
    queries of the three requests."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(TRAIN, 2)).astype(np.float32)
    kx, ky = 2 * np.pi * np.array([3.0, 7.0]), 2 * np.pi * np.array([5.0, 2.0])
    phase = pts @ np.stack([kx, ky], axis=1)
    targets = np.stack(
        [
            np.sin(phase[:, 0]) + 0.5 * np.cos(phase[:, 1]),
            0.5 * np.cos(phase[:, 0]),
            0.5 * np.sin(phase[:, 1]),
        ],
        axis=1,
    ).astype(np.float32)
    targets += 0.02 * rng.standard_normal((TRAIN, 3)).astype(np.float32)
    queries = rng.uniform(size=(sum(SHEAR_REQUESTS), 2)).astype(np.float32)
    cuts = np.cumsum(SHEAR_REQUESTS)[:-1]
    return pts, targets, np.split(queries, cuts)


def shear_serve_checked(torch, label, model, nbrs, pts, obs, requests):
    """Serve the requests in f32 through K5 (counts zeroed just before, read
    just after) and hold mean and covariance, each against its own limit,
    to the lanes engine in f64 on the same neighbours."""
    import numpy as np

    from muygpys_torch import config
    from muygpys_torch.gpu import _build
    from muygpys_torch.serve import FastServer

    config.update("ftype", 64)
    lanes = FastServer(model, nbrs, pts, obs, bucket=SHEAR_BATCH, engine="lanes")
    config.update("ftype", 32)
    refs = [lanes.predict(r) for r in requests]
    m_ref = np.concatenate([o[0] for o in refs])
    c_ref = np.concatenate([o[1] for o in refs])
    server = FastServer(model, nbrs, pts, obs, bucket=SHEAR_BATCH, engine="kernel")
    server.predict(requests[-1])  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    mean, cov, rate = serve(torch, server, requests)
    launches = dict(_build.launches)
    count = sum(len(r) for r in requests)
    assert mean.shape == (count, 3) and cov.shape == (count, 3, 3)
    assert mean.dtype == np.float32
    assert np.isfinite(mean).all() and np.isfinite(cov).all()
    diag = np.diagonal(c_ref, axis1=1, axis2=2)
    assert (np.diagonal(cov, axis1=1, axis2=2) > 0).all(), (
        "a served variance is not positive"
    )
    prior = float(model.kernel.Kout().diagonal().max())
    tol_m, tol_c = SHEAR_MEAN_REL_F32 * prior, SHEAR_COV_REL_F32 * prior
    err_m = float(np.abs(mean - m_ref).max())
    err_c = float(np.abs(cov - c_ref).max())
    log(f"{label} kernel: {rate:.1f} predictions/s over {count} queries in "
        f"{len(requests)} requests; vs the lanes engine in f64 on the same "
        f"neighbours: mean {err_m:.3e} (tol {tol_m:.3e}; |mean| median "
        f"{float(np.median(np.abs(m_ref))):.3e}), cov {err_c:.3e} (tol "
        f"{tol_c:.3e}; variance min {float(diag.min()):.3e} median "
        f"{float(np.median(diag)):.3e}, prior diagonal {prior:.1f}); "
        f"launches {launches}")
    assert launches["multiout_solve"] == len(requests), (
        "K5 was not launched once per bucket"
    )
    assert tol_m <= 0.1 * float(np.median(np.abs(m_ref)))
    assert tol_c <= 0.1 * float(diag.min()), "covariance gate too loose"
    assert err_m <= tol_m, f"{label} mean off: {err_m}"
    assert err_c <= tol_c, f"{label} cov off: {err_c}"
    return server, dict(
        preds_per_sec=rate, mean_max_abs_err=err_m, cov_max_abs_err=err_c,
        launches=launches,
    )


def phase_shear_train(torch, pts, targets, nbrs):
    """Shear training on the card in f32 (the fused chassis routes a shear
    model to the shared-factorization objective in its batched layout),
    held against the same chassis on the CPU in f64; one lool evaluation,
    batched layout against lanes layout; returns the trained model and the
    phase's numbers."""
    import contextlib
    import io
    import re

    import numpy as np

    from muygpys_torch.convert import arrays_from_muygps
    from muygpys_torch.optimize import (
        Fused_L_BFGS_B_optimize,
        make_shear_loo_objective,
        sample_batch,
    )

    bi, bnn = sample_batch(
        nbrs, TRAIN_BATCH, TRAIN, rng=np.random.default_rng(2)
    )

    def tensors(dtype, device):
        model = shear_model(free=True)
        cw, pw, bt, bnt = model.make_train_tensors(
            bi, bnn, torch.as_tensor(pts, dtype=dtype, device=device),
            torch.as_tensor(targets, dtype=dtype, device=device),
        )
        # (B, nn, 3) -> the flattened observation layout (B, 3, nn)
        return bt, bnt.transpose(-2, -1).contiguous(), cw, pw

    data32 = tensors(torch.float32, "cuda")
    make_shear_loo_objective(  # warm-up: the first backward pass
        shear_model(free=True), *data32, layout="batched"
    )[0]({"length_scale": torch.tensor(SHEAR_LS, device="cuda",
                                       requires_grad=True)}).backward()
    torch.cuda.synchronize()
    # the mse objective is ~2e-3 and flat in the length scale, so scipy's
    # default projected-gradient tolerance (1e-5) stops ~2% short of the
    # optimum; both runs get tolerances that let them converge
    tight = dict(options=dict(gtol=1e-8, ftol=1e-14))
    iters, report = [], io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        trained = Fused_L_BFGS_B_optimize(
            shear_model(free=True), *data32, loss="mse", verbose=True,
            callback=lambda xk: iters.append(1), **tight,
        )
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    evals = 1 + int(re.search(r"\bnfev:\s*(\d+)", report.getvalue())[1])
    ls = arrays_from_muygps(trained)["length_scale"]
    lo, hi = SHEAR_LS_BOUNDS
    log(f"shear train (card, f32, batched layout): length_scale {ls!r} from "
        f"{SHEAR_LS}; {len(iters)} L-BFGS iterations, {evals} objective "
        f"evaluations in {opt_s:.4f} s = {evals / opt_s:.1f} evaluations/s")
    assert min(ls - lo, hi - ls) > 1e-6 * (hi - lo), f"length scale {ls} at a bound"

    data64 = tensors(torch.float64, "cpu")
    t0 = time.perf_counter()
    ref = Fused_L_BFGS_B_optimize(
        shear_model(free=True), *data64, loss="mse", device="cpu", **tight
    )
    cpu_s = time.perf_counter() - t0
    ls_ref = arrays_from_muygps(ref)["length_scale"]
    obj64, _ = make_shear_loo_objective(
        shear_model(free=True), *data64, layout="batched", device="cpu"
    )
    with torch.no_grad():
        v_card, v_cpu, v_start = (
            float(obj64({"length_scale": v})) for v in (ls, ls_ref, SHEAR_LS)
        )
    rel_ls = abs(ls / ls_ref - 1)
    rel_v = abs(v_card - v_cpu) / abs(v_cpu)
    log(f"shear train (CPU, f64, {cpu_s:.1f} s): length_scale {ls_ref!r}; the "
        f"card's is off by {rel_ls:.3e} relative (limit {SHEAR_LS_RTOL:.0e}); "
        f"f64 objective at the card's optimum {v_card!r}, at the CPU's "
        f"{v_cpu!r}, at the start {v_start!r}: relative difference "
        f"{rel_v:.3e} (limit {SHEAR_OBJECTIVE_RTOL:.0e})")
    assert abs(SHEAR_LS / ls_ref - 1) > 10 * SHEAR_LS_RTOL, (
        "the optimum is too near the start for the gate to see training"
    )
    assert v_cpu > v_start, "training did not improve the f64 objective"
    assert rel_ls <= SHEAR_LS_RTOL, "the card's length scale is off the f64 optimum"
    assert rel_v <= SHEAR_OBJECTIVE_RTOL, "the card's optimum is not the f64 one"

    # one lool evaluation and gradient (FixedScale): the batched layout
    # against the lanes layout, f64, on the card, on the first 512 points of
    # the batch (the lanes layout's autograd graph holds every step of the
    # 90-step block Cholesky)
    sub = tuple(t[:SHEAR_LANES_BATCH].cuda() for t in data64)
    out = {}
    for layout in ("batched", "lanes"):
        obj, _ = make_shear_loo_objective(
            shear_model(free=True), *sub, loss="lool", layout=layout
        )
        theta = torch.tensor(0.04, dtype=torch.float64, device="cuda",
                             requires_grad=True)
        value = obj({"length_scale": theta})
        value.backward()
        out[layout] = (float(value.detach()), float(theta.grad))
    rel_value = abs(out["batched"][0] / out["lanes"][0] - 1)
    rel_grad = abs(out["batched"][1] / out["lanes"][1] - 1)
    log(f"shear lool at length_scale 0.04 (f64, {SHEAR_LANES_BATCH} "
        f"points): batched {out['batched']!r}, lanes {out['lanes']!r}: value "
        f"relative {rel_value:.3e} (limit {SHEAR_LOOL_RTOL[0]:.0e}), gradient "
        f"relative {rel_grad:.3e} (limit {SHEAR_LOOL_RTOL[1]:.0e})")
    assert rel_value <= SHEAR_LOOL_RTOL[0] and rel_grad <= SHEAR_LOOL_RTOL[1], (
        "the two layouts of the shear lool objective disagree"
    )
    return trained, dict(
        length_scale=ls, iterations=len(iters), evaluations=evals,
        optimize_s=opt_s, evaluations_per_s=evals / opt_s,
        cpu_f64=dict(length_scale=ls_ref, seconds=cpu_s),
        length_scale_relative=rel_ls,
        objective_f64=dict(card=v_card, cpu=v_cpu, start=v_start,
                           relative=rel_v),
        lool_layouts=dict(value=rel_value, gradient=rel_grad),
    )


def main() -> int:
    import torch

    started = time.perf_counter()
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
    ptxas = {}
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log").read_text()
        ptxas.update(ptxas_report(report))
    for kernel, numbers in ptxas.items():
        log(f"  {kernel}: {numbers}")

    # headline data: uniform 2-D field, seed 1; white-noise serving
    # targets, and for training a smooth field with N(0, 0.1^2) noise
    rng = np.random.default_rng(1)
    train = rng.uniform(size=(TRAIN, D)).astype(np.float32)
    targets = rng.standard_normal((TRAIN, 1)).astype(np.float32)
    queries = rng.uniform(size=(QUERIES + 8192 + 5000, D)).astype(np.float32)
    y_train = (
        np.sin(2 * np.pi * train[:, 0]) * np.cos(2 * np.pi * train[:, 1])
        + 0.1 * rng.standard_normal(TRAIN)
    )[:, None]
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

    # 5. serving end to end
    model = muygps_from_arrays(
        length_scale=LS, noise=NOISE, scale=1.0, smoothness=NU
    )
    requests = [
        queries[:QUERIES], queries[QUERIES:QUERIES + 8192],
        queries[QUERIES + 8192:],
    ]
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

    def reference_outputs(served_model, served_targets):
        config.update("ftype", 64)
        reference = FastServer(
            served_model, nbrs, train, served_targets, bucket=QUERIES,
            engine="reference",
        )
        config.update("ftype", 32)
        outs = [reference.predict(r) for r in requests]
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    def serve_checked(label, served_model, served_targets, engine, ref,
                      tol_v):
        """Serve the requests (counts zeroed just before, read just after)
        and hold mean and variance to the f64 reference, each against its
        own limit."""
        m_ref, v_ref = ref
        server = FastServer(
            served_model, nbrs, train, served_targets, bucket=QUERIES,
            engine=engine,
        )
        server.predict(requests[2])  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        mean, var, rate = serve(torch, server, requests)
        launches = dict(_build.launches)
        assert mean.shape == (len(all_q), 1) and var.shape == (len(all_q),)
        assert np.isfinite(mean).all() and np.isfinite(var).all()
        mask = same if engine == "fused" else np.ones(len(all_q), bool)
        err_m = float(np.abs(mean - m_ref)[mask].max())
        err_v = float(np.abs(var - v_ref)[mask].max())
        v_min = float(np.abs(v_ref)[mask].min())
        log(f"{label} {engine}: {rate:.1f} predictions/s over "
            f"{len(all_q)} queries in 3 requests; vs f64 reference on the "
            f"same exact neighbours: mean {err_m:.3e} (tol {MEAN_TOL_F32}), "
            f"var {err_v:.3e} (tol {tol_v:.3e}; reference var min "
            f"{v_min:.3e} median {float(np.median(v_ref)):.3e}); "
            f"launches {launches}")
        assert tol_v <= 0.1 * v_min, "variance gate too loose"
        assert err_m <= MEAN_TOL_F32, f"{label} {engine} mean off: {err_m}"
        assert err_v <= tol_v, f"{label} {engine} var off: {err_v}"
        return server, dict(
            preds_per_sec=rate, mean_max_abs_err=err_m,
            var_max_abs_err=err_v, launches=launches,
        )

    ref = reference_outputs(model, targets)
    launches_by_path = {}
    e2e = {}
    for engine in ("fused", "kernel"):
        server, e2e[engine] = serve_checked(
            "e2e", model, targets, engine, ref, VAR_TOL_F32
        )
        launches_by_path[engine] = e2e[engine]["launches"]
        if engine == "fused":
            trace = device_trace(
                torch, lambda: [server.predict(r) for r in requests]
            )
            e2e[engine]["trace"] = trace
            log(f"e2e fused device trace: {json.dumps(trace)}")
    fused_launches = launches_by_path["fused"]
    assert fused_launches["fused_predict_coords"] > 0
    assert fused_launches["knn_candidates"] > 0
    assert fused_launches["knn_candidates_pruned"] > 0
    assert launches_by_path["kernel"]["fused_predict_coords"] > 0
    log("e2e: " + json.dumps(e2e))

    # 6. K2 on real neighbourhoods: a LOO batch of the training headline
    from muygpys_torch.optimize import sample_batch

    bi, bnn = sample_batch(
        nbrs, TRAIN_BATCH, TRAIN, rng=np.random.default_rng(2)
    )
    rows["fused_train_stats"] = phase_k2(
        torch, train_d, torch.as_tensor(y_train, dtype=torch.float32,
                                        device="cuda"), bi, bnn,
    )

    # 7. training end to end
    trained, train_numbers = phase_train(
        torch, train, y_train, nbrs, bi, bnn
    )
    launches_by_path["train"] = train_numbers.pop("launches")
    assert launches_by_path["train"]["fused_train_stats"] > 0
    assert (launches_by_path["train"]["fused_train_stats/registers"]
            == launches_by_path["train"]["fused_train_stats"])
    log("train: " + json.dumps(train_numbers))

    # 8. serving the trained model (variances scale with sigma^2, and so
    # does their f32 rounding)
    _, served = serve_checked(
        "trained", trained, y_train, "fused",
        reference_outputs(trained, y_train),
        VAR_TOL_F32 * train_numbers["scale"],
    )
    assert served["launches"]["fused_predict_coords"] > 0
    assert served["launches"]["knn_candidates_pruned"] > 0

    # 9. general smoothness: K4 inside K1, K1b and K2
    rows["fused_predict_coords[gen]"] = phase_k1_gen(
        torch, (nf, q, y), rows["fused_predict_coords"]["ms"]
    )
    k4_worst = phase_k4_scipy(torch)
    log("K4 against scipy kv, worst error as a share of its limit: "
        + json.dumps(k4_worst))
    rows["fused_predict"] = phase_k1b(torch, (nf, q, y))
    y_smooth_d = torch.as_tensor(y_train, dtype=torch.float32, device="cuda")
    rows["fused_train_stats[gen,free_nu]"] = phase_k2_gen(
        torch, train_d, y_smooth_d, bi, bnn
    )

    # 10. the distance-tensor workflow through K1b on the first request
    from muygpys_torch.gpu.fused_predict import (
        fused_predict_bl,
        fused_predict_bl_plain,
    )

    def dists_path(request, dtype):
        """make_predict_tensors -> K1b in ``dtype``; also the f64 plain
        version on the SAME distance tensors."""
        idx_r = torch.as_tensor(nbrs.get_nns(request)[0], device="cuda")
        cw_r, pw_r, nn_y = model.make_predict_tensors(
            torch.arange(len(request), device="cuda"), idx_r,
            torch.as_tensor(request, dtype=dtype, device="cuda"),
            train_d.to(dtype), targets_d.to(dtype),
        )
        args = (pw_r.permute(1, 2, 0), cw_r.T, nn_y.permute(1, 2, 0),
                torch.tensor([LS, NOISE], dtype=dtype, device="cuda"))
        mean, var = fused_predict_bl(*args, smoothness=NU)
        m64, v64 = fused_predict_bl_plain(
            *(t.double() for t in args), smoothness=NU
        )
        return ((mean.T.cpu().numpy(), var.cpu().numpy()),
                (m64.T.cpu().numpy(), v64.cpu().numpy()))

    dists_path(requests[0][:64], torch.float32)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    (m_b, v_b), (m_p, v_p) = dists_path(requests[0], torch.float32)
    launches_by_path["dists"] = dict(_build.launches)
    assert launches_by_path["dists"]["fused_predict"] > 0
    assert np.isfinite(m_b).all() and np.isfinite(v_b).all()
    # f32: the distance tensors themselves are the Gram identity's, so K1b
    # is held to the f64 plain version on the SAME tensors, and the whole
    # workflow to the reference engine (the same assembly in f64) under the
    # assembly's f32 floor
    err_m = float(np.abs(m_b - m_p).max())
    err_v = float(np.abs(v_b - v_p).max())
    off_m = float(np.abs(m_b - ref[0][:QUERIES]).max())
    off_v = float(np.abs(v_b - ref[1][:QUERIES]).max())
    log(f"dists path f32 (make_predict_tensors -> K1b), {QUERIES} queries: "
        f"vs the f64 plain version on the same distance tensors mean "
        f"{err_m:.3e} (tol {MEAN_TOL_F32}), var {err_v:.3e} (tol "
        f"{VAR_TOL_F32}); vs the f64 reference engine mean {off_m:.3e} (tol "
        f"{DISTS_F32_GRAM_FLOOR[0]}), var {off_v:.3e} (tol "
        f"{DISTS_F32_GRAM_FLOOR[1]}; the f32 Gram-identity distances)")
    assert err_m <= MEAN_TOL_F32 and err_v <= VAR_TOL_F32
    assert (off_m <= DISTS_F32_GRAM_FLOOR[0]
            and off_v <= DISTS_F32_GRAM_FLOOR[1]), (
        "the f32 distance workflow is off the reference engine"
    )
    # f64: the whole workflow against the reference engine
    (m_b, v_b), _ = dists_path(requests[0], torch.float64)
    err_m = float(np.abs(m_b - ref[0][:QUERIES]).max())
    err_v = float(np.abs(v_b - ref[1][:QUERIES]).max())
    log(f"dists path f64: vs the f64 reference engine mean {err_m:.3e} (tol "
        f"{DISTS_F64_TOL[0]:.0e}), var {err_v:.3e} (tol "
        f"{DISTS_F64_TOL[1]:.0e})")
    assert err_m <= DISTS_F64_TOL[0] and err_v <= DISTS_F64_TOL[1]

    # 11. serving nu = 1.2 at the serving headline (the reference engine
    # takes the exact Bessel path)
    model_gen = muygps_from_arrays(
        length_scale=LS, noise=NOISE, scale=1.0, smoothness=NU_GEN
    )
    _, served_gen = serve_checked(
        "gen", model_gen, targets, "fused",
        reference_outputs(model_gen, targets), VAR_TOL_F32,
    )
    launches_by_path["fused_gen"] = served_gen["launches"]
    assert served_gen["launches"]["fused_predict_coords"] > 0
    assert served_gen["launches"]["knn_candidates_pruned"] > 0
    log("gen served: " + json.dumps(served_gen))

    # 12. training a free smoothness, then serving the trained model
    trained_gen, gen_numbers = phase_train_free_nu(
        torch, train, y_train, bi, bnn,
        rows["fused_train_stats[gen,free_nu]"]["ms"],
    )
    launches_by_path["train_gen"] = gen_numbers.pop("launches")
    assert launches_by_path["train_gen"]["fused_train_stats"] > 0
    log("train free nu: " + json.dumps(gen_numbers))
    _, served_trained_gen = serve_checked(
        "trained free nu", trained_gen, y_train, "fused",
        reference_outputs(trained_gen, y_train),
        VAR_TOL_F32 * gen_numbers["scale"],
    )
    assert served_trained_gen["launches"]["fused_predict_coords"] > 0

    # 13. K5 against its plain version at the shear serving shape
    rows["multiout_solve"] = phase_k5(torch)

    # 14. shear serving end to end on the 50,000-point sky
    sky, sky_targets, shear_requests = shear_sky(np)
    sky_nbrs = NN_Wrapper(sky, SHEAR_NN)
    shear_server, shear_e2e = shear_serve_checked(
        torch, "shear", shear_model(), sky_nbrs, sky, sky_targets,
        shear_requests,
    )
    launches_by_path["shear"] = shear_e2e["launches"]
    assert (launches_by_path["shear"]["multiout_solve/registers"]
            == launches_by_path["shear"]["multiout_solve"] > 0)
    shear_trace = device_trace(
        torch, lambda: [shear_server.predict(r) for r in shear_requests]
    )
    shear_e2e["trace"] = shear_trace
    log(f"shear device trace: {json.dumps(shear_trace)}")
    _, shear_23 = shear_serve_checked(
        torch, "shear 2-in-3-out", shear_model("23"), sky_nbrs, sky,
        sky_targets[:, 1:], shear_requests[:1],
    )
    shear_e2e["two_in_three_out"] = shear_23
    log("shear e2e: " + json.dumps(shear_e2e))

    # 15. shear training, then serving the trained model
    shear_trained, shear_train_numbers = phase_shear_train(
        torch, sky, sky_targets, sky_nbrs
    )
    log("shear train: " + json.dumps(shear_train_numbers))
    _, shear_served = shear_serve_checked(
        torch, "shear trained", shear_trained, sky_nbrs, sky, sky_targets,
        shear_requests[:1],
    )
    log("shear trained served: " + json.dumps(shear_served))

    # 16. kernels line: launches on each kernel's path (serving: fused and
    # fused_gen; the distance workflow: dists; training: train and
    # train_gen; shear serving: shear), counted from zero just before the
    # path ran
    k1_src = "muygpys_torch/gpu/csrc/fused_predict.cu"
    k4_src = "muygpys_torch/gpu/csrc/matern_nu.cuh"
    k4_tpu = "muygpys_tpu/pallas/matern_nu.py:273"
    meta = {
        "fused_predict_coords": (
            "muygpys_torch/gpu/csrc/fused_predict.cu",
            "muygpys_tpu/pallas/fused_predict.py:373", "fused",
        ),
        "knn_candidates": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:217",
            "fused",
        ),
        "knn_candidates_pruned": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:451",
            "fused",
        ),
        "fused_train_stats": (
            "muygpys_torch/gpu/csrc/fused_train.cu",
            "muygpys_tpu/pallas/fused_train.py:449", "train",
        ),
        "fused_predict": (
            k1_src, "muygpys_tpu/pallas/fused_predict.py:263", "dists",
        ),
        # K1 and K2 a second time, with K4 inlined (K4 has no launch of its
        # own: its cost is the gen-minus-closed-form difference per element)
        "fused_predict_coords[gen]": (
            f"{k1_src} + {k4_src}",
            f"muygpys_tpu/pallas/fused_predict.py:373 + {k4_tpu}",
            "fused_gen",
        ),
        "fused_train_stats[gen,free_nu]": (
            f"muygpys_torch/gpu/csrc/fused_train.cu + {k4_src}",
            f"muygpys_tpu/pallas/fused_train.py:449 + {k4_tpu}", "train_gen",
        ),
        "multiout_solve": (
            "muygpys_torch/gpu/csrc/multiout_solve.cu",
            "muygpys_tpu/pallas/multiout_solve.py:122", "shear",
        ),
    }
    # K2 and K5: each design's launches in the checks against the plain
    # versions (phases 6, 9 and 13; the register designs also run on the
    # main paths, the shared-memory designs only there), and each
    # instantiation's registers and spills
    for counter, kernel in (("fused_train_stats", "fused_train_stats"),
                            ("multiout_solve", "multiout")):
        designs = {d: CHECK_LAUNCHES.get(f"{counter}/{d}", 0)
                   for d in ("registers", "shared")}
        assert min(designs.values()) > 0, f"a {counter} design never ran"
        for name in rows:
            if name.split("[")[0] == counter:
                rows[name]["design_launches_in_checks"] = designs
                rows[name]["ptxas"] = {k: v for k, v in ptxas.items()
                                       if k.startswith(kernel)}
    kernels = []
    for name, (source, replaces, path) in meta.items():
        counter = name.split("[")[0]
        assert launches_by_path[path][counter] > 0, (
            f"{name} was not launched on its path"
        )
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches_by_path[path][counter],
            paths={p: c[counter] for p, c in launches_by_path.items()},
            **rows[name],
        ))
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - started:.1f} s")
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
