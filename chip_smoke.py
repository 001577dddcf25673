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
   F2 and a heteroscedastic case, in f32 and f64, through the design the
   launcher takes (registers); at the headline both designs (registers and
   the kept shared-memory design) checked and timed, queued and alone on
   the device, beside the library yardstick (torch.linalg.cholesky +
   cholesky_solve on K formed elementwise);
4. K3 (packed-key KNN candidates) against its plain version: unpruned at
   50,000 x 8192, pruned by the bounded route, and pruned at NN_Wrapper's
   1024 bins, d=2, through the fused design (the merge inside the kernel:
   distances bit-equal, index sets on >= 0.999 of slots) and the kept
   design plus its torch.topk merge (key state bit-equal), each timed, with
   the cdist + topk yardstick;
4b. the bounded route's query order (knn_query_order_kernel) against its
   plain route (the Morton sort and the inverse argsort) bit for bit at
   8192 x 2, 256 x 2, 1 x 2, 8191 x 3, 4096 x 4 and 256 clustered queries,
   one launch each; torch.sum's norms against the feature order at 1 to 4
   features; both routes timed at 8192 x 2 and 256 x 2; the fused and
   fast-mean buckets built with either route: outputs bit-equal, launches
   and the profiler's device activities a request, predictions/s
   alternated;
5. serving end to end: FastServer(engine="fused") at the headline
   configuration (50k Morton-sorted training points, d=2, nn=30, bucket
   8192, Matern 3/2, ls 0.5, noise 1e-3, f32) answers three requests, one
   not a multiple of the bucket; the same with engine="kernel" over an
   exact NN_Wrapper; both held against the f64 reference engine on the same
   exact neighbours (mean and variance each against its own limit); the
   fused requests launch only the new designs of K3 and K1; on the card
   each server captures its bucket in a CUDA graph at the first request:
   for both engines every request's captured outputs are held bit for bit
   to the eager core on the same padded inputs, with the same launches of
   each design, predictions/s are taken both ways alternated (captured,
   eager, eager, captured), and torch.profiler traces of the requests both
   ways give device time by kernel, the idle share and the device
   activities a bucket; NN_Wrapper(nn_method="kernel") against the exact
   index on the first request;
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
   trace of K2 objective evaluations; then the same headline on the device
   chassis (Fused_Device_LBFGS_optimize(engine="kernel"), f32: one eager
   warm-up step, then replays from the start of a captured graph of
   STEPS_PER_REPLAY steps, the done flag read once per replay), held to the
   same gates against the CPU f64 optimum, with its iterations,
   evaluations, replays, capture ms, wall ms, evaluations/s (a first run
   and a replay-only run) and a trace's idle share; make_device_trainer on
   two LOO batches (one capture; the second batch held to the f64 fused
   chassis on the card);
8. serving the trained model: FastServer(engine="fused") against the f64
   reference engine with the same model;
9. general smoothness, K4 (the traced-nu surrogate, csrc/matern_nu.cuh)
   inside K1, K1b and K2: K1 under "gen" against its plain version at the
   serving shape for nu in {0.31, 1.2, 2.0 (the clamp zone), 4.8}, f32 and
   f64, nu = 1.2 through both designs and timed; K4's constructor kernel
   (csrc/matern_nu_coeffs.cu) against its plain version on the card for 14
   orders (the integers and both sides of the clamp zones among them), f32
   and f64, with and without the nu-tangent sets, timed (queued, alone on
   the device and on the host clock) beside the plain version on the card
   and an empty kernel; K4 alone against scipy.special.kv through the f64
   (vector built on the CPU and by the constructor kernel) and f32 kernels
   on a t grid; K1b (the solve from distances) against its plain version,
   closed form, RBF and gen, through the launcher's design (registers); at
   nu = 3/2 (f32, f64) and 1.2 (f32) both designs checked and timed, beside
   the library yardstick (torch.linalg.cholesky + cholesky_solve on K
   formed elementwise); K2 under "gen", a fixed and a free nu,
   isotropic and anisotropic, at the headline's length scale (every entry
   on K4's series branch) and at one near the neighbour spacing (entries on
   both branches), each row group (the d/dnu rows included) against its own
   limit, through the register design (the free-nu headline also timed
   through the shared-memory design);
10. the distance-tensor workflow: make_predict_tensors -> fused_predict_bl
   (K1b, the register design alone) on the first request; in f32 held
   against the f64 plain version on the same distance tensors, in f64
   against the f64 reference engine;
11. serving nu = 1.2 at the serving headline through the fused engine,
   against the f64 reference engine (the exact Bessel path);
12. training a free smoothness at the training headline: length scale, noise
   and nu together (nu 1.2 in (0.31, 5)), lool, f32, through K2; K2's f64
   value and gradients at one point against the exact-Bessel lanes
   objective on the card; the objective reached against the lanes engine's
   (capped at 10 L-BFGS iterations, to keep the run short), both judged by
   the exact f64 objective; one constructor launch per evaluation (the
   launch counts and a trace of two evaluations); where the time of one
   evaluation goes (coefficient constructor, K2, epilogue, the device's
   idle share); the trained model served; the same headline on the
   device chassis (one constructor launch per K2 launch), its exact f64
   objective held to the lanes engine's;
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
   f64 on the same neighbours; the captured bucket against the eager core
   (bit for bit, the same launches; the index's search, one launch of the
   exact kernel a request before the bucket, counted apart), alternated
   rates and traces, as in phase 5; one request of ShearKernel2in3out.
   Before it the exact kernel (knn_exact_select) against its plain version
   at the shear request's shape, 2048 queries and k = 30 over the sky and
   over 1,000,000 uniform rows: distances bit-equal to the plain
   version's and to the tiled library search's (_brute_force_knn +
   _refine_knn), sorted sets equal on >= 99.9% of queries, one launch
   counted, the share of tiles scored; timed beside both;
15. shear training, then serving the trained model: a LOO batch of 2048,
   Fused_L_BFGS_B_optimize(loss="mse") with the length scale free, on the
   card in f32, held against the same chassis on the CPU in f64; one lool
   evaluation and gradient of the batched layout against the lanes layout
   in f64; the trained model served through K5;
16. the fast posterior mean at the serving headline: phase 7's trained
   model through checkpoint.save_model / load_model in a temporary
   directory (the restored model compares equal, and FastServer(engine=
   "fused") serves the first request from both bit for bit); the offline
   precompute over all 50,000 training points, NN_Wrapper(nn_method=
   "kernel").get_batch_nns (K3p at 1024 bins, k = 63, its neighbour sets
   against the exact index's) -> fast_nn_update (once) -> the
   deformation's pairwise tensor -> kernel -> fast_coefficients
   (examples.fast_posterior_mean.make_fast_regressor), timed whole and by
   step; the fast state through save_fast_state / load_fast_state bit
   for bit; the three requests through fast_posterior_mean_serve (get_nns
   -> the nearest point's self-inclusive set -> crosswise tensor ->
   fast_posterior_mean); the f32
   coefficients held to the f64 precompute of the same neighbourhoods and
   the f32 fast mean to the f64 fast mean on the same indices, the fast
   mean against the fused engine's full posterior mean (correlation);
   predictions/s (host numpy in and out) alternated with the captured
   fused engine's, and a trace; a two-response MultivariateMuyGPS (nu 3/2
   and 5/2) precomputing (50000, 30, 2) coefficients and serving one
   request against f64; K3p checked and timed at the precompute's shape;
17. the user workflows at the headlines' sizes (f32 on the card, each held
   against f64 on the CPU): (a) every NN_Wrapper method on 8192 queries
   against the 50,000 points ("exact", the train-tile scan, "brute",
   "kernel" (K3p), "hnsw"; "sklearn" where scikit-learn is installed),
   build and query seconds, sets against the exact f64 sets, and the scan
   in tiles of 16,384 at 1,000,000 training rows against the same search
   in one tile (seconds, peak device memory, the same neighbours); (b)
   examples.regress.do_regress at the training headline (Matern 3/2, the
   length scale free, the noise fixed at 1e-3; NN_Wrapper(nn_method=
   "kernel"), Bayes_optimize with 5 + 20 probes, batch 2048, one request
   of 8192) against the same call on the CPU in f64 (the f64 objective at
   the card's f32 optimum, one-sided, and at its f64 optimum; mean and
   variance at the CPU's parameters on the same neighbours), seconds by
   stage, regress_any's predictions/s alternated with the captured fused
   engine's; (c) do_classify and do_classify_uq on the half-moons at
   50,000 training points (accuracy, classes against CPU f64 at its
   optimum, the masks' shape); (d) optimize_from_tensors_mini_batch
   (engine="device-lbfgs", three epochs of 2048, keep_state: one capture,
   seconds per epoch, the last epoch's f64 objective against the CPU's);
   (e) a hierarchical length scale on the nonstationary field (4,000
   points, batch 1024) through make_device_trainer(...,
   batch_features=), in f32 and in f64: the field's ordering on two
   batches, the second a replay with its own features; in f64 the
   objective against the CPU's and the replay against the CPU's eager
   run (in f32 both are logged);
18. the deep-kernel tutorial (docs/deep_kernel_tutorial.md) at its full
   width on the card in f32: 4,000 points x 40 features (3,000 to train),
   an MLP 40 -> 64 -> 32 -> 2 feeding Matern 3/2, a batch of 500, 200
   Adam steps (lr 1e-2, decay 0.97, lool), the index rebuilt on the
   embedded features every 25 steps through NN_Wrapper(nn_method=
   "pallas") (K3p); the final loss under a tenth of the first step's,
   finite non-negative variances, the test error beside the untrained
   model's (a reading: the embedding overfits its batch there); the JAX
   test's train-and-predict bars at that test's configuration (600 x 6,
   tanh MLP 6 -> 16 -> 2, 150 steps: the loss bar, the test error under
   1.5x the targets' variance and under the untrained model's); its
   first 5 steps in f64 on the card against the CPU's from one start; ms
   a step, seconds a rebuild, K3p's launches, a trace of one step; a
   reporting-only run at 50,000 points (batch 2048, 20 steps, a rebuild
   every 5);
19. the fast-mean workflow functions: fast_posterior_mean_any on phase
   16's model, points and three requests (f32 against f64 within the
   serving mean limit, correlation with the captured fused engine, JAX's
   four timing keys), and do_fast_posterior_mean on the JAX test's sine
   data;
20. the headline harness: bench_torch.py's main in this process (its JSON
   line parsed, every rate finite and positive, per-iteration times
   beside phases 3/4's kernel ms), each of its kernel loops captured and
   replayed once against one eager call (equal), and BenchmarkPipeline
   with a torch.profiler trace;
21. the sharded paths, each world's ranks worker processes of this script
   (``--sharded-rank``; any rank that exits non-zero fails the run): a
   world of one over NCCL (servers captured, no collective issued) and two
   ranks sharing the card over gloo (servers eager): FastServer(engine=
   "fused", mesh=, shard="queries") at the serving headline against the
   serial server (bit for bit), shard="train" (25,000 rows a rank at two
   ranks, K3 pruned on each shard; its sets against the exact ones, its
   mean and variance against the f64 reference where they equal; one
   request at nu = 1.2 through K1 "gen" against the serial server), the
   shear bucket (K5) under shard="queries" against the serial server, each
   server's mode asserted; at two ranks the training headline's batch
   sharded through Fused_L_BFGS_B_optimize(engine="kernel") under phase
   7's gates, equal on both ranks; performance/scaling.py's three programs
   (mechanics: the ranks share one card) and a reporting-only
   shard="train" run at 1,000,000 rows beside phase 20's single-card rate.
   With two cards or more the same again over NCCL, one rank a card;
   with one, a line saying NCCL across cards did not run;
22. the kernels line (its ``paths`` include the sharded ones, summed over
   every rank): one JSON object with every kernel's launches on its
   path and each design's launches there, error against its plain version,
   times (for K1, K1b and K3 also the kept design's) and bound; for K2 and
   K5 each design's launches over the run (both must have run) and
   registers; K4's constructor with its launches on the free-nu path;
   each kernel's paths that ran it inside a captured graph (in_graph);
23. the last line: {"ok": true, "device": {...}}.

With ``--query-order`` the script runs phase 4b alone on the headline set
and prints its readings as one JSON line.

With ``--exact-bench ROOT`` the script instead times the exact search of
the muygpys_torch package found at ROOT (this checkout's, or another's, to
compare two versions on one card) at the headline size:
NN_Wrapper("exact").get_nns on one request of 8192 against the 50,000
points, and phase 14's shear serving rate (its engine searches through such
an index); it prints one JSON line.

Kernel times are CUDA-event medians over back-to-back launches (time_ms);
for K1, K1b, K2, K3, K4's constructor and K5 also the kernel's own device time, each call queued
behind a device-side sleep (device_ms), which time_ms exceeds where a
call's host work outlasts the kernel; wall times are medians of single runs.  Bounds use the H100 SXM
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
# the launch-count paths whose kernels run inside a captured CUDA graph: the
# serving buckets (FastServer on a card) and the device chassis
CAPTURED_PATHS = ("fused", "kernel", "fused_gen", "shear", "device_train",
                  "workflow_fused", "headline",
                  "device_train_gen")
# the kernels that run on a captured path but outside its graph: the
# exact NN_Wrapper's search, before the bucket
OUTSIDE_GRAPH = ("knn_exact_select",)

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
# the same workflow in f32 against the f64 reference engine: set at the
# floor of the uncentred Gram-identity assembly (|a|^2 + |b|^2 - 2 a.b loses
# ~eps_f32 absolute on squared distances of ~2e-5 between neighbours of the
# 50k set), 1.6x and 2.2x the spread measured on the H100 then (1.224e-2,
# 1.796e-6); the centred assembly reads 1.117e-3, 1.808e-7 (PERF.md,
# Findings)
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
# the fast posterior mean (phase 16): the f32 coefficients against the f64
# precompute of the same neighbourhoods, as a share of the largest f64
# coefficient: set at the f32 rounding of the uncentred Gram-identity
# distances (eps |x|^2 on d^2, 6e-8 on unit coordinates) times a
# neighbourhood's condition number (~1e3 at the trained noise 0.034 and
# nn = 30), 1.4e-4 on the headline set then; the centred assembly reads
# 1.2e-5 on the H100 (PERF.md, Findings); the f32 fast mean against the f64
# fast mean
# on the same indices is held to MEAN_TOL_F32
FAST_COEFF_REL_F32 = 1e-3
# the fast mean against the fused engine's full posterior mean (another
# neighbourhood: the nearest training point's self-inclusive set, not the
# query's own): tests/test_gp.py's correlation
FAST_CORR_MIN = 0.99
# rounds of the fast path's timings: the precompute, and the alternated
# (fast, fused, fused, fast) serving rates (two rounds a side read 0.94M
# and 1.72M fast-mean predictions/s in two runs on the same card)
FAST_ROUNDS = 5
# phase 17, the user workflows.  (a) the exact search past one train tile
# scanned at a million training rows (the JAX package's million-point sky);
# the f32 exact methods' sets against the f64 exact sets (near-ties at the
# f32 rounding are ~1e-6 of queries at the headline's spacing); K3's
# contract; tests/test_neighbors.py's HNSW recall gate
SCAN_ROWS = 1_000_000
EXACT_SETS_MIN = 0.999
KERNEL_SETS_MIN = 0.98
HNSW_RECALL_MIN = 0.9
# (c) tests/test_examples.py's half-moons widened to 50,000 training points
# (and as many test points) and its accuracy gate; the classes of the f32
# surrogate at the CPU's f64 optimum against the f64 classes on the same
# neighbours
CLASSIFY_POINTS = 100_000
CLASSIFY_ACCURACY_MIN = 0.85
CLASSIFY_AGREE_MIN = 0.999
# (d) epochs of the mini-batch chassis
MINI_BATCH_EPOCHS = 3
# (e) tests/test_nonstationary.py's field widened to 4,000 points, its
# ordering gate; a replayed f64 trajectory against the CPU's eager one at
# tests/test_torch_cuda.py's device-trainer tolerance
HIER_POINTS, HIER_BATCH = 4000, 1024
HIER_RATIO_MIN = 1.5
HIER_REPLAY_RTOL = 1e-6
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
    f 1`` is the register design of K2 in f32 for one right-hand side,
    ``knn_select_kernel 2 2`` the fused K3 design at 2 features and 512
    bins."""
    import re

    out, kernel = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            found = re.search(
                r"\d+([a-z_]+?_kernel)(?:I([fd])?((?:Li\d+E)*))?",
                entry.group(1))
            kernel = (" ".join([found.group(1), found.group(2) or ""]
                               + re.findall(r"Li(\d+)E", found.group(3) or ""))
                      .replace("  ", " ").strip()
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
    designs = None
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
            if nu == NU and not hetero:
                designs = k1_designs(torch, args, nu, (mp, vp), (tol_m, tol_v))
            if dtype == torch.float32 and nu == NU and not hetero:
                plain_ms = time_ms(
                    lambda: fused_predict_coords_bl_plain(*args, **kw),
                    reps=3, trials=3,
                )
                library_ms = time_ms(k1_library(torch, *args[:4]), reps=5,
                                     trials=3)
                nbytes = (n * d + d + n * r + r + 1) * 4 * B + (d + 1) * 4
                ops = k1_ops_per_query(n, d, r) * B
                row = k1_row(designs, nbytes, ops, max_abs_err=err,
                             plain_ms=plain_ms, library_ms=library_ms)
                log(f"K1 f32 time: {row['design']} design {row['ms']:.4f} ms "
                    f"(device {row['device_ms']:.4f}), kept design "
                    f"{row['kept_ms']:.4f} ms (device "
                    f"{row['kept_device_ms']:.4f}), plain {plain_ms:.4f} ms, "
                    f"library {library_ms:.4f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes} "
                    f"B, {ops} flop)")
    return row


def designs_timed(torch, label, launch, plain, tol):
    """Both designs of K1 or K1b through ``launch(design)``, each held
    against the plain version's (mean, var) under ``tol`` and timed (queued
    wrapper calls, and the kernel alone); returns their numbers by
    design."""
    out = {}
    for design in ("registers", "shared"):
        def call():
            return launch(design)

        m, v = call()
        torch.cuda.synchronize()
        err_m = float((m - plain[0]).abs().max())
        err_v = float((v - plain[1]).abs().max())
        log(f"{label} {design} design: mean {err_m:.3e} (tol {tol[0]:.0e}), "
            f"var {err_v:.3e} (tol {tol[1]:.0e})")
        assert err_m <= tol[0] and err_v <= tol[1], f"{label} {design} disagrees"
        out[design] = dict(ms=time_ms(call), device_ms=device_ms(torch, call))
    return out


def k1_designs(torch, args, smoothness, plain, tol):
    """Both K1 designs at one shape through the private launcher
    (designs_timed)."""
    from muygpys_torch.gpu import fused_predict as F
    from muygpys_torch.gpu import matern_nu as _nu

    nf, q, y, params, noise_nn = args[:5]
    gen = args[5] if len(args) > 5 else None
    code = _nu.check_smoothness("K1", smoothness, gen, 1, _nu._LEN_VAL)
    gen = None if gen is None else gen[:_nu._LEN_VAL].contiguous()
    return designs_timed(
        torch, f"K1 {str(nf.dtype)[6:]} nu={smoothness}",
        lambda design: F._launch(nf, q, y, params, noise_nn, gen, code, 1,
                                 smoothness, design=design),
        plain, tol)


def k1_row(designs, nbytes, ops, **numbers):
    """A kernels-line row of K1: the times of the design the launcher picks
    at the headline, the kept design's beside them; the register design is
    picked only where its kernel time is below the kept design's."""
    import torch

    from muygpys_torch.gpu.fused_predict import k1_design

    chosen = k1_design(30, 1, torch.float32, 1.5)
    other = "shared" if chosen == "registers" else "registers"
    assert designs["registers"]["device_ms"] < designs["shared"]["device_ms"], (
        f"the register design is not faster at the headline: {designs}")
    return bound_row(
        nbytes, ops, design=chosen, ms=designs[chosen]["ms"],
        device_ms=designs[chosen]["device_ms"],
        kept_ms=designs[other]["ms"], kept_device_ms=designs[other]["device_ms"],
        **numbers,
    )


def library_posterior(torch, up, uc, y, noise, eye):
    """Matern 3/2 (mean, var) from batch-first scaled distances ``up (B, n,
    n)`` and ``uc (B, n)`` and batch-last ``y (n, r, B)`` through library
    calls: K formed elementwise, torch.linalg.cholesky +
    torch.cholesky_solve + einsum."""
    s3 = math.sqrt(3.0)
    K = (1.0 + s3 * up) * torch.exp(-s3 * up) + noise * eye
    kc = (1.0 + s3 * uc) * torch.exp(-s3 * uc)
    L = torch.linalg.cholesky(K)
    Z = torch.cholesky_solve(torch.cat([kc[..., None], y.permute(2, 0, 1)], 2), L)
    mean = torch.einsum("bn,bnr->rb", kc, Z[..., 1:])
    return mean, 1.0 - (kc * Z[..., 0]).sum(1)


def k1_library(torch, nf, q, y, params):
    """K1's (mean, var) at the serving headline (Matern 3/2, isotropic)
    through library calls on K formed elementwise (library_posterior),
    batch first.  A yardstick of speed; the port never calls it."""
    ls, noise = float(params[0]), float(params[-1])
    eye = torch.eye(nf.shape[0], dtype=nf.dtype, device=nf.device)

    def run():
        x = nf.permute(2, 0, 1) / ls  # (B, n, d)
        qq = q.T[:, None, :] / ls
        up = (x[:, :, None, :] - x[:, None, :, :]).pow(2).sum(-1).sqrt()
        uc = (x - qq).pow(2).sum(-1).sqrt()
        return library_posterior(torch, up, uc, y, noise, eye)

    return run


def phase_k3(torch, train_sorted, queries, cand_count):
    """K3 against its plain version at the fused path's shapes: the
    unpruned search over the 50k set, the pruned search (the bounded route),
    and the pruned search at NN_Wrapper's 1024 bins.  Each through the
    design the launcher takes (fused: the merge in the kernel) and the kept
    design with its _merge_decode, each timed; the kept design's key state
    against its mirror bit for bit.  Returns the kernels-line rows."""
    from muygpys_torch.gpu import knn as K

    wide_k = NN + 32  # NN_Wrapper's over-fetch
    cases = (
        ("knn_candidates", K.prepare(train_sorted, queries, cand_count),
         cand_count, train_sorted),
        ("knn_candidates_pruned",
         K.prepare_bounded(train_sorted, queries, cand_count), cand_count,
         train_sorted),
        ("knn_candidates_pruned[bins1024]",
         K.prepare_bounded(train_sorted, queries, wide_k, bins=1024), wide_k,
         train_sorted),
    )
    rows = {}
    for name, prep, k, train_used in cases:
        rows[name] = k3_case(torch, name, prep, k, queries, train_used)
    return rows


def phase_k3_1m(torch, k, seed=18):
    """K3p's bounded route at the serving cells' shape: 8192 uniform
    queries over SCAN_ROWS uniform Morton-sorted rows, 512 bins, ``k``
    candidates (38: the bulk bucket's; 9: the fast-mean bucket's).  idx and
    d2 bit-equal to the unpruned fused kernel's on the same sorted queries,
    d2 bit-equal to the plain version's (its key state is (Q, bins)); one
    launch counted, the boxes walked from the index's counter zeroed just
    before; the route and the unpruned kernel timed, the plain version
    once.  Returns the kernels-line row."""
    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu import knn as K

    g = torch.Generator(device="cuda").manual_seed(seed)
    train = torch.rand((SCAN_ROWS, 2), device="cuda", generator=g)
    train = train[K.spatial_sort(train)].contiguous()
    queries = torch.rand((8192, 2), device="cuda", generator=g)
    index = K.build_index(train, pruned=True)
    prep = K.prepare_bounded(None, queries, k, train_index=index)
    assert K.knn_design(2, k, prep.bins) == "fused"
    K.knn_select(prep, k)  # build and warm up
    torch.cuda.synchronize()
    index.boxes.counts.zero_()
    before = dict(_build.launches)
    idx, d2 = K.knn_select(prep, k)
    torch.cuda.synchronize()
    launched = {c: _build.launches[c] - before.get(c, 0)
                for c in ("knn_candidates_pruned", "knn_candidates")}
    total, walked = index.boxes.counts.tolist()
    full = K.prepare(train, prep.q, k, query_tile=8)
    ik, dk = K.knn_select(full, k)
    t0 = time.perf_counter()
    _, dp = K.knn_select_plain(full, k)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same_idx, same_d2 = bool(torch.equal(idx, ik)), bool(torch.equal(d2, dk))
    plain_d2 = bool(torch.equal(d2, dp))
    nb = index.boxes.norm.shape[0]
    name = f"knn_candidates_pruned[1m,k{k}]"
    log(f"K3 {name} (8192 x {SCAN_ROWS}, bins {prep.bins}, k {k}): "
        f"launches {launched}; idx bit-equal to the unpruned kernel "
        f"{same_idx}, d2 {same_d2}; d2 bit-equal to the plain version "
        f"{plain_d2}; boxes walked {walked} of {total} "
        f"({100.0 * walked / total:.4f}%, {walked / (total / nb):.2f} a "
        f"block of 8 queries)")
    assert launched == {"knn_candidates_pruned": 1, "knn_candidates": 0}
    assert total == 1024 * nb and 2 * walked < total
    assert same_idx and same_d2 and plain_d2, f"K3 {name} disagrees"

    def bounded():
        return K.knn_select(prep, k)

    def unpruned():
        return K.knn_select(full, k)

    times = dict(ms=time_ms(bounded), device_ms=device_ms(torch, bounded),
                 unpruned_ms=time_ms(unpruned),
                 unpruned_device_ms=device_ms(torch, unpruned))
    pairs = walked * K.BOX * 8
    extra = (index.boxes.box.numel() + index.boxes.norm.numel()) * 4
    nbytes = (8192 + prep.tT.shape[1]) * 3 * 4 + extra + 8192 * k * 12
    row = bound_row(nbytes, pairs * (2 * 2 + 3), design="fused",
                    plain_ms=plain_ms, boxes_walked=walked,
                    boxes_total=total, **times)
    log(f"K3 {name} time: bounded {times['ms']:.4f} ms (device "
        f"{times['device_ms']:.4f}), unpruned {times['unpruned_ms']:.4f} ms "
        f"(device {times['unpruned_device_ms']:.4f}), plain {plain_ms:.1f} "
        f"ms once, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    assert times["device_ms"] < times["unpruned_device_ms"], name
    return name, row


# the bounded route's query order against its plain PyTorch route: (name,
# queries, features, kind), seeded on the card
ORDER_CASES = (("8192x2", 8192, 2, "uniform"), ("256x2", 256, 2, "uniform"),
               ("1x2", 1, 2, "uniform"), ("8191x3", 8191, 3, "uniform"),
               ("4096x4", 4096, 4, "uniform"),
               ("256x2[cluster]", 256, 2, "cluster"))


def order_queries(torch, count, d, kind, seed):
    """``count`` f32 queries on the card: uniform in the unit cube, or
    (``"cluster"``) in a cube of side 0.01 around a uniform centre, as the
    small cell's traffic."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.rand((count, d), device="cuda", generator=g)
    if kind == "cluster":
        q = 0.99 * torch.rand(d, device="cuda", generator=g) + 0.01 * q
    return q


def torch_order(torch, q):
    """The plain route of the queries' order: ``_sorted_queries`` and the
    inverse argsort."""
    from muygpys_torch.gpu import knn as K

    q_pad, qperm = K._sorted_queries(q, 8)
    return q_pad, qperm, torch.argsort(qperm)


def order_bucket(torch, server, requests):
    """A bucket built with one query order: the outputs of each request,
    and on one request the launches counted and the profiler's device
    activities and busy microseconds."""
    from muygpys_torch.gpu import _build

    server.predict(requests[-1])  # warm-up: the capture
    torch.cuda.synchronize()
    outs = [server.predict(r) for r in requests]
    _build.reset_launches()
    server.predict(requests[0])
    launches = {k: v for k, v in _build.launches.items() if v}
    trace = device_trace(torch, lambda: server.predict(requests[0]))
    return dict(outs=outs, launches=launches,
                device_activities=trace["device_activities"],
                device_busy_us=trace["device_busy_us"])


def phase_query_order(torch, train, targets, nbrs):
    """The bounded route's query order (``knn.knn_query_order``): the
    kernel against the plain route (``_sorted_queries`` and the inverse
    argsort) bit for bit at ORDER_CASES, one launch counted each; the
    glue's norms (``torch.sum``) against sequential sums at 1 to 4
    features; both routes timed at the bulk bucket's 8192 x 2 and the
    small bucket's 256 x 2; then the fused and fast-mean buckets at QUERIES
    built with either route (the plain one forced): outputs bit-equal,
    launches and the profiler's device activities a request, and
    predictions/s alternated (kernel, plain, plain, kernel).  Returns the
    kernels-line row and the readings."""
    from unittest import mock

    import numpy as np

    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu import knn as K
    from muygpys_torch.serve import FastServer

    equal = {}
    for i, (name, count, d, kind) in enumerate(ORDER_CASES):
        q = order_queries(torch, count, d, kind, 20 + i)
        assert K.query_order_route(count, d, q.device) == "kernel", name
        before = dict(_build.launches)
        got = K.knn_query_order(q)
        torch.cuda.synchronize()
        assert _build.launches["knn_query_order"] == (
            before["knn_query_order"] + 1), name
        assert (_build.launches["knn_query_order/torch"]
                == before["knn_query_order/torch"]), name
        want = torch_order(torch, q)
        equal[name] = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    log(f"knn_query_order against the plain route (q_pad, qperm, qinv "
        f"bit-equal): {json.dumps(equal)}")
    assert all(all(v) for v in equal.values()), "the query order disagrees"

    # the norms the kernel leaves to the glue: torch.sum's additions
    # against the feature order's
    sums = {}
    for d in (1, 2, 3, 4):
        q = order_queries(torch, 8192, d, "uniform", 30 + d) * 3.0 - 1.0
        sq = q * q
        seq = sq[:, 0]
        for f in range(1, d):
            seq = seq + sq[:, f]
        sums[d] = bool(torch.equal(torch.sum(sq, dim=-1), seq))
    log(f"torch.sum(q * q, -1) equals the sum in feature order at d = "
        f"{json.dumps(sums)}")

    times = {}
    for count in (8192, 256):
        q = order_queries(torch, count, 2, "uniform", 40)

        def kernel():
            return K.knn_query_order(q)

        def plain():
            return torch_order(torch, q)

        times[count] = dict(
            ms=time_ms(kernel), device_ms=device_ms(torch, kernel),
            plain_ms=time_ms(plain), plain_device_ms=device_ms(torch, plain))
    log(f"knn_query_order time (2 features): {json.dumps(times)}")

    model = muygps_from_arrays(length_scale=LS, noise=NOISE, scale=1.0,
                               smoothness=NU)
    rng = np.random.default_rng(41)
    requests = [rng.uniform(size=(QUERIES, D)).astype(np.float32)
                for _ in range(3)]
    buckets = {}
    for engine in ("fused", "fast_mean"):
        servers, runs = {}, {}
        for route in ("kernel", "torch"):
            with mock.patch.object(
                    K, "query_order_route",
                    K.query_order_route if route == "kernel"
                    else (lambda *_: "torch")):
                servers[route] = FastServer(model, nbrs, train, targets,
                                            bucket=QUERIES, engine=engine)
                runs[route] = order_bucket(torch, servers[route], requests)
        kern, plain = runs["kernel"], runs["torch"]
        same = all(
            (a is None and b is None) or np.array_equal(a, b)
            for ok, op in zip(kern["outs"], plain["outs"])
            for a, b in zip(ok, op))
        rates = {"kernel": [], "torch": []}
        for route in ("kernel", "torch", "torch", "kernel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in requests:
                servers[route].predict(r)
            rates[route].append(3 * QUERIES / (time.perf_counter() - t0))
        log(f"{engine} bucket: outputs of the two query orders bit-equal "
            f"{same}; launches a request, kernel route "
            f"{json.dumps(kern['launches'])}, plain route "
            f"{json.dumps(plain['launches'])}; device activities a request "
            f"{kern['device_activities']} against "
            f"{plain['device_activities']}, busy us "
            f"{kern['device_busy_us']:.1f} against "
            f"{plain['device_busy_us']:.1f}; predictions/s (alternated) "
            f"{json.dumps(rates)}")
        assert same, f"the {engine} bucket differs between the query orders"
        assert kern["launches"].get("knn_query_order") == 1
        assert "knn_query_order/torch" not in kern["launches"]
        assert plain["launches"].get("knn_query_order/torch") == 1
        assert "knn_query_order" not in plain["launches"]
        assert kern["device_activities"] < plain["device_activities"]
        buckets[engine] = dict(
            rates=rates,
            device_activities={r: runs[r]["device_activities"]
                               for r in runs})
    # bytes: the queries read twice (grid, codes) and once gathered, the
    # padded rows, the permutation and its inverse written once
    nbytes = 8192 * 2 * 4 * 3 + 8192 * 2 * 4 + 2 * 8192 * 8
    row = bound_row(nbytes, 8192 * 2 * 4, design="one block",
                    **times[8192])
    return row, dict(equal=equal, sums=sums, times=times, buckets=buckets)


def k3_case(torch, name, prep, k, queries, train_used):
    """One K3 case against its plain version: the design the launcher
    takes (fused: the merge in the kernel) and the kept design with its
    _merge_decode, each timed, the kept design's key state against its
    mirror bit for bit, the cdist + topk yardstick and the bound.  Returns
    the kernels-line row."""
    from muygpys_torch.gpu import knn as K

    design = K.knn_design(prep.q.shape[1], k, prep.bins)
    assert design == "fused", f"{name} takes the {design} design"
    if prep.boxes is not None:
        prep.boxes.counts.zero_()
    ik, dk = K.knn_select(prep, k)
    torch.cuda.synchronize()
    walked = None if prep.boxes is None else int(prep.boxes.counts[1])
    ip, dp = K.knn_select_plain(prep, k)
    # the fused design selects exactly the k smallest keys, in ascending
    # order: the distances are the plain version's bits; equal keys may
    # come out in another order, so index sets are compared
    same_idx = float(
        (torch.sort(ik, 1).values == torch.sort(ip, 1).values)
        .float().mean()
    )
    bit_equal = bool(torch.equal(dk, dp))
    finite = torch.isfinite(dp)
    err = float((dk - dp)[finite].abs().max())
    s1k, s2k = prep.candidates()
    torch.cuda.synchronize()
    s1p, s2p = K.knn_candidates_plain(
        prep.q, prep.qsq, prep.tT, prep.tsq, prep.bins, prep.train_tile,
        prep.query_tile, prep.chunk_mask, prep.lb, prep.ub,
    )
    keys_equal = float(((s1k == s1p) & (s2k == s2p)).float().mean())
    log(f"K3 {name} ({prep.q.shape[0]} x {prep.tT.shape[1]}, bins "
        f"{prep.bins}, k {k}): fused d2 bit-equal {bit_equal}, index "
        f"slots agree {same_idx:.6f}, max_abs_err {err:.3e}; kept "
        f"design's s1/s2 equal on {keys_equal:.6f} of slots")
    assert bit_equal and same_idx >= 0.999, f"K3 {name} disagrees"
    assert keys_equal == 1.0, f"K3 {name} kept design disagrees"

    def fused():
        return K.knn_select(prep, k)

    def kept():
        return K.knn_select(prep, k, design="keys")

    times = dict(
        ms=time_ms(fused), device_ms=device_ms(torch, fused),
        kept_ms=time_ms(kept), kept_device_ms=device_ms(torch, kept),
    )
    plain_ms = time_ms(lambda: K.knn_select_plain(prep, k), reps=3,
                       trials=3)
    library_ms = time_ms(
        lambda: torch.topk(torch.cdist(queries, train_used), k, dim=1,
                           largest=False),
        reps=3, trials=3,
    )
    q_count, feat = prep.q.shape
    t_count = prep.tT.shape[1]
    extra = 0
    if walked is not None:
        # the boxes the bounded route's blocks walked, 8 queries each
        pairs = walked * K.BOX * 8
        extra = (prep.boxes.box.numel() + prep.boxes.norm.numel()) * 4
    elif prep.lb is None:
        pairs = q_count * t_count
    else:
        run = (prep.lb <= prep.ub[:, None]).sum().item()
        pairs = run * prep.query_tile * prep.train_tile
        extra = (prep.lb.numel() + prep.ub.numel()) * 4
    # each input read once, the (idx int64, d2 f32) result written once
    nbytes = ((q_count + t_count) * (feat + 1) * 4 + extra
              + q_count * k * 12)
    row = bound_row(
        nbytes, pairs * (2 * feat + 3), design=design, max_abs_err=err,
        plain_ms=plain_ms, library_ms=library_ms, **times,
    )
    log(f"K3 {name} time: fused {times['ms']:.4f} ms (device "
        f"{times['device_ms']:.4f}), kept design + merge "
        f"{times['kept_ms']:.4f} ms (device {times['kept_device_ms']:.4f})"
        f", plain {plain_ms:.4f} ms, cdist + topk {library_ms:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}; {pairs} pairs visited of "
        f"{q_count * t_count})")
    assert times["device_ms"] < times["kept_device_ms"], (
        f"K3 {name}: the fused design is not faster than the kept one")
    return row


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


def device_trace(torch, run, count=()):
    """Where the device time of ``run()`` goes, from a profiler trace.

    Only device activities (kernels, copies) are summed, never the host ops
    that launched them, so no kernel counts twice; busy time is the union of
    their intervals.  The idle share divides it by the median wall time of
    the same work without the profiler, which slows the host.  ``count``
    names kernels whose launches in the trace are counted (by substring)."""
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
        **({"launches_of": {k: sum(k in name for _, _, name in spans)
                            for k in count}} if count else {}),
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
        dict(bound_ms=max(byte_ms, op_ms),
             bound_by="bytes" if byte_ms > op_ms else "operations",
             library_ms=None),
        **numbers,
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
        k1_design,
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
            if nu == NU_GEN:
                designs = k1_designs(torch, args, "gen", (mp, vp), (tol_m, tol_v))
            if dtype == torch.float32 and nu == NU_GEN:
                ms = designs[k1_design(n, r, dtype, "gen")]["ms"]
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
                row = k1_row(
                    designs, nbytes, ops, max_abs_err=max(err_m, err_v),
                    plain_ms=plain_ms, k4_ns_per_element=k4_ns,
                    k4_branches=dict(zip(("zero", "small", "tail"), counts)),
                )
                log(f"K1 gen f32 time: {row['design']} design {ms:.4f} ms "
                    f"(device {row['device_ms']:.4f}), kept design "
                    f"{row['kept_ms']:.4f} ms (device "
                    f"{row['kept_device_ms']:.4f}) (closed form "
                    f"{closed_ms:.4f} ms: K4 costs {k4_ns:.4f} ns per "
                    f"element), plain {plain_ms:.4f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes} "
                    f"B, {ops:.0f} flop; entries by branch {counts})")
    return row


def cf2_steps(nu, ts, np_dtype):
    """How many CF2 steps kve takes at each t of ``ts`` before it freezes
    (muygpys_torch/ops/bessel.py:_kve_cf2, values alone, in the dtype)."""
    import numpy as np

    one = np_dtype(1)
    eps = np_dtype(np.finfo(np_dtype).eps * 0.01)
    big = np_dtype(np.finfo(np_dtype).max * 1e-8)
    v = abs(np_dtype(nu))
    mu = v - np.floor(v + np_dtype(0.5))
    steps = []
    for x in np.asarray(ts, np_dtype):
        b = np_dtype(2) * (one + x)
        d = one / b
        h = delh = d
        a1 = np_dtype(0.25) - mu * mu
        q, a, s, u, w = a1, -a1, one + a1 * delh, np_dtype(0), a1
        for i in range(2, 81):
            a = a - np_dtype(2 * (i - 1))
            contrib = -(u - b * w) / np_dtype(i)
            q = q + contrib
            u = -a * w / np_dtype(i)
            w = contrib
            b = b + np_dtype(2)
            d = one / (b + a * d)
            delh = (b * d - one) * delh
            h = h + delh
            s = s + q * delh
            if abs(delh) <= eps * abs(h) or max(abs(u), abs(w)) > big:
                break
        steps.append(i - 1)
    return steps


def k4_constructor_ops(nu, dtype_name):
    """Floating-point operations of one constructor launch at ``nu`` (a
    value and a tangent each step): ~55 a CF2 step at each tail node (this
    run's step counts), 12 a recurrence step (n of them), 40 a node besides;
    c and its tangent 4 NTAIL^2; ~60 a series term; 2 NTAIL for cp."""
    import numpy as np

    from muygpys_torch.gpu import matern_nu as tm

    np_dtype = np.float32 if dtype_name == "float32" else np.float64
    n = math.floor(nu + 0.5)
    nodes = sum(55 * k + 12 * n + 40
                for k in cf2_steps(nu, tm._NODES_T, np_dtype))
    return nodes + 4 * tm.NTAIL**2 + 60 * tm.KSM + 2 * tm.NTAIL


def k4_coeffs_readings(torch, got, want):
    """How far a coefficient vector ``got`` lies from ``want`` before
    matern_nu.coeffs_limits' floors: each set's largest error over
    COEFFS_CHECK_RTOL times the set's largest magnitude; and
    ``cancel_floor``, the least COEFFS_CANCEL_FLOOR that would cover a, ap
    and da (their errors beyond the set's own limit in eps max|q|,
    (KSM - 1) eps max|q| and eps max|dq|)."""
    from muygpys_torch.gpu import matern_nu as tm

    eps = torch.finfo(want.dtype).eps
    rtol = tm.COEFFS_CHECK_RTOL[want.dtype]
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    err, mag = abs(got - want), abs(want)
    out, base = {}, {}
    for name, (lo, hi) in tm.COEFF_SETS.items():
        if lo < mag.size:
            base[name] = rtol * mag[lo:hi].max()
            out[name] = float(err[lo:hi].max() / base[name]) if base[
                name] > 0 else (0.0 if err[lo:hi].max() == 0 else math.inf)
    unit_q = eps * mag[slice(*tm.COEFF_SETS["q"])].max()
    units = {"a": unit_q, "ap": (tm.KSM - 1) * unit_q}
    if mag.size > tm._OFF_DA:
        units["da"] = eps * mag[slice(*tm.COEFF_SETS["db"])].max()
    out["cancel_floor"] = max(
        float((err[slice(*tm.COEFF_SETS[name])] - base[name]).max() / unit)
        for name, unit in units.items())
    return out


def phase_k4_constructor(torch):
    """K4's constructor kernel (csrc/matern_nu_coeffs.cu) against its plain
    version on the card over matern_nu.COEFFS_CHECK_NUS, f32 and f64, with
    and without the nu-tangent sets, each set within COEFFS_CHECK_RTOL times
    its scale (matern_nu.coeffs_limits before its floors); those readings,
    and the plain version on the CPU against the plain version on the card
    (what the floors are for); timed at the free-nu headline's order (f32,
    tangent sets: what a free-nu objective evaluation builds) beside the
    plain version on the card and an empty kernel; returns its kernels-line
    row."""
    import numpy as np

    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu import matern_nu as tm

    worst = {}
    readings = {"kernel_vs_plain": {}, "plain_cpu_vs_card": {}}
    row_err = None
    for dtype in (torch.float32, torch.float64):
        key = str(dtype)[6:]
        for nu in tm.COEFFS_CHECK_NUS:
            for need_dnu in (False, True):
                t = torch.tensor(nu, dtype=dtype, device="cuda")
                before = _build.launches["matern_nu_coeffs"]
                got = tm.matern_nu_coeffs(t, need_dnu)
                torch.cuda.synchronize()
                assert _build.launches["matern_nu_coeffs"] == before + 1
                want = tm.matern_nu_coeffs_plain(t, need_dnu)
                assert torch.isfinite(got).all() and got.shape == want.shape
                r = k4_coeffs_readings(torch, got, want)
                worse = max((n for n in r if n != "cancel_floor"), key=r.get)
                worst[key] = max(worst.get(key, 0.0), r[worse])
                if need_dnu:
                    readings["kernel_vs_plain"][f"{key} {nu}"] = r
                    readings["plain_cpu_vs_card"][f"{key} {nu}"] = (
                        k4_coeffs_readings(torch, tm.matern_nu_coeffs_plain(
                            t.cpu(), need_dnu), want))
                if dtype == torch.float32 and nu == NU_GEN and need_dnu:
                    row_err = float((got - want).abs().max())
                assert r[worse] <= 1.0, (
                    f"K4 constructor {key} nu={nu} need_dnu={need_dnu}: set "
                    f"{worse} off by {r[worse]:.3f} of COEFFS_CHECK_RTOL "
                    "times its scale")
    log("K4 constructor against its plain version, worst error as a share "
        "of COEFFS_CHECK_RTOL times each set's scale (no floor) over "
        f"{len(tm.COEFFS_CHECK_NUS)} orders: " + json.dumps(worst))
    for what, table in readings.items():
        log(f"K4 {what} before the floors, with the nu-tangent sets (each "
            "set's error over COEFFS_CHECK_RTOL x its scale; cancel_floor in "
            "eps max|q|, COEFFS_CANCEL_FLOOR = "
            f"{tm.COEFFS_CANCEL_FLOOR}): " + json.dumps(
                {k: {n: float(f"{x:.3g}") for n, x in v.items()}
                 for k, v in table.items()}))
        worst_of = {}
        for case, numbers in table.items():
            w = worst_of.setdefault(case.split()[0], {})
            for name, x in numbers.items():
                w[name] = max(w.get(name, -math.inf), x)
        log(f"K4 {what} worst over the orders: " + json.dumps(worst_of))

    t = torch.tensor(NU_GEN, dtype=torch.float32, device="cuda")

    def build():
        return tm.matern_nu_coeffs(t, need_dnu=True)

    ms = time_ms(build)
    dev_ms = device_ms(torch, build)
    host_ms = wall_ms(torch, build, reps=11)
    plain_ms = wall_ms(
        torch, lambda: tm.matern_nu_coeffs_plain(t, need_dnu=True), reps=3)
    plain_trace = device_trace(
        torch, lambda: tm.matern_nu_coeffs_plain(t, need_dnu=True))
    empty_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    nbytes = (tm._NODES_T.size + 2 * tm.KSM + tm.NTAIL**2 + 1
              + tm._LEN_DNU) * 4
    ops = k4_constructor_ops(NU_GEN, "float32")
    steps = cf2_steps(NU_GEN, tm._NODES_T, np.float32)
    row = bound_row(
        nbytes, ops, max_abs_err=row_err, ms=ms, device_ms=dev_ms,
        host_ms=host_ms, plain_ms=plain_ms,
        plain_device_launches=plain_trace["device_activities"],
        empty_kernel_device_ms=empty_ms,
        worst_share_of_limit=worst,
    )
    log(f"K4 constructor f32 nu={NU_GEN} with the nu-tangent sets: "
        f"{ms:.4f} ms queued (device {dev_ms:.4f}, host clock {host_ms:.4f} "
        f"ms a call); plain version on the card {plain_ms:.1f} ms on the "
        f"host clock, {plain_trace['device_activities']} device activities; "
        f"an empty kernel {empty_ms:.4f} ms device; bound "
        f"{row['bound_ms']:.2e} ms ({row['bound_by']}; {nbytes} B, {ops} "
        f"flop, estimated); CF2 steps at the nodes {min(steps)}-{max(steps)} "
        "(computed on the host from nu and the nodes by a copy of the freeze "
        "test, not read from the kernel)")
    return row


def phase_k4_scipy(torch):
    """K4 alone against scipy.special.kv on a t grid, through the kernel:
    K1b with one neighbor, unit length scale and no noise returns
    mean = phi(t) . 1 for y = 1.  f64 with the tensor constructor (what f64
    training evaluates), f32 with the host constructor (what a server
    evaluates), as tests/test_matern_nu.py certifies them; f64 also with
    the vector the constructor kernel builds on the card (what f64 training
    on the card evaluates)."""
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
        for dtype, floor, built in ((torch.float64, 1e-6, "cpu"),
                                    (torch.float64, 1e-6, "cuda"),
                                    (torch.float32, 1e-4, "host")):
            if built == "host":
                co = host_coeffs(torch, nu, dtype)
            else:
                co = matern_nu_coeffs(
                    torch.tensor(nu, dtype=dtype, device=built)).cuda()
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
            key = f"{str(dtype)[6:]} built {built}"
            worst[key] = max(worst.get(key, 0.0), err / limit)
            log(f"K4 {key} nu={nu}: mixed error against scipy kv "
                f"{err:.3e} (limit {limit:.0e}) on {B} points, t in [0, 80]")
            assert err <= limit, f"K4 is off scipy's kv at nu={nu}: {err}"
    return worst


def k1b_designs(torch, args, smoothness, power, plain, tol):
    """Both K1b designs at one shape through the private launcher
    (designs_timed)."""
    from muygpys_torch.gpu import fused_predict as F
    from muygpys_torch.gpu import matern_nu as _nu

    pw, cw, y, params, gen = args
    code = _nu.check_smoothness("K1b", smoothness, gen, power, _nu._LEN_VAL)
    gen = None if gen is None else gen[:_nu._LEN_VAL].contiguous()
    return designs_timed(
        torch, f"K1b {str(pw.dtype)[6:]} nu={smoothness}",
        lambda design: F._launch_dists(pw, cw, y, params, gen, code, power,
                                       smoothness, design=design),
        plain, tol)


def k1b_library(torch, pw, cw, y, params):
    """K1b's (mean, var) at the headline (Matern 3/2, l2) through library
    calls on K formed elementwise from pw / ls plus the nugget:
    torch.linalg.cholesky + torch.cholesky_solve + einsum, batch first.  A
    yardstick of speed; the port never calls it."""
    ls, noise = float(params[0]), float(params[1])
    eye = torch.eye(pw.shape[0], dtype=pw.dtype, device=pw.device)

    def run():
        return library_posterior(torch, pw.permute(2, 0, 1) / ls, cw.T / ls,
                                 y, noise, eye)

    return run


def phase_k1b(torch, knn_inputs):
    """K1b (the solve from distances) against its plain version at the
    serving shape, on the distances of the same neighborhoods, through the
    launcher's design (registers); at the headline (f32 and f64, nu = 3/2)
    and at nu = 1.2 (f32) both designs checked and timed, beside the library
    yardstick at nu = 3/2."""
    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu.fused_predict import (
        fused_predict_bl,
        fused_predict_bl_plain,
        k1_design,
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
            smoothness = "gen" if gen else nu
            pw = (f2_p.sqrt() if power == 1 else f2_p).to(dtype).contiguous()
            cw = (f2_c.sqrt() if power == 1 else f2_c).to(dtype).contiguous()
            co = host_coeffs(torch, nu, dtype) if gen else None
            args = (pw, cw, y, params, co)
            kw = dict(smoothness=smoothness, metric_power=power)
            design = k1_design(n, r, dtype, smoothness)
            before = _build.launches[f"fused_predict/{design}"]
            mk, vk = fused_predict_bl(*args, **kw)
            torch.cuda.synchronize()
            assert _build.launches[f"fused_predict/{design}"] == before + 1
            mp, vp = fused_predict_bl_plain(*args, **kw)
            assert torch.isfinite(mk).all() and torch.isfinite(vk).all()
            err_m = float((mk - mp).abs().max())
            err_v = float((vk - vp).abs().max())
            tol_m, tol_v = tol[dtype]
            v_min = float(vp.abs().min())
            log(f"K1b {str(dtype)[6:]} nu={nu} power={power} ({design}): "
                f"mean max_abs_err={err_m:.3e} (tol {tol_m:.0e}), var "
                f"max_abs_err={err_v:.3e} (tol {tol_v:.0e}; var min "
                f"{v_min:.3e})")
            assert tol_v <= 0.1 * v_min, "variance gate too loose"
            assert err_m <= tol_m, f"K1b mean disagrees: {err_m}"
            assert err_v <= tol_v, f"K1b var disagrees: {err_v}"
            if nu not in (NU, NU_GEN) or (dtype == torch.float64 and gen):
                continue
            designs = k1b_designs(torch, args, smoothness, power, (mp, vp),
                                  (tol_m, tol_v))
            if dtype == torch.float64:
                row["f64_device_ms"] = designs["registers"]["device_ms"]
                row["f64_kept_device_ms"] = designs["shared"]["device_ms"]
                log(f"K1b f64 nu={nu}: registers device "
                    f"{row['f64_device_ms']:.4f} ms, shared device "
                    f"{row['f64_kept_device_ms']:.4f} ms")
                continue
            plain_ms = time_ms(lambda: fused_predict_bl_plain(*args, **kw),
                               reps=3, trials=3)
            entries = (n * (n + 1) // 2 + n) * B
            if gen:
                iu = torch.triu_indices(n, n, device="cuda")
                u = torch.cat([pw[iu[0], iu[1]], cw]) / LS
                eval_ops = k4_ops(
                    k4_branch_counts(co[0] * u), serve_tail_terms(dtype)
                ) / entries
            else:
                eval_ops = 6.0
            # the table's rule: pw symmetric, its n(n+1)/2 rows i >= j; and
            # what the kernel must read, the whole square (the elimination
            # reads both triangles of a pw it cannot assume symmetric)
            rest = (n + n * r + r + 1) * B + 2 + (73 if gen else 0)
            nbytes = (n * (n + 1) // 2 * B + rest) * 4
            full_bytes = (n * n * B + rest) * 4
            ops = k1_ops_per_query(n, d, r, eval_ops, coords=False) * B
            numbers = bound_row(
                nbytes, ops, max_abs_err=max(err_m, err_v),
                design=design, ms=designs[design]["ms"],
                device_ms=designs[design]["device_ms"],
                kept_ms=designs["shared"]["ms"],
                kept_device_ms=designs["shared"]["device_ms"],
                plain_ms=plain_ms,
            )
            # computed like bound_ms, and logged only
            whole_square_ms = max(full_bytes / HBM_BYTES_PER_S,
                                  ops / FP32_FLOPS) * 1e3
            log(f"K1b f32 nu={nu} time: {design} design "
                f"{numbers['ms']:.4f} ms (device {numbers['device_ms']:.4f}), "
                f"kept design {numbers['kept_ms']:.4f} ms (device "
                f"{numbers['kept_device_ms']:.4f}), plain {plain_ms:.4f} ms, "
                f"bound {numbers['bound_ms']:.4f} ms ({numbers['bound_by']}; "
                f"{nbytes} B, {ops:.0f} flop), computed from the whole square "
                f"{whole_square_ms:.4f} ms ({full_bytes} B)")
            if gen:
                row.update({f"gen_{k}": numbers[k] for k in (
                    "ms", "device_ms", "kept_ms", "kept_device_ms",
                    "bound_ms", "plain_ms")})
            else:
                row = numbers
                row["library_ms"] = time_ms(
                    k1b_library(torch, pw, cw, y, params), reps=5, trials=3)
                log(f"K1b f32 library (cholesky + cholesky_solve on K formed "
                    f"elementwise): {row['library_ms']:.4f} ms")
    assert row["device_ms"] < row["kept_device_ms"], (
        f"the K1b register design is not faster at the headline: {row}")
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

    def judge(label, got):
        """Phase 7's gates on another optimizer's f32 optimum: its f64
        objective and its parameters against the CPU f64 optimum."""
        v_got = f64_objective(got)
        rel_got = abs(v_got - v_cpu) / abs(v_cpu)
        params = {k: abs(got[k] / ref_vals[k] - 1) for k in F32_PARAM_RTOL}
        log(f"{label}: f64 objective {v_got!r} against the CPU f64 "
            f"optimum's {v_cpu!r}: relative {rel_got:.3e} (limit "
            f"{OBJECTIVE_RTOL:.0e}); parameters relative {json.dumps(params)} "
            f"(limits {json.dumps(F32_PARAM_RTOL)})")
        assert rel_got <= OBJECTIVE_RTOL, f"{label} is not at the f64 optimum"
        for key, limit in F32_PARAM_RTOL.items():
            assert params[key] <= limit, f"{label} {key} is off the optimum"
        return dict(objective_relative=rel_got, parameters_relative=params)

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
        launches=launches, trace=trace, judge=judge,
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
    launches = dict(_build.launches)
    trained.optimize_scale(pw, bnt)
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
    assert launches["matern_nu_coeffs"] == launches["fused_train_stats"], (
        "the coefficient vector was not built by one constructor launch "
        f"per evaluation: {launches}"
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

    # medians of 11 (the plain build on the CPU: 3), and a trace of 2
    # evaluations
    build_card_ms = wall_ms(torch, build_on("cuda"), reps=11)
    build_device_ms = device_ms(torch, build_on("cuda"))
    build_cpu_ms = wall_ms(torch, build_on("cpu"), reps=3)
    stats = obj32._stats_fn(torch.stack(
        [torch.tensor(float(at.get(k, v)), device="cuda")
         for k, v in obj32._defaults.items()]
    ))
    epilogue_ms = wall_ms(torch, lambda: obj32._epilogue(stats))
    eval_ms = wall_ms(torch, lambda: obj32(at), reps=11)
    trace = device_trace(torch, lambda: [obj32(at) for _ in range(2)],
                         count=("matern_nu_coeffs_kernel",
                                "fused_train_stats_regs_kernel"))
    # the profiler may miss whole evaluations of a traced window (it caught
    # one of two here on the H100), so the trace is held to one constructor
    # launch per K2 launch; the launch counts above hold the exact number
    assert (trace["launches_of"]["matern_nu_coeffs_kernel"]
            == trace["launches_of"]["fused_train_stats_regs_kernel"] >= 1), (
        "the trace does not hold one constructor launch per K2 launch: "
        f"{json.dumps(trace)}"
    )
    log(f"train free nu: one objective evaluation {eval_ms:.3f} ms on the "
        f"host's clock = coefficient constructor {build_card_ms:.3f} ms (one "
        f"launch on the card, f32, with the nu-tangent sets, device "
        f"{build_device_ms:.4f} ms; its plain version {build_cpu_ms:.3f} ms "
        f"on this host's CPU) + K2 {k2_gen_ms:.4f} ms + epilogue "
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
                           build_card=build_card_ms,
                           build_card_device=build_device_ms, k2=k2_gen_ms,
                           epilogue=epilogue_ms),
        launches=launches, trace=trace,
        reference=(exact, v_lanes, v_start),
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


def phase_knn_exact(torch, train, queries, k=SHEAR_NN):
    """The exact kernel against its plain version on ``train`` (numpy, f32)
    and ``queries``: distances bit-equal to the plain version's and to the
    tiled library search's (``_brute_force_knn`` + ``_refine_knn``, its
    train tiles built once as NN_Wrapper built them), sorted index sets
    equal on >= 99.9% of queries, one launch counted; the share of tiles
    scored; the kernel, the plain version and the library search timed.
    Returns the kernels-line row."""
    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu import knn_exact as X
    from muygpys_torch.neighbors import (
        _brute_force_knn,
        _refine_knn,
        _train_tiles,
    )

    train_d = torch.as_tensor(train, device="cuda")
    q = torch.as_tensor(queries, device="cuda").contiguous()
    index = X.build_exact_index(train_d)
    nt = X.tile_count(index)
    X.knn_exact_select(index, q, k)  # build and warm up
    torch.cuda.synchronize()
    before, scored = _build.launches["knn_exact_select"], int(index.scored)
    idx, d2 = X.knn_exact_select(index, q, k)
    torch.cuda.synchronize()
    launched = _build.launches["knn_exact_select"] - before
    share = (int(index.scored) - scored) / (len(queries) * nt)
    ip, dp = X.knn_exact_select_plain(index, q, k)
    tiles = _train_tiles(train_d)

    def library():
        cand, _ = _brute_force_knn(train_d, q, k + 32, tiles=tiles)
        return _refine_knn(train_d, q, cand, k)

    il, dl = library()
    same_plain = float((torch.sort(idx, 1).values == torch.sort(ip, 1).values)
                       .all(1).float().mean())
    same_library = float((torch.sort(idx, 1).values
                          == torch.sort(il, 1).values).all(1).float().mean())
    bit_plain, bit_library = bool(torch.equal(d2, dp)), bool(torch.equal(d2, dl))
    label = f"exact kernel ({len(queries)} x {len(train)}, k {k})"
    log(f"{label}: {launched} launch; d2 bit-equal to the plain version "
        f"{bit_plain}, to the library search {bit_library}; sorted sets "
        f"equal on {same_plain:.6f} (plain), {same_library:.6f} (library) "
        f"of queries; {share:.5f} of {nt} tiles scored")
    assert launched == 1, f"{label}: {launched} launches counted"
    assert bit_plain and bit_library, f"{label}: distances differ"
    assert min(same_plain, same_library) >= 0.999, f"{label}: sets differ"

    def kernel():
        return X.knn_exact_select(index, q, k)

    times = dict(ms=time_ms(kernel), device_ms=device_ms(torch, kernel))
    plain_ms = time_ms(lambda: X.knn_exact_select_plain(index, q, k),
                       reps=3, trials=3)
    library_ms = time_ms(library, reps=3, trials=3)
    q_count, feat = q.shape
    # the queries and the index (rows, boxes, first codes) read once, the
    # (idx int64, d2 f32) result written once; per query a box test of
    # every tile (3 f operations) and 3 f operations a row of each tile
    # scored: the work the pruning leaves
    nbytes = (q_count * feat + len(train) * feat + nt * (2 * feat + 1)) * 4 \
        + q_count * k * 12
    ops = q_count * nt * (share * X.TILE + 1) * 3 * feat
    row = bound_row(nbytes, ops, plain_ms=plain_ms, library_ms=library_ms,
                    tiles_scored_share=share,
                    unpruned_bound_ms=q_count * len(train) * 3 * feat
                    / FP32_FLOPS * 1e3,
                    **times)
    log(f"{label} time: {times['ms']:.4f} ms (device "
        f"{times['device_ms']:.4f}), plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}; the unpruned scan's "
        f"{row['unpruned_bound_ms']:.4f})")
    return row


def captured_vs_eager(torch, label, server, requests):
    """A served bucket replays the graph the server captured at its first
    bucket (FastServer on a card).  Request by request (each one bucket):
    the captured outputs against the eager core's on the same padded
    inputs, bit for bit, and the launches of each kernel design, which
    must be the same.  The index's own search runs before the bucket and
    outside its graph: on the exact kernel's route one launch of it a
    request, counted apart.  Then predictions/s of both, alternated
    (captured, eager, eager, captured), and a profiler trace of each."""
    import statistics

    import numpy as np

    from muygpys_torch.gpu import _build

    assert server._capture and server._captured is not None, (
        f"{label}: the server did not capture its bucket"
    )
    exact_searches = int(server.engine != "fused"
                         and getattr(server.nbrs, "_exact", None) is not None)
    for req in requests:
        assert len(req) <= server.bucket
        torch.cuda.synchronize()
        _build.reset_launches()
        got = server.predict(req)
        captured = dict(_build.launches)
        _build.reset_launches()
        eager = [t.cpu().numpy() for t in server._core(*server._captured.inputs)]
        eager_launches = dict(_build.launches)
        for g, e in zip(got, eager):
            assert np.array_equal(g, e[:len(req)]), (
                f"{label}: the captured bucket differs from the eager core"
            )
        searches = captured.pop("knn_exact_select")
        assert eager_launches.pop("knn_exact_select") == 0
        assert searches == exact_searches, (
            f"{label}: {searches} exact-kernel searches a request, not "
            f"{exact_searches}"
        )
        assert captured == eager_launches, (
            f"{label}: launches differ: captured {captured}, eager "
            f"{eager_launches}"
        )
    rates = {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured"):
        server._capture = mode == "captured"
        rates[mode].append(serve(torch, server, requests)[2])
    traces = {}
    for mode in ("captured", "eager"):
        server._capture = mode == "captured"
        traces[mode] = device_trace(
            torch, lambda: [server.predict(r) for r in requests]
        )
        traces[mode]["device_activities_per_bucket"] = (
            traces[mode]["device_activities"] / len(requests)
        )
    server._capture = True
    out = dict(
        captured_preds_per_s=statistics.median(rates["captured"]),
        eager_preds_per_s=statistics.median(rates["eager"]),
        rates=rates, launches_per_request=captured,
        exact_searches_per_request=exact_searches,
        capture_ms=server._captured.capture_ms,
        trace=traces["captured"], eager_trace=traces["eager"],
    )
    log(f"{label}: captured buckets bit-equal to the eager core on "
        f"{len(requests)} requests, the same launches ({captured}), "
        f"{exact_searches} exact-kernel search a request before the bucket; "
        f"predictions/s captured {rates['captured']}, eager "
        f"{rates['eager']} (alternated); capture "
        f"{out['capture_ms']:.1f} ms; device trace captured "
        f"{json.dumps(traces['captured'])}; eager "
        f"{json.dumps(traces['eager'])}")
    return out


def device_train_run(torch, label, model_fn, data32):
    """The device chassis on the card in f32 through K2:
    Fused_Device_LBFGS_optimize(engine="kernel") (counts zeroed just
    before, read just after: a warm-up step, a capture, replays); then the
    same trajectory built again and run twice, the second run replaying
    its graph (the steady rate), and a profiler trace of a third.  Returns
    (the trained model's values, the run's numbers)."""
    from muygpys_torch.convert import arrays_from_muygps
    from muygpys_torch.gpu import _build
    from muygpys_torch.optimize import Fused_Device_LBFGS_optimize
    from muygpys_torch.optimize.device_chassis import (
        STEPS_PER_REPLAY,
        _fused_trajectory,
    )

    torch.cuda.synchronize()
    _build.reset_launches()
    info = {}
    trained = Fused_Device_LBFGS_optimize(model_fn(), *data32,
                                          engine="kernel", info=info)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    # the eager warm-up step, then every step of every replay
    steps = info["replays"] * STEPS_PER_REPLAY
    assert launches["fused_train_stats"] == 1 + steps, (
        f"{label}: K2 did not run once per captured step: {launches}, "
        f"{info}"
    )
    run, _, _, z0 = _fused_trajectory(model_fn(), *data32)
    run.run(z0)
    steady = run.run(z0)
    assert steady["capture_ms"] == 0.0 and run.captures == 1
    assert steady["evaluations"] == info["evaluations"]
    trace = device_trace(torch, lambda: run.run(z0))
    numbers = dict(
        iterations=info["iterations"], evaluations=info["evaluations"],
        replays=info["replays"], steps_per_replay=STEPS_PER_REPLAY,
        steps=steps, capture_ms=info["capture_ms"], wall_ms=info["wall_ms"],
        evaluations_per_s=info["evaluations"] / (info["wall_ms"] / 1e3),
        steady_wall_ms=steady["wall_ms"],
        steady_evaluations_per_s=(
            steady["evaluations"] / (steady["wall_ms"] / 1e3)
        ),
        device_us_per_step=(
            (trace["device_busy_us"] or 0.0)
            / (steady["replays"] * STEPS_PER_REPLAY)
        ),
        trace=trace, launches=launches,
    )
    log(f"{label} (device chassis, card, f32, K2): "
        f"{info['iterations']} L-BFGS iterations, {info['evaluations']} "
        f"evaluations, {info['replays']} replays of {STEPS_PER_REPLAY} "
        f"steps (= host reads of done), capture {info['capture_ms']:.1f} ms, "
        f"run {info['wall_ms']:.2f} ms = "
        f"{numbers['evaluations_per_s']:.1f} evaluations/s; replayed again "
        f"{steady['wall_ms']:.2f} ms = "
        f"{numbers['steady_evaluations_per_s']:.1f} evaluations/s; device "
        f"{numbers['device_us_per_step']:.1f} us a step; trace "
        f"{json.dumps(trace)}; launches {launches}")
    return arrays_from_muygps(trained), numbers


def inside_bounds(vals, bounds):
    for key, (lo, hi) in bounds.items():
        assert min(vals[key] - lo, hi - vals[key]) > 1e-6 * (hi - lo), (
            f"trained {key} {vals[key]} ran to a bound"
        )


def phase_device_train(torch, data32, judge):
    """(b) The training headline on the device chassis, held to the CPU
    f64 optimum by ``judge`` (phase 7's gates)."""
    vals, numbers = device_train_run(torch, "device train", train_model,
                                     data32)
    inside_bounds(vals, {"length_scale": LS_BOUNDS, "noise": NOISE_BOUNDS})
    numbers.update(judge("device train", vals), length_scale=vals[
        "length_scale"], noise=vals["noise"])
    return numbers


def phase_device_train_free_nu(torch, data32, exact, v_lanes, v_start):
    """(b) The free-smoothness headline on the device chassis: one
    constructor launch per K2 launch, and the exact f64 objective at its
    optimum held to the lanes engine's (phase 12's gate)."""
    vals, numbers = device_train_run(torch, "device train free nu",
                                     free_nu_model, data32)
    launches = numbers["launches"]
    assert launches["matern_nu_coeffs"] == launches["fused_train_stats"], (
        f"not one constructor launch per K2 launch: {launches}"
    )
    inside_bounds(vals, {"length_scale": LS_BOUNDS, "noise": NOISE_BOUNDS,
                         "smoothness": NU_BOUNDS})
    v_dev = exact(vals)
    short = (v_lanes - v_dev) / abs(v_lanes)
    log(f"device train free nu: length_scale {vals['length_scale']!r}, "
        f"noise {vals['noise']!r}, smoothness {vals['smoothness']!r}; exact "
        f"f64 objective {v_dev!r} against the lanes optimum's {v_lanes!r}: "
        f"short by {short:.3e} relative (limit {GEN_OBJECTIVE_RTOL:.0e})")
    assert v_dev > v_start, "training did not improve the exact objective"
    assert short <= GEN_OBJECTIVE_RTOL, (
        "the device chassis' optimum is worse than the lanes engine's"
    )
    numbers.update(vals, objective_f64=dict(card=v_dev, lanes=v_lanes,
                                            short=short))
    return numbers


def phase_device_trainer(torch, data32, batch2_32, judge):
    """(c) make_device_trainer (the batched-layout objective under
    autograd, f32) on two LOO batches of the headline: one capture for
    both; the first batch held to phase 7's gates, the second to the same
    gates against the f64 fused chassis on the card on that batch."""
    from muygpys_torch.convert import arrays_from_muygps
    from muygpys_torch.optimize import (
        Fused_L_BFGS_B_optimize,
        make_device_trainer,
    )
    from muygpys_torch.optimize.fused_objective import (
        make_fused_train_objective,
    )

    trainer = make_device_trainer(train_model())
    m1, info1 = trainer(*data32)
    m2, info2 = trainer(*batch2_32, z_init=info1["z"])
    assert trainer.captures() == 1 and trainer.cache_size() == 1, (
        "the second batch was captured anew"
    )
    assert info2["capture_ms"] == 0.0
    v1, v2 = arrays_from_muygps(m1), arrays_from_muygps(m2)
    for vals in (v1, v2):
        inside_bounds(vals, {"length_scale": LS_BOUNDS,
                             "noise": NOISE_BOUNDS})
    first = judge("device trainer, batch 1", v1)
    data64 = tuple(t.double() for t in batch2_32)
    ref = arrays_from_muygps(Fused_L_BFGS_B_optimize(train_model(), *data64))
    obj64, _ = make_fused_train_objective(train_model(), *data64)

    def f64(v):
        return float(obj64({"length_scale": v["length_scale"],
                            "noise": v["noise"]})[0])

    rel = abs(f64(v2) - f64(ref)) / abs(f64(ref))
    log(f"device trainer: batch 1 {info1['iterations']} iterations, "
        f"{info1['evaluations']} evaluations, {info1['replays']} replays, "
        f"capture {info1['capture_ms']:.1f} ms, {info1['wall_ms']:.1f} ms; "
        f"batch 2 (warm start, no capture) {info2['iterations']} "
        f"iterations, {info2['evaluations']} evaluations, "
        f"{info2['wall_ms']:.1f} ms: length_scale {v2['length_scale']!r}, "
        f"noise {v2['noise']!r}, f64 objective relative to the f64 fused "
        f"chassis' optimum on that batch {rel:.3e} (limit "
        f"{OBJECTIVE_RTOL:.0e}); captures {trainer.captures()}")
    assert rel <= OBJECTIVE_RTOL, "batch 2 is not at its f64 optimum"
    return dict(
        batch1=dict(v1, **first, iterations=info1["iterations"],
                    evaluations=info1["evaluations"],
                    replays=info1["replays"],
                    capture_ms=info1["capture_ms"],
                    wall_ms=info1["wall_ms"]),
        batch2=dict(v2, objective_relative=rel,
                    iterations=info2["iterations"],
                    evaluations=info2["evaluations"],
                    replays=info2["replays"], wall_ms=info2["wall_ms"]),
        captures=trainer.captures(),
    )


def fast_stages(torch, model, nbrs, train_d, targets_d):
    """The seconds of make_fast_regressor's three steps, each called alone
    with a synchronize after it: neighbours (get_batch_nns: K3p, the
    re-rank and the indices to the host), tensors (fast_nn_update, the
    deformation's pairwise tensor, the kernel) and factorization
    (fast_coefficients).  Returns (coefficients, seconds by stage)."""
    import numpy as np

    from muygpys_torch.ops.tensors import fast_nn_update

    t0 = time.perf_counter()
    batch_nn, _ = nbrs.get_batch_nns(np.arange(train_d.shape[0]))
    t1 = time.perf_counter()
    nn_fast = fast_nn_update(torch.as_tensor(batch_nn, device="cuda"))
    Kin = model.kernel(model.kernel.deformation.pairwise_tensor(
        train_d, nn_fast))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    coeffs = model.fast_coefficients(Kin, targets_d[nn_fast])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return coeffs, dict(neighbours_s=t1 - t0, tensors_s=t2 - t1,
                        factorization_s=t3 - t2)


def phase_fast_mean(torch, card, trained, train, y_train, nbrs, requests,
                    train_sorted):
    """The fast posterior mean at the serving headline (phase 16): the
    K2-trained model through a checkpoint file and back, served bit for
    bit by the fused engine from both; the offline precompute over all
    50,000 training points through NN_Wrapper(nn_method="kernel") (K3p at
    1024 bins); the fast state through a file; the three requests served
    at one kernel evaluation and one contraction each; a two-response
    MultivariateMuyGPS.  Returns (the phase's numbers, the launches of the
    path, the kernels-line row of K3p at the precompute's shape)."""
    import statistics
    import tempfile

    import numpy as np

    from muygpys_torch import checkpoint
    from muygpys_torch.convert import arrays_from_muygps, mmuygps_from_arrays
    from muygpys_torch.examples.fast_posterior_mean import (
        fast_posterior_mean_serve,
        make_fast_multivariate_regressor,
        make_fast_regressor,
    )
    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu import knn as K
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    out = {}
    train_d = torch.as_tensor(train, device="cuda")
    y_d = torch.as_tensor(y_train, dtype=torch.float32, device="cuda")
    # (a) the trained model through a file and back
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.json")
        checkpoint.save_model(path, trained)
        restored = checkpoint.load_model(path)
        with open(path) as f:
            out["checkpoint_bytes"] = len(f.read())
    assert restored == trained, "the restored model differs"
    servers = [
        FastServer(m, nbrs, train, y_train, bucket=QUERIES, engine="fused")
        for m in (trained, restored)
    ]
    first = [s.predict(requests[0]) for s in servers]
    assert all(np.array_equal(a, b) for a, b in zip(*first)), (
        "the restored model serves other bits than the trained one")
    log(f"fast mean: the trained model through save_model/load_model "
        f"({out['checkpoint_bytes']} bytes of JSON) compares equal and "
        f"FastServer(engine='fused') serves the first request from both "
        f"bit for bit: {arrays_from_muygps(restored)}")

    # (b) the precompute and the three requests through
    # examples.fast_posterior_mean, once with the launches counted (the
    # path), then timed
    nn_kernel = NN_Wrapper(train, NN, nn_method="kernel")
    design = K.knn_design(D, NN + 1 + 32, 1024)
    log(f"fast mean: get_batch_nns over {TRAIN} training points asks K3p "
        f"for k = {NN + 1 + 32} at 1024 bins: the {design} design")
    assert design == "fused"

    def serve_fast(model, x, nn_fast, coeffs, request):
        mean, near = fast_posterior_mean_serve(model, nn_kernel, request, x,
                                               nn_fast, coeffs)
        return mean.cpu().numpy(), near

    torch.cuda.synchronize()
    _build.reset_launches()
    coeffs, nn_fast = make_fast_regressor(restored, nn_kernel, train_d, y_d)
    means, nears = [], []
    for r in requests:
        m, near = serve_fast(restored, train_d, nn_fast, coeffs, r)
        means.append(m)
        nears.append(near)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    assert launches["knn_candidates_pruned"] > 0
    assert launches["knn_candidates"] == 0  # the bounded route: no subsample
    assert launches["knn_candidates/fused"] == launches["knn_candidates_pruned"]
    mean = np.concatenate(means)
    assert coeffs.shape == (TRAIN, NN) and coeffs.dtype == torch.float32
    assert mean.shape == (sum(len(r) for r in requests),)
    assert np.isfinite(mean).all() and bool(torch.isfinite(coeffs).all())
    # the neighbour sets against the exact index's (the K3 contract)
    batch_nn, _ = nn_kernel.get_batch_nns(np.arange(TRAIN))
    assert np.array_equal(nn_fast[:, 1:].cpu().numpy(), batch_nn[:, :-1])
    exact_nn, _ = nbrs.get_batch_nns(np.arange(TRAIN))
    same = (np.sort(batch_nn, 1) == np.sort(exact_nn, 1)).all(1).mean()
    log(f"fast mean: NN_Wrapper(nn_method='kernel').get_batch_nns "
        f"neighbour sets equal the exact index's on {same:.6f} of "
        f"{TRAIN} rows; launches on the path (make_fast_regressor + 3 "
        f"requests) {launches}")
    assert same >= 0.98
    totals, stages = [], []
    for _ in range(FAST_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_fast_regressor(restored, nn_kernel, train_d, y_d)
        torch.cuda.synchronize()
        totals.append(time.perf_counter() - t0)
        c, st = fast_stages(torch, restored, nn_kernel, train_d, y_d)
        assert torch.equal(c, coeffs), "the stages are another path"
        stages.append(st)
    out["precompute_s"] = dict(
        total_s=statistics.median(totals),
        **{k: statistics.median(s[k] for s in stages) for k in stages[0]})
    out["precompute_runs_s"] = dict(total_s=totals, stages=stages)
    kin_mb = TRAIN * NN * NN * 4 / 1e6
    log(f"fast mean precompute ({card}): median of {FAST_ROUNDS} "
        f"make_fast_regressor calls and of its steps called alone "
        f"{json.dumps(out['precompute_s'])} (neighbours: get_batch_nns, "
        f"K3p + re-rank + the indices to the host; tensors: fast_nn_update "
        f"+ the deformation's pairwise distances + kernel, Kin "
        f"{kin_mb:.0f} MB; factorization: {TRAIN} x {NN} x {NN} Cholesky "
        f"+ solves); runs {json.dumps(out['precompute_runs_s'])}")

    # (c) the fast state through a file, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fast.npz")
        checkpoint.save_fast_state(path, coeffs, nn_fast)
        c2, n2 = checkpoint.load_fast_state(path)
    assert torch.equal(c2, coeffs) and torch.equal(n2, nn_fast)
    assert c2.device.type == "cuda"

    # (d) gates: f32 against the f64 precompute of the same neighbourhoods
    # and the f64 fast mean on the same indices
    train64 = train_d.double()
    coeffs64, nn64 = make_fast_regressor(restored, nn_kernel, train64,
                                         y_d.double())
    assert torch.equal(nn64, nn_fast)
    c_scale = float(coeffs64.abs().max())
    c_err = float((coeffs.double() - coeffs64).abs().max()) / c_scale
    mean64 = []
    for r, near in zip(requests, nears):
        m64, near64 = serve_fast(restored, train64, nn_fast, coeffs64, r)
        assert np.array_equal(near64, near)
        mean64.append(m64)
    m_err = float(np.abs(mean - np.concatenate(mean64)).max())
    fused_mean = np.concatenate(
        [servers[1].predict(r)[0][:, 0] for r in requests]
    )
    corr = float(np.corrcoef(mean, fused_mean)[0, 1])
    gap = float(np.abs(mean - fused_mean).max())
    out.update(coeff_rel_err=c_err, coeff_max_abs_f64=c_scale,
               mean_max_abs_err=m_err, corr_with_fused=corr,
               max_abs_gap_to_fused=gap)
    log(f"fast mean gates: f32 coefficients against the f64 precompute "
        f"{c_err:.3e} of the largest |C| {c_scale:.3e} (limit "
        f"{FAST_COEFF_REL_F32}); f32 fast mean against the f64 fast mean "
        f"on the same indices {m_err:.3e} (limit {MEAN_TOL_F32}); against "
        f"the fused engine's full posterior mean: correlation {corr:.6f} "
        f"(limit > {FAST_CORR_MIN}), largest absolute gap {gap:.3e}")
    assert c_err <= FAST_COEFF_REL_F32, "f32 coefficients off the f64 ones"
    assert m_err <= MEAN_TOL_F32, "the f32 fast mean is off the f64 one"
    assert corr > FAST_CORR_MIN, "the fast mean does not track the full one"

    # (e) predictions/s, host numpy in and out, alternated with the
    # captured fused engine of the same model (fast, fused, fused, fast,
    # FAST_ROUNDS times)
    rates = {"fast": [], "fused": []}
    count = sum(len(r) for r in requests)
    for mode in ("fast", "fused", "fused", "fast") * FAST_ROUNDS:
        if mode == "fused":
            rates[mode].append(serve(torch, servers[1], requests)[2])
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in requests:
            serve_fast(restored, train_d, nn_fast, coeffs, r)
        rates[mode].append(count / (time.perf_counter() - t0))
    out["preds_per_s"] = {k: statistics.median(v) for k, v in rates.items()}
    out["rates"] = rates
    trace = device_trace(torch, lambda: [
        serve_fast(restored, train_d, nn_fast, coeffs, r) for r in requests
    ])
    out["serve_trace"] = trace
    log(f"fast mean serving ({card}): median {out['preds_per_s']['fast']:.1f}"
        f" predictions/s over {count} queries in 3 requests (host numpy in "
        f"and out; {2 * FAST_ROUNDS} rounds {rates['fast']}), the captured "
        f"fused engine {out['preds_per_s']['fused']:.1f} ({rates['fused']}),"
        f" alternated; fast-mean device trace {json.dumps(trace)}")

    # (f) a two-response MultivariateMuyGPS (nu 3/2 and 5/2 at the trained
    # length scale and noise) over the same self-inclusive sets
    vals = arrays_from_muygps(restored)
    spec = dict(length_scale=vals["length_scale"], noise=vals["noise"],
                scale=vals["scale"])
    mm = mmuygps_from_arrays([dict(spec, smoothness=1.5),
                              dict(spec, smoothness=2.5)])
    y2 = np.concatenate([
        y_train,
        (np.cos(2 * np.pi * train[:, :1]) * np.sin(2 * np.pi * train[:, 1:])
         + 0.1 * np.random.default_rng(4).standard_normal((TRAIN, 1))),
    ], axis=1)
    got = {}
    for dtype in (torch.float32, torch.float64):
        x = train_d.to(dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, nn_mm = make_fast_multivariate_regressor(
            mm, nn_kernel, x, torch.as_tensor(y2, dtype=dtype, device="cuda"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        assert torch.equal(nn_mm, nn_fast)
        m, _ = fast_posterior_mean_serve(mm, nn_kernel, requests[0], x,
                                         nn_mm, c)
        got[dtype] = (c, m, seconds)
    c32, m32, s32 = got[torch.float32]
    c64, m64, _ = got[torch.float64]
    assert c32.shape == (TRAIN, NN, 2) and m32.shape == (len(requests[0]), 2)
    mm_c = float((c32.double() - c64).abs().max() / c64.abs().max())
    mm_m = float((m32.double() - m64).abs().max())
    out["multivariate"] = dict(coeff_rel_err=mm_c, mean_max_abs_err=mm_m,
                               precompute_s=s32)
    log(f"fast mean, MultivariateMuyGPS (nu 3/2, 5/2): "
        f"make_fast_multivariate_regressor {tuple(c32.shape)} in {s32:.4f} "
        f"s ({card}); f32 against f64: coefficients {mm_c:.3e} of the "
        f"largest (limit {FAST_COEFF_REL_F32}), the first request's means "
        f"{mm_m:.3e} (limit {MEAN_TOL_F32})")
    assert mm_c <= FAST_COEFF_REL_F32 and mm_m <= MEAN_TOL_F32
    assert np.isfinite(m32.cpu().numpy()).all()

    # (g) K3p at the precompute's shape: every training point a query
    prep = K.prepare_bounded(train_sorted, train_d, NN + 1 + 32, bins=1024)
    row = k3_case(torch, "knn_candidates_pruned[fast_mean]", prep,
                  NN + 1 + 32, train_d, train_sorted)
    return out, launches, row


# ---- phase 17: the user workflows (examples, NN_Wrapper methods, Bayes,
# the mini-batch chassis, hierarchical length scales) ----


def sync(torch, dev):
    """Wait for ``dev``: phase 17's functions take ``dev="cpu"`` (and
    smaller sizes) to rehearse the phase on a machine without a card."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def same_sets(a, b):
    """Per query: the two index arrays hold the same set."""
    import numpy as np

    return (np.sort(a, 1) == np.sort(b, 1)).all(1)


def phase_nn_methods(torch, train, queries, dev="cuda",
                     scan_rows=SCAN_ROWS):
    """(a) every NN_Wrapper method at the serving headline (build and
    query seconds, sets against the exact f64 sets on the same device),
    then the exact search in tiles of 16,384 at ``scan_rows`` rows against
    the same search in one tile (seconds, peak device memory, the same
    sets after the re-rank)."""
    import importlib.util

    import numpy as np

    from muygpys_torch.gpu import _build
    from muygpys_torch.neighbors import (
        NN_Wrapper,
        _brute_force_knn,
        _refine_knn,
        _train_tiles,
    )

    t64 = torch.as_tensor(train, dtype=torch.float64, device=dev)
    q64 = torch.as_tensor(queries, dtype=torch.float64, device=dev)
    cand, _ = _brute_force_knn(t64, q64, NN + 32)
    exact = _refine_knn(t64, q64, cand, NN)[0].cpu().numpy()
    methods = [("exact", {}), ("brute", {}), ("kernel", {}),
               ("hnsw", {"random_seed": 0})]
    if importlib.util.find_spec("sklearn") is None:
        log("phase 17 (a): nn_method='sklearn' not run: scikit-learn is not "
            "installed on this machine (not counted as a pass)")
    else:
        methods.append(("sklearn", {}))
    out, launches = {}, {}
    for method, kw in methods:
        sync(torch, dev)
        t0 = time.perf_counter()
        nbrs = NN_Wrapper(train, NN, nn_method=method, device=dev, **kw)
        sync(torch, dev)
        build_s = time.perf_counter() - t0
        nbrs.get_nns(queries[:64])  # warm-up
        sync(torch, dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        idx, d2 = nbrs.get_nns(queries)
        query_s = time.perf_counter() - t0
        launches[method] = dict(_build.launches)
        recall = float(np.mean([len(set(a) & set(b)) / NN
                                for a, b in zip(idx, exact)]))
        out[method] = dict(build_s=build_s, query_s=query_s,
                           exact_share=float(same_sets(idx, exact).mean()),
                           recall=recall)
        assert idx.shape == (len(queries), NN) and np.isfinite(d2).all()
    log(f"phase 17 (a) NN_Wrapper methods, {len(queries)} queries against "
        f"{len(train)} points: " + json.dumps(out))
    for method in ("exact", "brute", "sklearn"):
        if method in out:
            assert out[method]["exact_share"] >= EXACT_SETS_MIN, method
    assert out["kernel"]["exact_share"] >= KERNEL_SETS_MIN
    assert out["hnsw"]["recall"] > HNSW_RECALL_MIN
    # the plain versions on the CPU count no launch
    if torch.device(dev).type == "cuda":
        assert launches["kernel"]["knn_candidates_pruned"] > 0
    assert launches["exact"]["knn_candidates_pruned"] == 0

    # the scan against the one-block search at scan_rows training rows
    big = np.random.default_rng(5).uniform(size=(scan_rows, D)).astype(
        np.float32)
    big_d = torch.as_tensor(big, device=dev)
    q_d = torch.as_tensor(queries, device=dev)
    scan = {}
    results = {}
    # the train side of each is built once per index, as NN_Wrapper does
    for name, tile in (("scan", None), ("one_block", scan_rows)):
        tiles = _train_tiles(big_d, *(() if tile is None else (tile,)))
        _brute_force_knn(big_d, q_d[:512], NN + 32, tiles=tiles)  # warm-up
        sync(torch, dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cand, _ = _brute_force_knn(big_d, q_d, NN + 32, tiles=tiles)
        idx, d2 = _refine_knn(big_d, q_d, cand, NN)
        sync(torch, dev)
        scan[name] = dict(seconds=time.perf_counter() - t0)
        if torch.device(dev).type == "cuda":
            scan[name]["max_memory_allocated_bytes"] = (
                torch.cuda.max_memory_allocated())
            scan[name]["above_inputs_bytes"] = (
                torch.cuda.max_memory_allocated() - base)
        results[name] = (idx.cpu().numpy(), d2.cpu().numpy())
    scan["same_sets"] = float(same_sets(results["scan"][0],
                                        results["one_block"][0]).mean())
    log(f"phase 17 (a) exact search over {scan_rows} rows, one request of "
        f"{len(queries)}: " + json.dumps(scan))
    # the same neighbours after the re-rank: equal distances everywhere
    # (a set may differ only among equal distances)
    assert np.array_equal(results["scan"][1], results["one_block"][1])
    out["scan_1m"] = scan
    return out, launches["kernel"]


def regress_kwargs():
    """(b)'s model: Matern 3/2, the length scale free (0.5 in 0.01-5), the
    noise fixed at 1e-3, analytic scale.  Its f64 optimum lies at a
    length scale of 0.02-0.035, where neighbourhood matrices are only
    positive definite in f32 because the distance assembly centres each
    neighbourhood first (ops/tensors.pairwise_F2)."""
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise

    return {
        "kernel": Matern(smoothness=Parameter(NU), deformation=Isotropy(
            l2, length_scale=Parameter(LS, LS_BOUNDS))),
        "noise": HomoscedasticNoise(NOISE),
        "scale": AnalyticScale(),
    }


def at_params(k_kwargs, params, scale=1.0):
    """A fresh model of ``k_kwargs`` at the named parameter values and
    sigma^2."""
    from muygpys_torch.gp import MuyGPS

    model = MuyGPS(**k_kwargs)
    for name, value in params.items():
        if name == "noise":
            model.noise._set_val(value)
        else:
            model.kernel._hyperparameters[name]._set_val(value)
    model.scale._set(scale)
    model._make()
    return model


def opt_values(model):
    """The model's free parameters by name."""
    names, values, _ = model.get_opt_params()
    return {n: float(v) for n, v in zip(names, values)}


def phase_do_regress(torch, train, y_train, request, dev="cuda",
                     batch=TRAIN_BATCH):
    """(b) do_regress at the training headline on the card (K3p through
    NN_Wrapper(nn_method="kernel"), Bayes_optimize), the same call on the
    CPU in f64, the gates, seconds by stage and regress_any's rate beside
    the captured fused engine's."""
    import contextlib
    import io
    import re
    import statistics

    import numpy as np

    from muygpys_torch import config
    from muygpys_torch.examples.regress import do_regress, regress_any
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gpu import _build
    from muygpys_torch.optimize import L_BFGS_B_optimize, lool_fn, sample_batch
    from muygpys_torch.serve import FastServer

    kw = dict(nn_count=NN, batch_count=batch,
              nn_kwargs={"nn_method": "kernel"},
              opt_kwargs={"random_state": 0})
    # warm-up: imports and first launches, on a tenth of the data
    do_regress(request[:256], train[:4096], y_train[:4096],
               k_kwargs=regress_kwargs(), device=dev,
               rng=np.random.default_rng(0),
               **dict(kw, batch_count=256,
                      opt_kwargs={"init_points": 1, "n_iter": 1}))
    sync(torch, dev)
    _build.reset_launches()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        model, nbrs, mean, var = do_regress(
            request, train, y_train, k_kwargs=regress_kwargs(), device=dev,
            rng=np.random.default_rng(2), verbose=True, **kw)
    sync(torch, dev)
    total_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    text = printed.getvalue()
    stage = {key: float(re.search(rf"{pattern}[: ]*([0-9.e+-]+)s", text)[1])
             for key, pattern in (("nn_build", "nn build time"),
                                  ("opt", "opt time"),
                                  ("pred_nn", "\tnn time"),
                                  ("pred", "\tpred time"))}
    p_card = opt_values(model)
    assert mean.shape == (len(request), 1) and np.isfinite(mean).all()
    assert np.isfinite(var).all() and (var > 0).all()

    # the same call in f64 on the card and on the CPU.  The training gate
    # holds the card's f32 optimum to the CPU's, one-sided (Bayes may land
    # above the f64 optimum: the f32 and f64 probe sequences part once
    # rounding moves an expected-improvement argmax); the card's f64 run is
    # held to the CPU's both ways (the same probes)
    config.update("ftype", 64)
    card64, _, _, _ = do_regress(
        request, train, y_train, k_kwargs=regress_kwargs(), device=dev,
        rng=np.random.default_rng(2), **kw)
    p_card64 = opt_values(card64)
    t0 = time.perf_counter()
    ref, ref_nbrs, _, _ = do_regress(
        request, train, y_train, k_kwargs=regress_kwargs(), device="cpu",
        rng=np.random.default_rng(2), **kw)
    cpu_s = time.perf_counter() - t0
    p_cpu = opt_values(ref)
    sigma2 = float(ref.scale())
    # the f64 objective of the CPU run's batch at both optima
    bi, bnn = sample_batch(ref_nbrs, batch, len(train),
                           rng=np.random.default_rng(2))
    start = MuyGPS(**regress_kwargs())
    cw, pw, bt, bnt = start.make_train_tensors(
        bi, bnn, torch.as_tensor(train, dtype=torch.float64),
        torch.as_tensor(y_train, dtype=torch.float64))
    obj = L_BFGS_B_optimize.make_obj_fn(start, bt, bnt, cw, pw,
                                        loss_fn=lool_fn)
    with torch.no_grad():
        v_card = float(obj(**p_card64))
        v_cpu = float(obj(**p_cpu))
        v_f32 = float(obj(**p_card))
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    rel_f32 = (v_cpu - v_f32) / abs(v_cpu)
    # serving at the CPU's parameters on the card's neighbours, both ways
    m64, v64, _ = regress_any(ref, request, train, nbrs, y_train,
                              device="cpu")
    config.update("ftype", 32)
    served = at_params(regress_kwargs(), p_cpu, sigma2)
    m32, v32, timing = regress_any(served, request, train, nbrs, y_train,
                                   device=dev)
    err_m = float(np.abs(m32 - m64).max())
    err_v = float(np.abs(v32 - v64).max())
    tol_v = VAR_TOL_F32 * sigma2
    out = dict(
        total_s=total_s, stage_s=stage, cpu_f64_s=cpu_s,
        parameters=dict(card_f32=p_card, card_f64=p_card64, cpu=p_cpu),
        scale=sigma2,
        objective_f64=dict(card_f64=v_card, cpu=v_cpu, relative=rel,
                           card_f32=v_f32, f32_short_by=rel_f32),
        mean_max_abs_err=err_m, var_max_abs_err=err_v,
        regress_any_preds_per_s=len(request) / (timing["nn"]
                                                + timing["pred"]),
    )
    log(f"phase 17 (b) do_regress ({len(train)} points, batch {batch}, "
        f"Bayes 5 + 20 probes, {len(request)} queries): "
        + json.dumps(out) + f"; var limit {tol_v:.3e}, smallest f64 "
        f"variance {float(v64.min()):.3e}")
    if torch.device(dev).type == "cuda":
        assert launches["knn_candidates_pruned"] > 0
    assert rel_f32 <= OBJECTIVE_RTOL, "the card's f32 optimum is short"
    assert rel <= OBJECTIVE_RTOL, "do_regress's f64 optimum is off the CPU's"
    assert err_m <= MEAN_TOL_F32 and err_v <= tol_v
    assert tol_v <= 0.1 * float(np.abs(v64).min()), "variance gate too loose"

    # regress_any's predictions/s beside the captured fused engine's for
    # the trained model, alternated (regress_any, fused, fused,
    # regress_any) twice
    if torch.device(dev).type != "cuda":
        return out, launches, {}
    server = FastServer(model, nbrs, train, y_train, bucket=QUERIES,
                        engine="fused")
    server.predict(request)  # capture
    torch.cuda.synchronize()
    _build.reset_launches()
    serve(torch, server, [request])
    fused_launches = dict(_build.launches)
    rates = {"regress_any": [], "fused": []}
    for mode in ("regress_any", "fused", "fused", "regress_any") * 2:
        if mode == "fused":
            rates[mode].append(serve(torch, server, [request])[2])
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        regress_any(model, request, train, nbrs, y_train)
        rates[mode].append(len(request) / (time.perf_counter() - t0))
    out["preds_per_s"] = {k: statistics.median(v) for k, v in rates.items()}
    out["rates"] = rates
    log("phase 17 (b) predictions/s, one request, alternated: "
        + json.dumps(rates))
    assert fused_launches["fused_predict_coords"] > 0
    return out, launches, fused_launches


def two_class_data(np, n, seed):
    """tests/test_examples.py's two noisy interleaved half-moons (one-hot
    -1/1 labels), n points, half of them for training."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, n)
    cls = rng.integers(0, 2, n)
    x = np.stack([
        np.cos(t) * (1 - 2 * cls) + 0.3 * rng.standard_normal(n) + cls,
        np.sin(t) * (1 - 2 * cls) + 0.3 * rng.standard_normal(n) + 0.5 * cls,
    ], axis=1)
    labels = np.full((n, 2), -1.0)
    labels[np.arange(n), cls] = 1.0
    ntr = n // 2
    return x[:ntr], labels[:ntr], x[ntr:], labels[ntr:]


def classify_kwargs():
    """tests/test_examples.py's surrogate classifier: RBF on F2, free
    length scale, noise 1e-3."""
    from muygpys_torch.gp.deformation import F2, Isotropy
    from muygpys_torch.gp.hyperparameter import Parameter
    from muygpys_torch.gp.kernels import RBF
    from muygpys_torch.gp.noise import HomoscedasticNoise

    return {
        "kernel": RBF(deformation=Isotropy(
            F2, length_scale=Parameter(0.5, (0.05, 2.0)))),
        "noise": HomoscedasticNoise(1e-3),
    }


def phase_classify(torch, dev="cuda", n=CLASSIFY_POINTS):
    """(c) do_classify and do_classify_uq on the half-moons (n/2 training
    points), cross-entropy, NN_Wrapper(nn_method="kernel"), 3 + 5 Bayes
    probes; the classes at the CPU f64 optimum on the same neighbours."""
    import numpy as np

    from muygpys_torch import config
    from muygpys_torch.examples.classify import classify_any, do_classify
    from muygpys_torch.examples.from_indices import optimize_from_indices
    from muygpys_torch.examples.two_class_classify_uq import (
        do_classify_uq,
        do_uq,
    )
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gpu import _build
    from muygpys_torch.optimize import cross_entropy_fn, get_balanced_batch

    xtr, ytr, xte, yte = (a.astype(np.float32)
                          for a in two_class_data(np, n, 7))
    kw = dict(nn_count=NN, nn_kwargs={"nn_method": "kernel"},
              opt_kwargs={"init_points": 3, "n_iter": 5, "random_state": 0})
    sync(torch, dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    model, nbrs, preds = do_classify(xte, xtr, ytr, k_kwargs=classify_kwargs(),
                                     device=dev, rng=np.random.default_rng(3),
                                     **kw)
    sync(torch, dev)
    classify_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    accuracy = float(np.mean(np.argmax(preds, 1) == np.argmax(yte, 1)))

    # the same optimization on the CPU in f64, on the same batch (the card
    # index's balanced batch, drawn as make_classifier draws it)
    labels = np.argmax(ytr, axis=1)
    bi, bnn = get_balanced_batch(nbrs, labels, 200,
                                 rng=np.random.default_rng(3))
    config.update("ftype", 64)
    ref = optimize_from_indices(
        MuyGPS(**classify_kwargs()), bi, bnn, xtr, ytr,
        loss_fn=cross_entropy_fn, device="cpu", **kw["opt_kwargs"])
    ls_cpu = float(ref.kernel.deformation.length_scale())
    p64, _ = classify_any(ref, xte, xtr, nbrs, ytr, device="cpu")
    config.update("ftype", 32)
    at_cpu = at_params(classify_kwargs(), opt_values(ref))
    p32, _ = classify_any(at_cpu, xte, xtr, nbrs, ytr, device=dev)
    agree = float(np.mean(np.argmax(p32, 1) == np.argmax(p64, 1)))

    t0 = time.perf_counter()
    _, _, uq_preds, masks = do_classify_uq(
        xte, xtr, ytr, k_kwargs=classify_kwargs(), device=dev,
        rng=np.random.default_rng(11), **kw)
    uq_s = time.perf_counter() - t0
    uq_accuracy, uq = do_uq(uq_preds, yte, masks)
    out = dict(
        train_points=len(xtr), test_points=len(xte), accuracy=accuracy,
        classify_s=classify_s,
        length_scale=dict(card=float(model.kernel.deformation.length_scale()),
                          cpu=ls_cpu),
        classes_agree_with_cpu_f64=agree, uq_accuracy=uq_accuracy,
        uq=uq.tolist(), mask_shape=list(masks.shape), uq_s=uq_s,
    )
    log("phase 17 (c) classification: " + json.dumps(out))
    if torch.device(dev).type == "cuda":
        assert launches["knn_candidates_pruned"] > 0
    assert accuracy > CLASSIFY_ACCURACY_MIN and uq_accuracy > (
        CLASSIFY_ACCURACY_MIN)
    assert agree >= CLASSIFY_AGREE_MIN
    assert masks.shape == (5, len(xte))
    return out, launches


def traced_trainers(torch, dev):
    """A context that records every make_device_trainer the mini-batch
    chassis makes, and the seconds and batch of each of its calls."""
    import contextlib

    from muygpys_torch.optimize import device_chassis

    made = []
    real = device_chassis.make_device_trainer

    def recording(*args, **kwargs):
        trainer = real(*args, **kwargs)
        calls = []

        def timed(*batch, **options):
            sync(torch, dev)
            t0 = time.perf_counter()
            result = trainer(*batch, **options)
            sync(torch, dev)
            calls.append((time.perf_counter() - t0, batch, result[1]))
            return result

        timed.captures, timed.calls = trainer.captures, calls
        made.append(timed)
        return timed

    @contextlib.contextmanager
    def patched():
        device_chassis.make_device_trainer = recording
        try:
            yield made
        finally:
            device_chassis.make_device_trainer = real

    return patched()


def phase_mini_batch(torch, train, y_train, dev="cuda", batch=TRAIN_BATCH,
                     epochs=MINI_BATCH_EPOCHS):
    """(d) optimize_from_tensors_mini_batch(engine="device-lbfgs") at the
    training headline, keep_state=True: one capture, seconds per epoch,
    the last epoch's f64 objective against the same call on the CPU in
    f64."""
    import numpy as np

    from muygpys_torch import config
    from muygpys_torch.convert import arrays_from_muygps
    from muygpys_torch.gpu import _build
    from muygpys_torch.optimize import make_fast_loo_objective
    from muygpys_torch.optimize.experimental import (
        optimize_from_tensors_mini_batch,
    )

    kw = dict(num_epochs=epochs, keep_state=True, engine="device-lbfgs",
              nn_kwargs={"nn_method": "kernel"})
    sync(torch, dev)
    _build.reset_launches()
    with traced_trainers(torch, dev) as made:
        trained, _, seconds, _, steps = optimize_from_tensors_mini_batch(
            train_model(), train, y_train, NN, batch, len(train),
            rng=np.random.default_rng(6), device=dev, **kw)
    launches = dict(_build.launches)
    (trainer,) = made
    config.update("ftype", 64)
    with traced_trainers(torch, "cpu") as made64:
        ref, _, cpu_s, _, cpu_steps = optimize_from_tensors_mini_batch(
            train_model(), train, y_train, NN, batch, len(train),
            rng=np.random.default_rng(6), device="cpu", **kw)
    config.update("ftype", 32)
    bt, bnt, cw, pw = made64[0].calls[-1][1][:4]
    obj, names = make_fast_loo_objective(
        train_model(), bt, bnt, cw, pw, layout="batched", device="cpu")
    got, want = arrays_from_muygps(trained), arrays_from_muygps(ref)
    with torch.no_grad():
        v_card = float(obj({n: got[n] for n in names}))
        v_cpu = float(obj({n: want[n] for n in names}))
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    epoch_s = [c[0] for c in trainer.calls]
    out = dict(
        epochs=epochs, batch=batch, seconds=seconds, steps=steps,
        first_epoch_s=epoch_s[0], later_epochs_s=epoch_s[1:],
        captures=trainer.captures(),
        capture_ms=[c[2]["capture_ms"] for c in trainer.calls],
        replays=[c[2]["replays"] for c in trainer.calls],
        parameters=dict(card={n: got[n] for n in names},
                        cpu={n: want[n] for n in names}),
        cpu_f64=dict(seconds=cpu_s, steps=cpu_steps),
        objective_f64=dict(card=v_card, cpu=v_cpu, relative=rel),
    )
    log("phase 17 (d) mini-batch chassis (device-lbfgs): " + json.dumps(out))
    assert len(trainer.calls) == epochs
    if torch.device(dev).type == "cuda":
        assert trainer.captures() == 1, "an epoch captured a new graph"
    assert rel <= OBJECTIVE_RTOL, "the last epoch is off the f64 optimum"
    return out, launches


def nonstationary_field(np, n, seed):
    """tests/test_nonstationary.py's field: length scale 0.08 left of 0.5,
    0.6 right of it, a Gibbs-kernel draw."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 1))
    ls_true = np.where(x[:, 0] < 0.5, 0.08, 0.6)
    lsi, lsj = ls_true[:, None], ls_true[None, :]
    pref = np.sqrt(2 * lsi * lsj / (lsi**2 + lsj**2))
    d2 = (x[:, 0:1] - x[None, :, 0]) ** 2
    K = pref * np.exp(-d2 / (lsi**2 + lsj**2)) + 1e-8 * np.eye(n)
    y = (np.linalg.cholesky(K) @ rng.standard_normal(n))[:, None]
    return x, y


def hierarchical_model():
    """tests/test_nonstationary.py's model: four knots, Matern 3/2."""
    import numpy as np

    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import (
        AnalyticScale,
        Parameter,
        VectorParameter,
    )
    from muygpys_torch.gp.hyperparameter.experimental import (
        HierarchicalParameter,
    )
    from muygpys_torch.gp.kernels import RBF, Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise

    knots = np.array([[0.15], [0.35], [0.65], [0.85]])
    values = VectorParameter(*[Parameter(0.3, (0.02, 1.5))
                               for _ in range(4)])
    return MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=HierarchicalParameter(knots, values, RBF()))),
        noise=HomoscedasticNoise(1e-5), scale=AnalyticScale(),
    )


def phase_hierarchical(torch, dev="cuda", n=HIER_POINTS, batch=HIER_BATCH,
                       dtype=None):
    """(e) the nonstationary field through make_device_trainer(...,
    batch_features=) in ``dtype`` (torch.float32 or torch.float64): the
    field's ordering and the f64 objective against the CPU's f64 optimum;
    then a second batch through the same trainer with its own features, a
    replay.  In f64 the replay is held to the CPU's eager run on that
    batch (a stale-buffer replay would give the first batch's knots), and
    the first batch's f64 objective to the CPU's optimum; in f32 both
    batches are held to the field's ordering and the objectives are
    logged."""
    import numpy as np

    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.optimize import (
        make_device_trainer,
        make_fast_loo_objective,
    )

    x, y = nonstationary_field(np, n, 8)
    nbrs = NN_Wrapper(x, NN, device=dev)
    batches = []
    for seed in (0, 1):
        bi = np.random.default_rng(seed).choice(n, batch, replace=False)
        batches.append((bi, nbrs.get_batch_nns(bi)[0]))
    model = hierarchical_model()
    names = model.get_opt_params()[0]

    def tensors(k, device, dt):
        """The k-th batch's (bt, bnt, cw, pw) and its features."""
        bi, bni = batches[k]
        xd = torch.as_tensor(x, dtype=dt, device=device)
        yd = torch.as_tensor(y, dtype=dt, device=device)
        cw, pw, bt, bnt = model.make_train_tensors(bi, bni, xd, yd)
        return (bt, bnt, cw, pw), xd[torch.as_tensor(bi, device=device)]

    def knots(m):
        return m.get_opt_params()[1]

    def cpu_f64(k):
        """The CPU's f64 eager optimum on batch k, and that batch's f64
        objective."""
        batch64, bf64 = tensors(k, "cpu", torch.float64)
        ref, _ = make_device_trainer(model, device="cpu")(
            *batch64, batch_features=bf64)
        obj, _ = make_fast_loo_objective(model, *batch64, layout="batched",
                                         batch_features=bf64, device="cpu")
        return knots(ref), lambda kn: float(obj(dict(zip(names, kn))))

    trainer = make_device_trainer(model, device=dev)
    batch0, bf0 = tensors(0, dev, dtype)
    sync(torch, dev)
    t0 = time.perf_counter()
    card, info = trainer(*batch0, batch_features=bf0)
    sync(torch, dev)
    train_s = time.perf_counter() - t0
    k_card = knots(card)
    ratio = float(np.mean(k_card[2:]) / np.mean(k_card[:2]))
    k_cpu, obj0 = cpu_f64(0)
    with torch.no_grad():
        v_card, v_cpu = obj0(k_card), obj0(k_cpu)
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    # the second batch through the same trainer, with its own features
    batch1, bf1 = tensors(1, dev, dtype)
    sync(torch, dev)
    t0 = time.perf_counter()
    replay, info1 = trainer(*batch1, batch_features=bf1)
    sync(torch, dev)
    replay_s = time.perf_counter() - t0
    k_replay = knots(replay)
    ratio1 = float(np.mean(k_replay[2:]) / np.mean(k_replay[:2]))
    k_eager, obj1 = cpu_f64(1)
    replay_rel = float(np.max(np.abs(k_replay / k_eager - 1)))
    with torch.no_grad():
        v_replay, v_eager = obj1(knots(replay)), obj1(k_eager)
    replay_obj_rel = abs(v_replay - v_eager) / abs(v_eager)
    out = dict(
        dtype=str(dtype), points=n, batch=batch, train_s=train_s,
        iterations=info["iterations"], evaluations=info["evaluations"],
        replays=info["replays"], capture_ms=info["capture_ms"],
        knots_card=k_card.tolist(), knots_cpu_f64=k_cpu.tolist(),
        right_over_left=ratio,
        objective_f64=dict(card=v_card, cpu=v_cpu, relative=rel),
        second_batch=dict(seconds=replay_s, captures=trainer.captures(),
                          capture_ms=info1["capture_ms"],
                          replays=info1["replays"],
                          right_over_left=ratio1,
                          knots_relative_to_eager=replay_rel,
                          objective_f64_relative=replay_obj_rel),
    )
    log("phase 17 (e) hierarchical length scale: " + json.dumps(out))
    assert min(ratio, ratio1) > HIER_RATIO_MIN, "the ordering is not recovered"
    if torch.device(dev).type == "cuda":
        assert trainer.captures() == 1 and info1["capture_ms"] == 0
    # in f32 the objectives are readings: at the knots' upper bound a
    # neighbourhood (30 points within ~0.0075 under a length scale of 1.5,
    # nugget 1e-5) has a condition number near 3e6, which f32's Cholesky
    # cannot resolve (PERF.md, Findings)
    if dtype == torch.float64:
        assert rel <= OBJECTIVE_RTOL, "the card's knots are off the f64 optimum"
        assert replay_rel <= HIER_REPLAY_RTOL, "the replay used stale features"
    return out


# ---- phases 18-20: the deep-kernel model, the fast-mean workflow
# functions and the headline harness ----

# the deep-kernel tutorial's configuration (docs/deep_kernel_tutorial.md,
# lines 30-69): 4,000 points x 40 features (seed 0), 3,000 to train, an
# MLP 40 -> 64 -> 32 -> 2 with ReLU feeding Matern 3/2 (ls 1.0, noise
# 1e-3, nn 30); a batch of 500, 200 iterations at lr 1e-2 decaying by 0.97
# a step, lool, the index rebuilt every 25 iterations through K3p
DK_POINTS, DK_FEATURES, DK_TRAIN, DK_BATCH = 4000, 40, 3000, 500
DK_ITERS, DK_LR, DK_DECAY, DK_UPDATE = 200, 1e-2, 0.97, 25
DK_NN_KWARGS = {"nn_method": "pallas"}
# the JAX test's bars (tests/test_deep_kernel.py): the final loss under a
# tenth of the first step's, the test error under 1.5x the targets'
# variance.  At the tutorial's configuration the loss bar holds and the
# test error is a reading: the embedding overfits its batch of 500 there
# (phase_deep_kernel(torch, dev="cpu") in f32 reads 1.90 against a
# variance of 1.01, the untrained model 1.06; PERF.md has the card's
# numbers); the error bars are held at the JAX test's own
# configuration (600 x 6, an MLP 6 -> 16 -> 2 with tanh, nn 20, a batch of
# 200, 150 steps at lr 1e-2 decaying by 0.995, a rebuild every 25), where
# the test error must also beat the untrained model's
DK_LOSS_DROP, DK_MSE_OF_VAR = 0.1, 1.5
DK_TEST_CONFIG = dict(n=600, d=6, train=400, batch=200, nn=20, iters=150,
                      decay=0.995)
# the first steps in f64 on the card against the CPU's, from one start:
# each parameter within 1e-8 of the largest (the last layer's bias, whose
# exact gradient is zero, moves by rounding noise alone and is left out)
DK_F64_STEPS, DK_F64_RTOL = 5, 1e-8
# the reporting-only run at scale: points, batch, steps, update frequency
DK_BIG = (50_000, 2048, 20, 5)
# do_fast_posterior_mean at tests/test_examples.py:181's size and bar
FAST_WORKFLOW_MSE = 0.02


def deep_kernel_data(np, n, d, train_count):
    """The tutorial's data: X uniform (n, d), y = sin(2 pi x0) + cos(2 pi
    x1) + 0.05 N(0, 1), f32, seed 0; and the generator, whose next draw is
    the tutorial's batch."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    y = (np.sin(2 * np.pi * X[:, 0]) + np.cos(2 * np.pi * X[:, 1]))[:, None]
    y = (y + 0.05 * rng.standard_normal((n, 1))).astype(np.float32)
    return X[:train_count], y[:train_count], X[train_count:], y[train_count:], rng


def deep_kernel_model(torch, d):
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise
    from muygpys_torch.nn import DeepKernelMuyGPs

    embedding = torch.nn.Sequential(
        torch.nn.Linear(d, 64), torch.nn.ReLU(), torch.nn.Linear(64, 32),
        torch.nn.ReLU(), torch.nn.Linear(32, 2),
    )
    return DeepKernelMuyGPs(embedding, MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=Parameter(1.0))),
        noise=HomoscedasticNoise(1e-3),
    ))


def deep_kernel_test_bars(torch, dev):
    """tests/test_deep_kernel.py's train-and-predict bars at its own
    configuration (f32, the index rebuilt through K3p): the final loss
    under a tenth of the first step's, the test error under 1.5x the
    targets' variance and under the untrained model's, finite variances,
    the length scale moved."""
    import torch.nn as tnn
    import numpy as np

    from muygpys_torch.examples import deep_kernel as dk
    from muygpys_torch.neighbors import NN_Wrapper

    c = DK_TEST_CONFIG
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(c["n"], c["d"]))
    y = (np.sin(2 * np.pi * X[:, 0]) + np.cos(2 * np.pi * X[:, 1]))[:, None]
    y += 0.05 * rng.standard_normal((c["n"], 1))
    X, y = X.astype(np.float32), y.astype(np.float32)
    xtr, ytr, xte, yte = (X[:c["train"]], y[:c["train"]], X[c["train"]:],
                          y[c["train"]:])
    bi = rng.choice(c["train"], c["batch"], replace=False)
    model = deep_kernel_model(torch, c["d"])
    model.embedding = tnn.Sequential(tnn.Linear(c["d"], 16), tnn.Tanh(),
                                     tnn.Linear(16, 2))
    nbrs = NN_Wrapper(xtr, c["nn"], device=dev)
    kw = dict(learning_rate=DK_LR, device=dev)
    _, _, first = dk.train_deep_kernel_muygps(
        model, xtr, ytr, bi, nbrs, training_iterations=1, **kw)
    nbrs_t, params, info = dk.train_deep_kernel_muygps(
        model, xtr, ytr, bi, nbrs, training_iterations=c["iters"],
        scheduler_decay=c["decay"], update_frequency=DK_UPDATE,
        nn_kwargs=DK_NN_KWARGS, **kw)
    mean, var = (t.cpu().numpy() for t in dk.predict_model(
        model, params, xte, xtr, ytr, nbrs_t, c["nn"]))
    params0 = dk._init_params(model, None, dev)
    nbrs0 = dk.update_nearest_neighbors(model, params0, xtr, ytr, bi,
                                        c["nn"], DK_NN_KWARGS)[0]
    mean0 = dk.predict_model(model, params0, xte, xtr, ytr, nbrs0,
                             c["nn"])[0].cpu().numpy()
    out = dict(
        first_loss=first["final_loss"], final_loss=info["final_loss"],
        test_mse=float(np.mean((mean - yte) ** 2)),
        untrained_test_mse=float(np.mean((mean0 - yte) ** 2)),
        target_var=float(np.var(yte)),
        log_length_scale=float(params["gp_layer.log_length_scale"]),
    )
    log("phase 18 deep kernel at the JAX test's configuration: "
        + json.dumps(out))
    assert out["final_loss"] < DK_LOSS_DROP * out["first_loss"]
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    assert var.min() >= 0.0
    assert out["test_mse"] < DK_MSE_OF_VAR * out["target_var"]
    assert out["test_mse"] < out["untrained_test_mse"]
    assert out["log_length_scale"] != 0.0
    return out


def phase_deep_kernel(torch, dev="cuda", n=DK_POINTS, d=DK_FEATURES,
                      train_count=DK_TRAIN, batch=DK_BATCH, iters=DK_ITERS,
                      big=DK_BIG):
    """Phase 18: the deep-kernel tutorial trained on the card in f32
    (embedding and GP together, Adam, the index rebuilt on the embedded
    features through K3p), judged by the JAX test's bars and against the
    untrained model; its first steps in f64 against the CPU's; ms a step,
    seconds a rebuild, K3p's launches, the device's idle share over one
    step; then a reporting-only run at 50,000 points.  Returns (numbers,
    the launches of the main training run)."""
    import numpy as np

    from muygpys_torch import config
    from muygpys_torch.examples import deep_kernel as dk
    from muygpys_torch.gpu import _build
    from muygpys_torch.neighbors import NN_Wrapper

    out = {}
    xtr, ytr, xte, yte, rng = deep_kernel_data(np, n, d, train_count)
    bi = rng.choice(train_count, batch, replace=False)
    model = deep_kernel_model(torch, d)
    nbrs = NN_Wrapper(xtr, NN, device=dev)
    kw = dict(learning_rate=DK_LR, scheduler_decay=DK_DECAY,
              loss_function="lool", device=dev)
    _, _, first = dk.train_deep_kernel_muygps(
        model, xtr, ytr, bi, nbrs, training_iterations=1, **kw)
    sync(torch, dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    trained_nbrs, params, info = dk.train_deep_kernel_muygps(
        model, xtr, ytr, bi, nbrs, training_iterations=iters,
        update_frequency=DK_UPDATE, nn_kwargs=DK_NN_KWARGS, **kw)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    out.update(
        first_loss=first["final_loss"], final_loss=info["final_loss"],
        train_s=wall, rebuilds=info["rebuilds"],
        ms_per_step=(wall - info["rebuild_seconds"]) / iters * 1e3,
        s_per_rebuild=info["rebuild_seconds"] / max(info["rebuilds"], 1),
        k3p_launches=launches.get("knn_candidates_pruned", 0),
    )
    mean, var = dk.predict_model(model, params, xte, xtr, ytr, trained_nbrs,
                                 NN)
    mean, var = mean.cpu().numpy(), var.cpu().numpy()
    params0 = dk._init_params(model, None, dev)
    nbrs0 = dk.update_nearest_neighbors(model, params0, xtr, ytr, bi, NN,
                                        DK_NN_KWARGS)[0]
    mean0 = dk.predict_model(model, params0, xte, xtr, ytr, nbrs0,
                             NN)[0].cpu().numpy()
    out.update(
        test_mse=float(np.mean((mean[:, 0] - yte[:, 0]) ** 2)),
        untrained_test_mse=float(np.mean((mean0[:, 0] - yte[:, 0]) ** 2)),
        target_var=float(np.var(yte)),
        min_var=float(var.min()),
        length_scale=float(np.exp(float(params["gp_layer.log_length_scale"]))),
        noise=float(np.exp(float(params["gp_layer.log_noise"]))),
    )
    log("phase 18 deep kernel (f32, the tutorial): " + json.dumps(out))
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < DK_LOSS_DROP * out["first_loss"], (
        "the objective did not fall to a tenth of its start")
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    assert var.min() >= 0.0
    if torch.device(dev).type == "cuda":
        assert out["k3p_launches"] > 0 and out["rebuilds"] == iters // DK_UPDATE
    out["test_config"] = deep_kernel_test_bars(torch, dev)

    # the first steps in f64, card against CPU, from the one start rng_key
    # fixes (made on the CPU, then placed)
    kept = config.state.ftype
    config.update("ftype", 64)
    try:
        got = {}
        for where in ("cpu", dev):
            _, p64, i64 = dk.train_deep_kernel_muygps(
                model, xtr, ytr, bi, NN_Wrapper(xtr, NN, device=where),
                training_iterations=DK_F64_STEPS, update_frequency=DK_UPDATE,
                nn_kwargs=DK_NN_KWARGS, learning_rate=DK_LR,
                scheduler_decay=DK_DECAY, device=where)
            got[where] = ({k: v.cpu() for k, v in p64.items()},
                          i64["final_loss"])
    finally:
        config.update("ftype", kept)
    scale = max(float(v.abs().max()) for v in got["cpu"][0].values())
    f64_rel = max(
        float((got[dev][0][k] - v).abs().max()) / scale
        for k, v in got["cpu"][0].items() if k != "embedding.4.bias"
    )
    loss_rel = abs(got[dev][1] - got["cpu"][1]) / abs(got["cpu"][1])
    out["f64_first_steps"] = dict(param_rel=f64_rel, loss_rel=loss_rel)
    log(f"phase 18 deep kernel: {DK_F64_STEPS} f64 steps, {dev} against "
        f"the CPU from one start: parameters {f64_rel:.3e} of the largest "
        f"(limit {DK_F64_RTOL}), final loss {loss_rel:.3e} relative")
    assert f64_rel <= DK_F64_RTOL, "the card's f64 steps are off the CPU's"

    # the device's idle share over one step (no rebuild inside it)
    if torch.device(dev).type == "cuda":
        x_d = torch.as_tensor(xtr, device=dev)
        y_d = torch.as_tensor(ytr, device=dev)
        stepper = dk._Stepper(model, x_d, y_d, bi, "lool", DK_LR, DK_DECAY,
                              None, torch.device(dev))
        nn_idx = torch.as_tensor(nbrs.get_batch_nns(bi)[0], device=dev)
        targets = y_d[nn_idx]
        out["step_trace"] = device_trace(
            torch, lambda: stepper.step(nn_idx, targets))
        log("phase 18 deep kernel, one step's trace: "
            + json.dumps(out["step_trace"]))

    # reporting only: the same model at 50,000 points, batch 2048
    big_n, big_batch, big_steps, big_update = big
    bx, by, _, _, brng = deep_kernel_data(np, big_n, d, big_n)
    bbi = brng.choice(big_n, big_batch, replace=False)
    t0 = time.perf_counter()
    bnbrs = NN_Wrapper(bx, NN, device=dev)
    index_s = time.perf_counter() - t0
    sync(torch, dev)
    t0 = time.perf_counter()
    _, _, binfo = dk.train_deep_kernel_muygps(
        deep_kernel_model(torch, d), bx, by, bbi, bnbrs,
        training_iterations=big_steps, update_frequency=big_update,
        nn_kwargs=DK_NN_KWARGS, **kw)
    sync(torch, dev)
    bwall = time.perf_counter() - t0
    out["at_scale"] = dict(
        points=big_n, batch=big_batch, steps=big_steps,
        raw_index_s=index_s, train_s=bwall,
        s_per_step=(bwall - binfo["rebuild_seconds"]) / big_steps,
        s_per_rebuild=binfo["rebuild_seconds"] / max(binfo["rebuilds"], 1),
        rebuilds=binfo["rebuilds"], final_loss=binfo["final_loss"],
    )
    log("phase 18 deep kernel at scale (reporting only): "
        + json.dumps(out["at_scale"]))
    return out, launches


def sine_data(np, rng, n=1500, train_frac=0.15, noise=0.1):
    """tests/test_examples.py's sine data: a grid on [0, 4 pi], 15% to
    train."""
    x = np.linspace(0, 4 * np.pi, n)[:, None]
    y = np.sin(x[:, 0])
    obs = y + noise * rng.standard_normal(n)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, int(train_frac * n), replace=False)] = True
    return x[mask], obs[mask][:, None], x[~mask], y[~mask]


def phase_fast_mean_workflows(torch, model, train, y_train, requests,
                              dev="cuda"):
    """Phase 19: examples.fast_posterior_mean.fast_posterior_mean_any on
    phase 16's trained model, points and three requests (host numpy in and
    out, NN_Wrapper(nn_method="kernel")), in f32 against the same in f64
    and against the captured fused engine, with JAX's four timing keys;
    then do_fast_posterior_mean at tests/test_examples.py's size.  Returns
    (numbers, the launches of the f32 requests)."""
    import numpy as np

    from muygpys_torch import config
    from muygpys_torch.examples.fast_posterior_mean import (
        do_fast_posterior_mean,
        fast_posterior_mean_any,
    )
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise
    from muygpys_torch.gpu import _build
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    nbrs = NN_Wrapper(train, NN, nn_method="kernel", device=dev)
    y32 = y_train.astype(np.float32)
    sync(torch, dev)
    _build.reset_launches()
    means, timings = [], []
    for r in requests:
        mean, coeffs, timing = fast_posterior_mean_any(
            model, r, train, nbrs, y32, device=dev)
        means.append(mean)
        timings.append(timing)
    sync(torch, dev)
    launches = dict(_build.launches)
    mean = np.concatenate(means)
    kept = config.state.ftype
    config.update("ftype", 64)
    try:
        mean64 = np.concatenate([
            fast_posterior_mean_any(model, r, train.astype(np.float64), nbrs,
                                    y_train, device=dev)[0]
            for r in requests
        ])
    finally:
        config.update("ftype", kept)
    server = FastServer(model, NN_Wrapper(train, NN, device=dev), train,
                        y_train, bucket=QUERIES, engine="fused", device=dev)
    fused = np.concatenate([server.predict(r)[0][:, 0] for r in requests])
    err = float(np.abs(mean - mean64).max())
    corr = float(np.corrcoef(mean, fused)[0, 1])
    out = dict(
        mean_max_abs_err=err, corr_with_fused=corr,
        coeffs_dtype=str(coeffs.dtype), timing=timings,
        k3p_launches=launches.get("knn_candidates_pruned", 0),
    )
    log(f"phase 19 fast_posterior_mean_any: three requests, f32 against "
        f"f64 {err:.3e} (limit {MEAN_TOL_F32}), correlation with the fused "
        f"engine {corr:.6f} (limit > {FAST_CORR_MIN}); timing "
        f"{json.dumps(timings)}")
    assert mean.shape == (sum(len(r) for r in requests),)
    assert err <= MEAN_TOL_F32 and corr > FAST_CORR_MIN
    assert all(set(t) == {"precompute", "agree", "nn", "pred"} and t["agree"]
               == 0.0 and min(t.values()) >= 0.0 for t in timings)
    if torch.device(dev).type == "cuda":
        assert out["k3p_launches"] > 0

    xtr, ytr, xte, yte = sine_data(np, np.random.default_rng(0))
    t0 = time.perf_counter()
    _, _, wmean, _, wtiming = do_fast_posterior_mean(
        xte, xtr, ytr, nn_count=30, k_kwargs={
            "kernel": Matern(smoothness=Parameter(1.5), deformation=Isotropy(
                l2, length_scale=Parameter(1.0))),
            "noise": HomoscedasticNoise(1e-2),
            "scale": AnalyticScale(),
        }, device=dev)
    mse = float(np.mean((np.asarray(wmean).reshape(-1) - yte) ** 2))
    out["do_fast_posterior_mean"] = dict(
        mse=mse, seconds=time.perf_counter() - t0, timing=wtiming)
    log("phase 19 do_fast_posterior_mean (tests/test_examples.py's sine): "
        + json.dumps(out["do_fast_posterior_mean"])
        + f" (limit mse < {FAST_WORKFLOW_MSE})")
    assert mse < FAST_WORKFLOW_MSE
    assert set(wtiming) == {"precompute", "agree", "nn", "pred"}
    return out, launches


# the headline loops that run a hand-written kernel, each with its inputs'
# maker and the kernels it launches
HEADLINE_KERNEL_LOOPS = (
    ("pallas_loop", {}, "make_inputs", ("fused_predict",)),
    ("pallas_coords_loop", {}, "make_coords_inputs",
     ("fused_predict_coords",)),
    ("pallas_coords_gen_loop", {}, "make_coords_inputs",
     ("fused_predict_coords",)),
    ("knn_loop", {"engine": "pallas"}, "make_serve_inputs",
     ("knn_candidates",)),
    ("end_to_end_loop", {}, "make_serve_inputs",
     ("knn_candidates_pruned", "fused_predict_coords")),
    ("fused_train_loop", {}, "make_train_inputs", ("fused_train_stats",)),
    ("fused_train_loop_gen", {}, "make_train_inputs",
     ("fused_train_stats", "matern_nu_coeffs")),
    ("shear_serve_loop", {"engine": "pallas"}, "make_shear_inputs",
     ("multiout_solve",)),
)


def phase_headline(torch, card, rows):
    """Phase 20: bench_torch.py's main in this process (its JSON line
    parsed, every rate finite and positive, its per-iteration times beside
    phases 3/4's device ms); each kernel loop of the headline harness, one
    captured replay against one eager call on the same inputs; the
    pipeline harness once with a profiler trace.  Returns (numbers, the
    launches of bench_torch.py's run and of the loops' replays)."""
    import contextlib
    import functools
    import io
    import tempfile

    import numpy as np

    import bench_torch
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.gpu import _build
    from muygpys_torch.performance import headline as h
    from muygpys_torch.performance.benchmark import BenchmarkPipeline

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        returned = bench_torch.main()
    bench_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    line = printed.getvalue().strip().splitlines()[-1]
    parsed = json.loads(line)
    log(f"phase 20 bench_torch.py ({bench_s:.1f} s): {line}")
    assert parsed == returned and parsed["device"] == card
    rates = {k: v for k, v in parsed.items()
             if k == "value" or "_per_sec" in k}
    assert len(rates) == 8
    assert all(np.isfinite(v) and v > 0 for v in rates.values()), rates
    per_iter_ms = {
        "pallas_coords_loop (K1)": h.BATCH / parsed["value"] * 1e3,
        "end_to_end_loop (K3p + K1)":
            h.BATCH / parsed["end_to_end_preds_per_sec"] * 1e3,
        "fused_train_loop (K2)": 1e3 / parsed["train_steps_per_sec"],
        "fused_train_loop_gen (K4 + K2)":
            1e3 / parsed["train_steps_per_sec_gen"],
        "pallas_coords_gen_loop (K1 gen)":
            h.BATCH / parsed["kernel_preds_per_sec_gen"] * 1e3,
        "shear_serve_loop (K5)":
            h.SHEAR_BATCH / parsed["shear_preds_per_sec"] * 1e3,
    }
    beside = {name: {k: rows[name].get(k) for k in ("ms", "device_ms")}
              for name in ("fused_predict_coords", "knn_candidates_pruned",
                           "fused_train_stats", "multiout_solve")}
    log(f"phase 20 headline per-iteration ms ({card}): "
        f"{json.dumps(per_iter_ms)}; phases 3/4 (and 6, 13) kernel ms "
        f"{json.dumps(beside)}")

    checks = {}
    for name, kw, maker, counters in HEADLINE_KERNEL_LOOPS:
        inputs = getattr(h, maker)()
        factory = functools.partial(getattr(h, name), **kw)
        loop1, program = h.compile_loops(factory, inputs)
        captured = program.outputs.clone()
        eager = loop1(*inputs)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager), (
            f"{name}: the captured iteration {float(captured)} differs from "
            f"one eager call {float(eager)}")
        assert all(program.launches.get(c, 0) > 0 for c in counters), (
            name, program.launches)
        checks[name] = dict(value=float(eager), launches=program.launches,
                            capture_ms=program.capture_ms)
        # the loops' launches count on the headline path too: knn_loop is
        # where the unpruned fused K3 runs inside a graph
        for counter, count in program.launches.items():
            launches[counter] = launches.get(counter, 0) + count
        del program, inputs
    log("phase 20 headline loops, one captured replay equal to one eager "
        "call: " + json.dumps(checks))

    with tempfile.TemporaryDirectory() as tmp:
        model = muygps_from_arrays(length_scale=LS, noise=NOISE,
                                   scale="analytic", smoothness=NU,
                                   length_scale_bounds=LS_BOUNDS)
        bench = BenchmarkPipeline(model, profile_dir=tmp)
        stages = bench.run()
        trace = os.path.join(tmp, "trace.json")
        trace_bytes = os.path.getsize(trace)
    log(f"phase 20 BenchmarkPipeline ({card}) seconds per call: "
        f"{json.dumps(stages)}; torch.profiler trace {trace_bytes} bytes")
    assert trace_bytes > 0 and all(v > 0 for v in stages.values())
    return dict(bench=parsed, bench_s=bench_s, per_iteration_ms=per_iter_ms,
                loops=checks, pipeline=stages), launches


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
    # ... and at the serving cells' shape, the bulk and fast-mean buckets'
    rows.update(phase_k3_1m(torch, k) for k in (cand_count, 9))
    # 4b. the bounded route's query order
    rows["knn_query_order"], _ = phase_query_order(torch, train, targets,
                                                   nbrs)

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
    captured = {}
    for engine in ("fused", "kernel"):
        server, e2e[engine] = serve_checked(
            "e2e", model, targets, engine, ref, VAR_TOL_F32
        )
        launches_by_path[engine] = e2e[engine]["launches"]
        # (a) the captured buckets against the eager core
        captured[engine] = captured_vs_eager(
            torch, f"captured {engine}", server, requests
        )
        e2e[engine]["trace"] = captured[engine]["trace"]
    fused_launches = launches_by_path["fused"]
    assert fused_launches["fused_predict_coords"] > 0
    assert fused_launches["knn_candidates"] == 0  # no subsample search
    assert fused_launches["knn_candidates_pruned"] > 0
    # the fused path goes through the new designs, and only through them
    assert (fused_launches["knn_candidates/fused"]
            == fused_launches["knn_candidates"]
            + fused_launches["knn_candidates_pruned"] > 0)
    assert (fused_launches["fused_predict_coords/registers"]
            == fused_launches["fused_predict_coords"] > 0)
    assert launches_by_path["kernel"]["fused_predict_coords"] > 0
    log("e2e: " + json.dumps(e2e))

    # NN_Wrapper's candidate search (1024 bins, pruned), its train side
    # built once, against the exact index on the first request
    nn_kernel = NN_Wrapper(train, NN, nn_method="kernel")
    nn_kernel.get_nns(requests[2])  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    kernel_idx, _ = nn_kernel.get_nns(requests[0])
    launches_by_path["nn_kernel"] = dict(_build.launches)
    same_nn = (np.sort(kernel_idx, 1) == np.sort(exact_idx, 1)).all(1).mean()
    log(f"NN_Wrapper(nn_method='kernel') neighbour sets equal the exact ones "
        f"on {same_nn:.6f} of queries; launches "
        f"{launches_by_path['nn_kernel']}")
    assert same_nn >= 0.98
    assert (launches_by_path["nn_kernel"]["knn_candidates/fused"]
            == launches_by_path["nn_kernel"]["knn_candidates_pruned"]
            + launches_by_path["nn_kernel"]["knn_candidates"] > 0)

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
    judge = train_numbers.pop("judge")
    launches_by_path["train"] = train_numbers.pop("launches")
    assert launches_by_path["train"]["fused_train_stats"] > 0
    assert (launches_by_path["train"]["fused_train_stats/registers"]
            == launches_by_path["train"]["fused_train_stats"])
    log("train: " + json.dumps(train_numbers))

    # 7b. (b) the training headline on the device chassis, and (c) the
    # device trainer on two batches
    y_d = torch.as_tensor(y_train, dtype=torch.float32, device="cuda")
    cw32, pw32, bt32, bnt32 = train_model().make_train_tensors(
        bi, bnn, train_d, y_d
    )
    data32 = (bt32, bnt32, cw32, pw32)
    device_numbers = {"fixed_nu": phase_device_train(torch, data32, judge)}
    launches_by_path["device_train"] = (
        device_numbers["fixed_nu"].pop("launches")
    )
    bi2, bnn2 = sample_batch(
        nbrs, TRAIN_BATCH, TRAIN, rng=np.random.default_rng(3)
    )
    cw2, pw2, bt2, bnt2 = train_model().make_train_tensors(
        bi2, bnn2, train_d, y_d
    )
    device_numbers["trainer"] = phase_device_trainer(
        torch, data32, (bt2, bnt2, cw2, pw2), judge
    )

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
    rows["matern_nu_coeffs"] = phase_k4_constructor(torch)
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
    assert (launches_by_path["dists"]["fused_predict/registers"]
            == launches_by_path["dists"]["fused_predict"] > 0)
    assert np.isfinite(m_b).all() and np.isfinite(v_b).all()
    # f32: the distance tensors themselves carry the assembly's f32
    # rounding, so K1b is held to the f64 plain version on the SAME
    # tensors, and the whole workflow to the reference engine (the same
    # assembly in f64) under the assembly's f32 floor
    err_m = float(np.abs(m_b - m_p).max())
    err_v = float(np.abs(v_b - v_p).max())
    off_m = float(np.abs(m_b - ref[0][:QUERIES]).max())
    off_v = float(np.abs(v_b - ref[1][:QUERIES]).max())
    log(f"dists path f32 (make_predict_tensors -> K1b), {QUERIES} queries: "
        f"vs the f64 plain version on the same distance tensors mean "
        f"{err_m:.3e} (tol {MEAN_TOL_F32}), var {err_v:.3e} (tol "
        f"{VAR_TOL_F32}); vs the f64 reference engine mean {off_m:.3e} (tol "
        f"{DISTS_F32_GRAM_FLOOR[0]}), var {off_v:.3e} (tol "
        f"{DISTS_F32_GRAM_FLOOR[1]}; the f32 distance assembly)")
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
    exact_gen, v_lanes, v_start = gen_numbers.pop("reference")
    log("train free nu: " + json.dumps(gen_numbers))
    # 12b. (b) the free-smoothness headline on the device chassis
    cwg, pwg, btg, bntg = free_nu_model().make_train_tensors(
        bi, bnn, train_d, y_d
    )
    device_numbers["free_nu"] = phase_device_train_free_nu(
        torch, (btg, bntg, cwg, pwg), exact_gen, v_lanes, v_start
    )
    launches_by_path["device_train_gen"] = (
        device_numbers["free_nu"].pop("launches")
    )
    log("device chassis: " + json.dumps(device_numbers))
    _, served_trained_gen = serve_checked(
        "trained free nu", trained_gen, y_train, "fused",
        reference_outputs(trained_gen, y_train),
        VAR_TOL_F32 * gen_numbers["scale"],
    )
    assert served_trained_gen["launches"]["fused_predict_coords"] > 0

    # 13. K5 against its plain version at the shear serving shape
    rows["multiout_solve"] = phase_k5(torch)

    # 14. the exact kernel at the shear request's shape, over the sky and
    # over 1,000,000 uniform rows; then shear serving end to end on the
    # 50,000-point sky
    sky, sky_targets, shear_requests = shear_sky(np)
    rows["knn_exact_select"] = phase_knn_exact(torch, sky, shear_requests[0])
    rows["knn_exact_select[1m]"] = phase_knn_exact(
        torch,
        np.random.default_rng(16).uniform(size=(1_000_000, 2)).astype(
            np.float32),
        shear_requests[0],
    )
    assert rows["knn_exact_select[1m]"]["tiles_scored_share"] < 0.02
    sky_nbrs = NN_Wrapper(sky, SHEAR_NN)
    shear_server, shear_e2e = shear_serve_checked(
        torch, "shear", shear_model(), sky_nbrs, sky, sky_targets,
        shear_requests,
    )
    launches_by_path["shear"] = shear_e2e["launches"]
    assert (launches_by_path["shear"]["multiout_solve/registers"]
            == launches_by_path["shear"]["multiout_solve"] > 0)
    # the exact NN_Wrapper searches each request with one kernel launch
    assert (launches_by_path["shear"]["knn_exact_select"]
            == len(shear_requests))
    captured["shear"] = captured_vs_eager(
        torch, "captured shear", shear_server, shear_requests
    )
    shear_e2e["trace"] = captured["shear"]["trace"]
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

    # 16. the fast posterior mean of phase 7's trained model: checkpoint,
    # precompute over every training point (K3p), three requests, a
    # MultivariateMuyGPS
    t_fast = time.perf_counter()
    fast_numbers, launches_by_path["fast_mean"], fast_row = phase_fast_mean(
        torch, card, trained, train, y_train, nbrs, requests, train_sorted
    )
    rows["knn_candidates_pruned[fast_mean]"] = fast_row
    fast_numbers["phase_s"] = time.perf_counter() - t_fast
    log("fast mean: " + json.dumps(fast_numbers))

    # 17. the user workflows: every NN_Wrapper method, do_regress (beside
    # the captured fused engine), classification with UQ, the mini-batch
    # chassis and a hierarchical length scale, each against f64 on the CPU
    t_workflows = time.perf_counter()
    _, launches_by_path["workflow_nn_kernel"] = phase_nn_methods(
        torch, train, requests[0]
    )
    (_, launches_by_path["workflow_regress"],
     launches_by_path["workflow_fused"]) = phase_do_regress(
        torch, train, y_train, requests[0]
    )
    _, launches_by_path["workflow_classify"] = phase_classify(torch)
    _, launches_by_path["workflow_mini_batch"] = phase_mini_batch(
        torch, train, y_train
    )
    for dtype in (torch.float32, torch.float64):
        phase_hierarchical(torch, dtype=dtype)
    log(f"phase 17 (workflows): {time.perf_counter() - t_workflows:.1f} s")

    # 18. the deep-kernel tutorial at its full width (K3p in the index
    # rebuilds)
    t_phase = time.perf_counter()
    _, launches_by_path["deep_kernel"] = phase_deep_kernel(torch)
    log(f"phase 18 (deep kernel): {time.perf_counter() - t_phase:.1f} s")
    # 19. the fast-mean workflow functions on phase 16's model
    t_phase = time.perf_counter()
    _, launches_by_path["fast_mean_any"] = phase_fast_mean_workflows(
        torch, trained, train, y_train, requests
    )
    log(f"phase 19 (fast-mean workflows): "
        f"{time.perf_counter() - t_phase:.1f} s")
    # 20. the headline harness (bench_torch.py) and the pipeline harness
    t_phase = time.perf_counter()
    headline_numbers, launches_by_path["headline"] = phase_headline(
        torch, card, rows)
    log(f"phase 20 (headline harness): {time.perf_counter() - t_phase:.1f} s")
    # 21. the sharded paths, in worker processes of this script: a world of
    # one over NCCL (captured, no collective) and two ranks sharing the
    # card over gloo (eager); with two cards or more also two NCCL ranks,
    # one a card
    t_phase = time.perf_counter()
    worlds = [("nccl", 1), ("gloo", 2)]
    if torch.cuda.device_count() >= 2:
        worlds.append(("nccl", 2))
    _, sharded_launches = phase_sharded(
        torch,
        sharded_payload(np, train, targets, requests, y_train, bi, bnn, sky,
                        sky_targets, shear_requests),
        judge, ref, exact_sets, headline_numbers["bench"],
        worlds=worlds,
    )
    launches_by_path.update(sharded_launches)
    if torch.cuda.device_count() < 2:
        log("phase 21: NCCL across cards did not run (one card visible)")
    log(f"phase 21 (sharded): {time.perf_counter() - t_phase:.1f} s")

    # 22. kernels line: launches on each kernel's path (serving: fused and
    # fused_gen; the distance workflow: dists; training: train and
    # train_gen; shear serving: shear; the fast posterior mean: fast_mean;
    # the workflows of phase 17: workflow_*), counted from zero just before
    # the path ran
    k1_src = "muygpys_torch/gpu/csrc/fused_predict.cu"
    k4_src = "muygpys_torch/gpu/csrc/matern_nu.cuh"
    k4_tpu = "muygpys_tpu/pallas/matern_nu.py:273"
    meta = {
        "fused_predict_coords": (
            "muygpys_torch/gpu/csrc/fused_predict.cu",
            "muygpys_tpu/pallas/fused_predict.py:373", "fused",
        ),
        # K3 unpruned at 8192 x 51,200 (the headline harness's loop); K3
        # pruned (the bounded route) there, on the fused path, and at
        # NN_Wrapper's 1024 bins
        "knn_candidates": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:217",
            "headline",
        ),
        "knn_candidates_pruned": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:451",
            "fused",
        ),
        "knn_candidates_pruned[bins1024]": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:451",
            "nn_kernel",
        ),
        # K3 pruned at the serving cells' shape (8192 x 10^6), counted on
        # the fused path
        "knn_candidates_pruned[1m,k38]": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:451",
            "fused",
        ),
        "knn_candidates_pruned[1m,k9]": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:451",
            "fused",
        ),
        # the bounded route's query order, counted on the fused path
        "knn_query_order": (
            "muygpys_torch/gpu/csrc/knn.cu",
            "none: the glue's Morton sort (XLA's in the JAX package)", "fused",
        ),
        # K3 pruned on the fast posterior mean's path: get_batch_nns over
        # every training point (the row's shape) and the requests' get_nns
        "knn_candidates_pruned[fast_mean]": (
            "muygpys_torch/gpu/csrc/knn.cu", "muygpys_tpu/pallas/knn.py:451",
            "fast_mean",
        ),
        "fused_train_stats": (
            "muygpys_torch/gpu/csrc/fused_train.cu",
            "muygpys_tpu/pallas/fused_train.py:449", "train",
        ),
        "fused_predict": (
            k1_src, "muygpys_tpu/pallas/fused_predict.py:263", "dists",
        ),
        # K4's constructor: one launch per free-nu objective evaluation (the
        # JAX package builds the vector in one jitted XLA program, whose
        # output feeds the Pallas kernels)
        "matern_nu_coeffs": (
            "muygpys_torch/gpu/csrc/matern_nu_coeffs.cu",
            "muygpys_tpu/pallas/matern_nu.py:134", "train_gen",
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
        # the exact search over the sky and over 1,000,000 rows, both
        # counted on the shear path (its NN_Wrapper's search)
        "knn_exact_select": (
            "muygpys_torch/gpu/csrc/knn_exact.cu",
            "none: the tiled addmm + topk search", "shear",
        ),
        "knn_exact_select[1m]": (
            "muygpys_torch/gpu/csrc/knn_exact.cu",
            "none: the tiled addmm + topk search", "shear",
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
        # launches of each design on the kernel's path (K3's two variants
        # share "knn_candidates/<design>")
        family = ("knn_candidates" if counter.startswith("knn_candidates")
                  else counter)
        designs_on_path = {
            key.split("/")[1]: count
            for key, count in launches_by_path[path].items()
            if key.startswith(family + "/")
        }
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches_by_path[path][counter],
            paths={p: c[counter] for p, c in launches_by_path.items()},
            # the paths that ran it inside a captured CUDA graph
            in_graph=sorted(p for p, c in launches_by_path.items()
                            if p in CAPTURED_PATHS and c[counter] > 0
                            and counter not in OUTSIDE_GRAPH),
            design_launches_on_path=designs_on_path,
            **rows[name],
        ))
    log("captured serving: " + json.dumps({
        k: {m: v[m] for m in ("captured_preds_per_s", "eager_preds_per_s",
                              "capture_ms")}
        for k, v in captured.items()
    }))
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


# -- phase 21: the sharded paths (parallel/, FastServer(mesh=, shard=), the
# sharded K2 objective, performance/scaling.py), in worker processes ------

# the worlds of the sharded phase on one card: a world of one over NCCL
# (its server captured, no collective issued) and two ranks sharing the card
# over gloo (eager); with two cards or more, two NCCL ranks a card each
SHARDED_BUCKET = QUERIES
# the reporting-only train-sharded run: rows, queries (phase 20's 1M shape)
SHARDED_1M, SHARDED_1M_QUERIES = 1_000_000, 4096
# the launch-count paths of the sharded phase, summed over every rank
SHARDED_PATHS = ("mesh_queries", "mesh_train", "mesh_train_gen",
                 "mesh_shear", "mesh_train_k2")


def _path(torch, dev, fn):
    """``(fn(), the kernels' launches during it)``: counts zeroed just
    before, read just after (the device synchronised on both sides)."""
    from muygpys_torch.gpu import _build

    sync(torch, dev)
    _build.reset_launches()
    out = fn()
    sync(torch, dev)
    return out, dict(_build.launches)


def _serve_all(server, requests):
    outs = [server.predict(r) for r in requests]
    import numpy as np

    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs]))


def _diff(a, b):
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64) - b).max())


def train_sharded_sets(torch, train_d, queries, mesh, cand_count, nn):
    """The neighbour sets the ``shard="train"`` fused server conditions on,
    by the same steps outside it (each rank's pruned K3 over its contiguous
    shard of the Morton-sorted rows, the candidates' union all-gathered,
    the exact top ``nn`` of the union), as global row numbers, sorted."""
    from muygpys_torch.gpu.knn import build_index, knn_cuda_pruned, \
        spatial_sort
    from muygpys_torch.parallel import comm, local_chunk_slice
    from muygpys_torch.parallel.mesh import mesh_group, mesh_size

    perm = spatial_sort(train_d)
    rows = local_chunk_slice(train_d.shape[0], mesh)
    local = train_d[perm][rows].contiguous()
    cand_count = min(cand_count, local.shape[0])
    index = build_index(local, bins=512, pruned=True)
    q = torch.as_tensor(queries, device=train_d.device)
    cand, _ = knn_cuda_pruned(None, q, cand_count, device=train_d.device,
                              train_index=index)
    mine = perm[rows.start + cand]
    union = comm.all_gather(mine[None], mesh_group(mesh))
    union = union.transpose(0, 1).reshape(q.shape[0],
                                          mesh_size(mesh) * cand_count)
    d2 = torch.sum((train_d[union] - q[:, None, :]) ** 2, -1)
    sel = torch.topk(d2, nn, dim=1, largest=False)[1]
    import numpy as np

    return np.sort(torch.gather(union, 1, sel).cpu().numpy(), 1)


def sharded_rank(rank, world, port, backend, payload_path, out_path):
    """One rank of a world of the sharded phase (``--sharded-rank``): (a)
    the serving headline through ``FastServer(engine="fused", mesh=,
    shard="queries")`` beside the serial server, ``shard="train"`` (and one
    request at nu = 1.2), the shear bucket (K5) under ``shard="queries"``,
    each server's mode asserted; (b) with two ranks, the training headline's
    batch sharded through ``Fused_L_BFGS_B_optimize(engine="kernel")``; (c)
    performance/scaling.py's three programs at this world's size, and the
    reporting-only train-sharded run at 1,000,000 rows.  Writes its numbers
    and outputs to ``out_path`` (.npz)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from muygpys_torch.convert import arrays_from_muygps, muygps_from_arrays
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.optimize import Fused_L_BFGS_B_optimize
    from muygpys_torch.parallel import (
        initialize_distributed,
        make_mesh,
        shard_batch,
    )
    from muygpys_torch.parallel.mesh import rank_device
    from muygpys_torch.performance import scaling
    from muygpys_torch.serve import FastServer

    p = dict(np.load(payload_path))
    dev = str(p["device"])
    if dev == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(
        device=dev, backend=backend, coordinator_address=f"localhost:{port}",
        num_processes=world, process_id=rank,
    )
    mesh, device = make_mesh(), rank_device()
    mode = "captured" if dev == "cuda" and backend == "nccl" else "eager"
    train, targets = p["train"], p["targets"]
    requests = [p[f"request{i}"] for i in range(3)]
    bucket, nn = int(p["bucket"]), int(p["nn"])
    nbrs = NN_Wrapper(train, nn, device=device)
    numbers, arrays, paths = {"rank": rank, "world": world,
                              "backend": backend}, {}, {}

    # (a) queries sharded, beside the serial (captured on a card) server
    model = muygps_from_arrays(length_scale=LS, noise=NOISE, scale=1.0,
                               smoothness=NU)
    serial = FastServer(model, nbrs, train, targets, bucket=bucket,
                        engine="fused", device=device)
    serial.predict(requests[2])
    m0, v0 = _serve_all(serial, requests)
    sharded = FastServer(model, nbrs, train, targets, bucket=bucket,
                         engine="fused", mesh=mesh, device=device)
    assert sharded.mode == mode, (sharded.mode, mode)
    sharded.predict(requests[2])
    t0 = time.perf_counter()
    (m1, v1), paths["mesh_queries"] = _path(
        torch, dev, lambda: _serve_all(sharded, requests))
    numbers["queries"] = dict(
        mode=sharded.mode, seconds=time.perf_counter() - t0,
        bit_equal=bool(np.array_equal(m0, m1) and np.array_equal(v0, v1)),
        mean_max_abs_diff=_diff(m1, m0), var_max_abs_diff=_diff(v1, v0),
    )
    arrays.update(queries_mean=m1, queries_var=v1, serial_mean=m0,
                  serial_var=v0)

    # (a) the training rows sharded: K3 pruned on each shard; nu = 1.2
    # through K1 under "gen" on one request
    all_q = np.concatenate(requests)
    arrays["train_sets"] = train_sharded_sets(
        torch, torch.as_tensor(train, device=device), all_q, mesh, nn + 8,
        nn)
    tsharded = FastServer(model, nbrs, train, targets, bucket=bucket,
                          engine="fused", mesh=mesh, shard="train",
                          device=device)
    assert tsharded.mode == mode
    tsharded.predict(requests[2])
    t0 = time.perf_counter()
    (m2, v2), paths["mesh_train"] = _path(
        torch, dev, lambda: _serve_all(tsharded, requests))
    numbers["train"] = dict(mode=tsharded.mode,
                            seconds=time.perf_counter() - t0)
    arrays.update(train_mean=m2, train_var=v2)
    gen = muygps_from_arrays(length_scale=LS, noise=NOISE, scale=1.0,
                             smoothness=NU_GEN)
    gen_serial = FastServer(gen, nbrs, train, targets, bucket=bucket,
                            engine="fused", device=device)
    mg0, vg0 = gen_serial.predict(requests[0])
    gen_sharded = FastServer(gen, nbrs, train, targets, bucket=bucket,
                             engine="fused", mesh=mesh, shard="train",
                             device=device)
    (mg, vg), paths["mesh_train_gen"] = _path(
        torch, dev, lambda: gen_sharded.predict(requests[0]))
    arrays.update(gen_mean=mg, gen_var=vg, gen_serial_mean=mg0,
                  gen_serial_var=vg0)

    # (a) the shear bucket (K5) under shard="queries"
    sky, sky_targets = p["sky"], p["sky_targets"]
    shear_requests = [p[f"shear_request{i}"] for i in range(3)]
    sky_nbrs = NN_Wrapper(sky, SHEAR_NN, device=device)
    s_serial = FastServer(shear_model(), sky_nbrs, sky, sky_targets,
                          bucket=int(p["shear_bucket"]), engine="kernel",
                          device=device)
    s_serial.predict(shear_requests[2])
    sm0, sc0 = _serve_all(s_serial, shear_requests)
    s_sharded = FastServer(shear_model(), sky_nbrs, sky, sky_targets,
                           bucket=int(p["shear_bucket"]), engine="kernel",
                           mesh=mesh, device=device)
    assert s_sharded.mode == mode
    s_sharded.predict(shear_requests[2])
    (sm1, sc1), paths["mesh_shear"] = _path(
        torch, dev, lambda: _serve_all(s_sharded, shear_requests))
    numbers["shear"] = dict(
        mode=s_sharded.mode,
        bit_equal=bool(np.array_equal(sm0, sm1)
                       and np.array_equal(sc0, sc1)),
        mean_max_abs_diff=_diff(sm1, sm0), cov_max_abs_diff=_diff(sc1, sc0),
    )

    # (b) the training headline's batch sharded over the ranks (K2)
    if world > 1:
        tm = train_model()
        dtype = torch.float32 if dev == "cuda" else torch.float64
        cw, pw, bt, bnt = tm.make_train_tensors(
            p["bi"], p["bnn"], torch.as_tensor(train, device=device),
            torch.as_tensor(p["y_train"], dtype=dtype, device=device),
        )
        sharded_batch = shard_batch((bt, bnt, cw, pw), mesh)
        import scipy.optimize  # noqa: F401  (its import outside the timing)

        t0 = time.perf_counter()
        trained, paths["mesh_train_k2"] = _path(
            torch, dev, lambda: Fused_L_BFGS_B_optimize(
                tm, *sharded_batch, engine="kernel", device=device))
        vals = arrays_from_muygps(trained)
        numbers["training"] = dict(
            length_scale=float(vals["length_scale"]),
            noise=float(vals["noise"]), seconds=time.perf_counter() - t0,
            local_rows=int(sharded_batch[0].to_local().shape[0]),
        )

    # (c) scaling.py's programs at this world's size, and 1M rows sharded
    numbers["scaling"] = scaling.world_records(
        scaling.TRAIN_PROGRAMS + ("fused_serve_shard_train",),
        dict(batch_per_device=int(p["scaling_batch"]), nn=30, steps=5,
             warmup=1, bucket_per_device=512,
             train_per_device=int(p["scaling_train"])),
        mesh, device,
    )
    rng = np.random.default_rng(3)
    rows_1m, q_1m = int(p["rows_1m"]), int(p["queries_1m"])
    x1m = rng.uniform(size=(rows_1m, D)).astype(np.float32)
    y1m = rng.standard_normal((rows_1m, 1)).astype(np.float32)
    q1m = rng.uniform(size=(q_1m, D)).astype(np.float32)
    s1m = FastServer(model, NN_Wrapper(x1m[:nn + 1], nn, device=device),
                     x1m, y1m, bucket=q_1m, engine="fused", mesh=mesh,
                     shard="train", device=device)
    # the shard's boxes on the grid the whole table was sorted on: their
    # first codes rise with the rows, as the home search needs
    index = s1m._search_index
    if index is not None and index.boxes is not None:
        first = index.boxes.first
        assert bool((torch.diff(first) >= 0).all()), "shard boxes' codes"
    m1m, v1m = s1m.predict(q1m)
    assert np.isfinite(m1m).all() and np.isfinite(v1m).all()
    sync(torch, dev)
    before = s1m.search_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        s1m.predict(q1m)
    dt = (time.perf_counter() - t0) / 5
    after = s1m.search_stats()
    numbers["serve_1m"] = dict(
        rows=rows_1m, queries=q_1m, mode=s1m.mode, request_seconds=dt,
        preds_per_sec=q_1m / dt,
        **{k: after[k] - before[k] for k in after})
    numbers["paths"] = paths
    np.savez(out_path, numbers=json.dumps(numbers), **arrays)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_payload(np, train, targets, requests, y_train, bi, bnn, sky,
                    sky_targets, shear_requests, dev="cuda", **sizes):
    """The arrays and sizes every rank of the sharded phase reads."""
    out = dict(
        device=dev, train=train, targets=targets, y_train=y_train, bi=bi,
        bnn=bnn, sky=sky, sky_targets=sky_targets,
        bucket=sizes.get("bucket", SHARDED_BUCKET), nn=NN,
        shear_bucket=sizes.get("shear_bucket", SHEAR_BATCH),
        scaling_batch=sizes.get("scaling_batch", 1024),
        scaling_train=sizes.get("scaling_train", 2048),
        rows_1m=sizes.get("rows_1m", SHARDED_1M),
        queries_1m=sizes.get("queries_1m", SHARDED_1M_QUERIES),
    )
    out.update({f"request{i}": r for i, r in enumerate(requests)})
    out.update({f"shear_request{i}": r for i, r in enumerate(shear_requests)})
    return out


def run_world(world, backend, payload_path, out_dir, timeout=600):
    """Start the ranks of one world (this script with ``--sharded-rank``),
    wait for them, and return their results in rank order; fails unless
    every rank exits 0."""
    import socket

    import numpy as np

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(out_dir, f"{backend}{world}_rank{r}.npz")
            for r in range(world)]
    procs = [
        subprocess.Popen([
            sys.executable, os.path.abspath(__file__), "--sharded-rank",
            str(r), str(world), str(port), backend, payload_path, outs[r],
        ])
        for r in range(world)
    ]
    try:
        rcs = [proc.wait(timeout=timeout) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert rcs == [0] * world, f"sharded {backend} world of {world}: {rcs}"
    results = []
    for path in outs:
        with np.load(path) as f:
            res = {k: f[k] for k in f.files if k != "numbers"}
            res.update(json.loads(str(f["numbers"])))
        results.append(res)
    return results


def phase_sharded(torch, payload, judge, ref, exact_sets, bench, dev="cuda",
                  worlds=(("nccl", 1), ("gloo", 2))):
    """Phase 21: the sharded paths in worker processes started here, each
    world in turn; every rank's checks in the worker (modes), the rest here
    (the f64 reference and the exact sets of phase 5, phase 7's gates).
    Returns (numbers, the launches of each sharded path summed over every
    rank)."""
    import tempfile

    import numpy as np

    out_dir = tempfile.mkdtemp(
        dir=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build"))
    payload_path = os.path.join(out_dir, "payload.npz")
    np.savez(payload_path, **payload)
    m_ref, v_ref = ref
    launches = {p: {} for p in SHARDED_PATHS}
    numbers = {}
    for backend, world in worlds:
        t0 = time.perf_counter()
        results = run_world(world, backend, payload_path, out_dir)
        label = f"{backend}/{world}"
        r0 = results[0]
        # every rank returns the whole answer, the same on every rank
        for res in results[1:]:
            for key in ("queries_mean", "train_mean", "gen_mean"):
                assert np.array_equal(res[key], r0[key]), (label, key)
        q = r0["queries"]
        log(f"phase 21 {label}: shard='queries' fused ({q['mode']}) "
            f"bit-equal to the serial server: {q['bit_equal']} (mean "
            f"{q['mean_max_abs_diff']:.3e}, var {q['var_max_abs_diff']:.3e});"
            f" the three requests in {q['seconds'] * 1e3:.2f} ms")
        same = (r0["train_sets"] == exact_sets).all(1)
        err_m = float(np.abs(r0["train_mean"] - m_ref)[same].max())
        err_v = float(np.abs(r0["train_var"] - v_ref)[same].max())
        gmask = same[:len(r0["gen_mean"])]
        err_gm = _diff(r0["gen_mean"][gmask], r0["gen_serial_mean"][gmask])
        err_gv = _diff(r0["gen_var"][gmask], r0["gen_serial_var"][gmask])
        log(f"phase 21 {label}: shard='train' ({r0['train']['mode']}) sets "
            f"equal the exact ones on {same.mean():.6f} of queries; against "
            f"the f64 reference on them: mean {err_m:.3e} (tol "
            f"{MEAN_TOL_F32}), var {err_v:.3e} (tol {VAR_TOL_F32}); nu = "
            f"{NU_GEN} against the serial fused server: mean {err_gm:.3e}, "
            f"var {err_gv:.3e}; the three requests in "
            f"{r0['train']['seconds'] * 1e3:.2f} ms")
        assert same.mean() >= 0.98, f"{label} train-sharded sets"
        assert err_m <= MEAN_TOL_F32 and err_v <= VAR_TOL_F32, label
        assert err_gm <= MEAN_TOL_F32 and err_gv <= VAR_TOL_F32, label
        for res in results:
            assert np.isfinite(res["queries_mean"]).all()
        if not q["bit_equal"]:
            # the same arithmetic per query: a difference can only come
            # from a neighbour set; hold it to the serving limits
            serial_err_m = _diff(r0["queries_mean"][same], m_ref[same])
            assert serial_err_m <= MEAN_TOL_F32, label
        s = r0["shear"]
        log(f"phase 21 {label}: shear shard='queries' ({s['mode']}) "
            f"bit-equal to the serial server: {s['bit_equal']} (mean "
            f"{s['mean_max_abs_diff']:.3e}, cov {s['cov_max_abs_diff']:.3e})")
        prior = float(shear_model().kernel.Kout().diagonal().max())
        assert s["bit_equal"] or (
            s["mean_max_abs_diff"] <= SHEAR_MEAN_REL_F32 * prior
            and s["cov_max_abs_diff"] <= SHEAR_COV_REL_F32 * prior), label
        if world > 1:
            params = [(res["training"]["length_scale"],
                       res["training"]["noise"]) for res in results]
            assert len(set(params)) == 1, f"{label}: ranks disagree {params}"
            tr = r0["training"]
            log(f"phase 21 {label}: training batch "
                f"{tr['local_rows'] * world} sharded "
                f"({tr['local_rows']} rows a rank): length_scale "
                f"{tr['length_scale']!r}, noise {tr['noise']!r} on every "
                f"rank, {tr['seconds']:.2f} s")
            judge(f"phase 21 {label} sharded training",
                  {"length_scale": tr["length_scale"],
                   "noise": tr["noise"]})
        recs = r0["scaling"]
        one_m = r0["serve_1m"]
        log(f"phase 21 {label}: scaling.py's programs (mechanics, not "
            "scaling: one card) "
            + json.dumps(recs))
        log(f"phase 21 {label}: shard='train' at {one_m['rows']} rows, "
            f"{one_m['queries']} queries ({one_m['mode']}): "
            f"{one_m['preds_per_sec']:.1f} preds/s (reporting only; phase "
            f"20's single-card 1M end to end: "
            f"{bench.get('end_to_end_preds_per_sec_1m')} preds/s); rank 0's "
            f"shard walked {one_m['boxes_scored']} of "
            f"{one_m['boxes_total']} boxes")
        for res in results:
            for path, counts in res["paths"].items():
                for k, v in counts.items():
                    launches[path][k] = launches[path].get(k, 0) + v
        numbers[label] = dict(
            seconds=time.perf_counter() - t0, queries=q, shear=s,
            train=dict(sets_exact=float(same.mean()), mean_err=err_m,
                       var_err=err_v, gen_mean_err=err_gm,
                       gen_var_err=err_gv),
            training=r0.get("training"), scaling=recs, serve_1m=one_m,
        )
    # the CPU rehearsal runs the plain versions, which count no launch
    for path, counters in () if dev != "cuda" else (
            ("mesh_queries", ("fused_predict_coords",
                              "knn_candidates_pruned")),
            ("mesh_train", ("fused_predict_coords",
                            "knn_candidates_pruned")),
            ("mesh_train_gen", ("fused_predict_coords",)),
            ("mesh_shear", ("multiout_solve", "knn_exact_select")),
            ("mesh_train_k2", ("fused_train_stats",))):
        for c in counters:
            assert launches[path].get(c, 0) > 0, (path, c, launches[path])
    return numbers, launches


def query_order_only() -> int:
    """``--query-order``: phase 4b alone on the headline set, then one
    JSON line of its readings."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from muygpys_torch.gpu import _build
    from muygpys_torch.neighbors import NN_Wrapper

    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    seconds = _build.build(("knn", "fused_predict", "knn_exact"))
    log(f"build: {json.dumps(seconds)}")
    report = _build.library_path("knn").with_suffix(".log").read_text()
    for kernel, numbers in ptxas_report(report).items():
        log(f"  {kernel}: {numbers}")
    rng = np.random.default_rng(1)
    train = rng.uniform(size=(TRAIN, D)).astype(np.float32)
    targets = rng.standard_normal((TRAIN, 1)).astype(np.float32)
    row, readings = phase_query_order(torch, train, targets,
                                      NN_Wrapper(train, NN))
    print(json.dumps({"knn_query_order": row, **readings}), flush=True)
    return 0


def exact_bench(root) -> int:
    """``--exact-bench ROOT``: five timings each of the exact search
    (NN_Wrapper("exact").get_nns, one request of 8192 against the 50,000
    headline points) and of phase 14's three shear requests, with the
    muygpys_torch package at ROOT."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np

    import muygpys_torch
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    rng = np.random.default_rng(1)
    train = rng.uniform(size=(TRAIN, D)).astype(np.float32)
    rng.standard_normal((TRAIN, 1))
    request = rng.uniform(size=(QUERIES, D)).astype(np.float32)
    nbrs = NN_Wrapper(train, NN)
    nbrs.get_nns(request[:64])
    get_nns_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        nbrs.get_nns(request)  # numpy out: synchronised
        get_nns_s.append(time.perf_counter() - t0)
    sky, sky_targets, shear_requests = shear_sky(np)
    server = FastServer(shear_model(), NN_Wrapper(sky, SHEAR_NN), sky,
                        sky_targets, bucket=SHEAR_BATCH, engine="kernel")
    server.predict(shear_requests[-1])
    rates = [serve(torch, server, shear_requests)[2] for _ in range(5)]
    print(json.dumps({"package": os.path.dirname(muygpys_torch.__file__),
                      "get_nns_s": get_nns_s,
                      "shear_preds_per_s": rates}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--exact-bench"]:
        sys.exit(exact_bench(sys.argv[2]))
    if sys.argv[1:2] == ["--query-order"]:
        sys.exit(query_order_only())
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        a = sys.argv[2:]
        sys.exit(sharded_rank(int(a[0]), int(a[1]), int(a[2]), a[3], a[4],
                              a[5]))
    sys.exit(main())
