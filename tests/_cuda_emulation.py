"""The hand-written CUDA sources (K1/K1b, K2, K3, K4's constructor and K5) run
on the CPU, one thread per CUDA thread, for
``tests/test_torch_cuda_emulation.py``.

A machine without a card or ``nvcc`` cannot run ``muygpys_torch/gpu/csrc``.
:func:`build` compiles any of its five ``.cu`` sources with the host's C++20
compiler against a small emulation of the CUDA subset they use: a
``std::thread`` per CUDA thread, ``std::barrier`` for ``__syncthreads`` and
``__syncwarp``, an exchange slot for the warp shuffles, ballots and
reductions, ``memcpy`` for the asynchronous copies, plain loads for the
read-only ones, IEEE single operations
for the round-to-nearest intrinsics (compiled without contraction, so no
fused multiply-add), and shared memory filled with garbage before each
block.  The C entry points are then called through ``ctypes`` on CPU
tensors.  Built with ThreadSanitizer (``tsan=True``) and run in a child
process that preloads the sanitizer's runtime (:func:`race_report`), one
launch reports any data race between the emulated threads: a missing
barrier on the card.

What this checks is the arithmetic and the synchronisation of the sources,
not their speed, their registers or the card's memory model.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CSRC = os.path.join(REPO, "muygpys_torch", "gpu", "csrc")

HEADER = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))
#define __shared__ static

using std::fabs; using std::fma; using std::fmax; using std::max; using std::min;

struct dim3e { int x = 0, y = 0; };
inline thread_local dim3e threadIdx, blockIdx, blockDim;
struct dim3 {
  int x, y, z;
  dim3(int a = 1, int b = 1, int c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
struct int2 { int x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline int __float_as_int(float x) { int i; std::memcpy(&i, &x, 4); return i; }
inline float __int_as_float(int i) { float x; std::memcpy(&x, &i, 4); return x; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
inline double __dsqrt_rn(double x) { return std::sqrt(x); }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline double __drcp_rn(double x) { return 1.0 / x; }
// glibc's lgamma writes the global signgam (a race between the emulated
// threads); CUDA's keeps no such state
inline double emu_lgamma(double x) { int s; return lgamma_r(x, &s); }
inline float emu_lgammaf(float x) { int s; return lgammaf_r(x, &s); }
#define lgamma emu_lgamma
#define lgammaf emu_lgammaf

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributePreferredSharedMemoryCarveout = 9,
       cudaSharedmemCarveoutMaxShared = 100 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
template <typename F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }

struct WarpCtx { std::barrier<> bar{32}; double slot[32]; };
inline thread_local WarpCtx* my_warp = nullptr;
inline thread_local std::barrier<>* my_block = nullptr;
inline unsigned char* emu_dyn_smem = nullptr;

inline void __syncthreads() { my_block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { my_warp->bar.arrive_and_wait(); }
template <typename T> inline T shfl_from(T v, int src) {
  my_warp->bar.arrive_and_wait();
  my_warp->slot[threadIdx.x % 32] = (double)v;
  my_warp->bar.arrive_and_wait();
  T r = (T)my_warp->slot[src & 31];
  my_warp->bar.arrive_and_wait();
  return r;
}
template <typename T> inline T __shfl_sync(unsigned, T v, int src) { return shfl_from(v, src); }
// every lane's value, in lane order, to every lane
inline void warp_gather(double v, double* all) {
  my_warp->bar.arrive_and_wait();
  my_warp->slot[threadIdx.x % 32] = v;
  my_warp->bar.arrive_and_wait();
  std::memcpy(all, my_warp->slot, sizeof(my_warp->slot));
  my_warp->bar.arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, int pred) {
  double all[32];
  warp_gather(pred ? 1.0 : 0.0, all);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (all[l] != 0.0 ? 1u : 0u) << l;
  return m;
}
inline int __reduce_add_sync(unsigned, int v) {
  double all[32];
  warp_gather((double)v, all);
  int s = 0;
  for (int l = 0; l < 32; ++l) s += (int)all[l];
  return s;
}
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  return shfl_from(v, (threadIdx.x % 32) ^ m);
}
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) { std::memcpy(d, s, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}

inline dim3 as_grid(int g) { return dim3(g); }
inline dim3 as_grid(dim3 g) { return g; }

template <typename K, typename G, typename... A>
void emu_launch(K kernel, G grid_size, int block, size_t bytes, A... args) {
  std::vector<unsigned char> smem(bytes + 64);
  const dim3 grid = as_grid(grid_size);
  for (int by = 0; by < grid.y; ++by)
  for (int bx = 0; bx < grid.x; ++bx) {
    std::fill(smem.begin(), smem.end(), 0xAB);  // garbage, as on the card
    emu_dyn_smem = smem.data();
    std::barrier<> bbar(block);
    std::vector<std::unique_ptr<WarpCtx>> warps;
    for (int w = 0; w < (block + 31) / 32; ++w) warps.emplace_back(new WarpCtx());
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = bx; blockIdx.y = by; blockDim.x = block;
        my_warp = warps[t / 32].get(); my_block = &bbar;
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
"""


def translate(source: str) -> str:
    """A .cu source as C++ the emulation header compiles."""
    s = source.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    s = s.replace("#include <cuda_pipeline.h>\n", "")
    s = re.sub(r"extern __shared__ (__align__\(16\) )?unsigned char smem_raw\[\];",
               "unsigned char* smem_raw = emu_dyn_smem;", s)
    return re.sub(
        r"([\w:<>, ]+?)<<<([^,]+), ([^,]+), ([^,]+), [^>]+>>>\(",
        lambda m: (f"emu_launch({m.group(1).strip()}, {m.group(2)}, "
                   f"{m.group(3)}, {m.group(4)}, "), s)


def compiler_ready(out_dir: str) -> str:
    """Why the emulation cannot be built here, or "" when ``g++`` compiles
    C++20 ``<barrier>`` and ``<thread>``."""
    if shutil.which("g++") is None:
        return "no g++"
    probe = os.path.join(out_dir, "probe.cpp")
    with open(probe, "w") as f:
        f.write("#include <barrier>\n#include <thread>\n"
                "int main() { std::barrier<> b(1); b.arrive_and_wait(); }\n")
    res = subprocess.run(["g++", "-std=c++20", "-pthread", "-o",
                          probe[:-4], probe], capture_output=True, text=True)
    return "" if res.returncode == 0 else "g++ lacks C++20 <barrier>"


def tsan_runtime() -> str:
    """The path of ThreadSanitizer's runtime, or "" when ``g++`` has none."""
    path = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                          capture_output=True, text=True).stdout.strip()
    return path if os.path.isabs(path) and os.path.exists(path) else ""


def build(name: str, out_dir: str, tsan: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` against the emulation into a shared
    library under ``out_dir``; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cuda_emu.h"), "w") as f:
        f.write(HEADER)
    for header in ("matern_nu.cuh",):
        shutil.copyfile(os.path.join(CSRC, header), os.path.join(out_dir, header))
    cpp = os.path.join(out_dir, f"{name}.cpp")
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        text = translate(f.read())
    with open(cpp, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"lib{name}{'_tsan' if tsan else ''}.so")
    flags = ["-fsanitize=thread", "-g"] if tsan else []
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", out_dir, *flags, "-o", lib,
                    cpp], check=True, capture_output=True)
    return lib


P = ctypes.c_void_p


def ptr(t):
    return P(0 if t is None else t.data_ptr())


def k2_run(lib, design, pw, cw, y, params, noise_nn, gen, code, power,
           noise_free, free, d_feat):
    """One K2 launch of ``design`` (1 registers, 0 shared memory)."""
    from muygpys_torch.gpu.fused_train import train_tail_terms

    n, r, B = y.shape
    rows = (r + 2) + (d_feat or 1) * (r + 2) + (r + 1) + (r + 2) * free
    out = torch.full((rows, B), math.nan, dtype=pw.dtype)
    fn = (lib.fused_train_stats_f32 if pw.dtype == torch.float32
          else lib.fused_train_stats_f64)
    fn.argtypes = [P] * 7 + [ctypes.c_int] * 11 + [P]
    rc = fn(*(ptr(t) for t in (pw, cw, y, params, noise_nn, gen)), ptr(out),
            n, d_feat, r, B, code, power, int(noise_free), int(free),
            0 if gen is None else gen.numel(), train_tail_terms(pw.dtype),
            design, None)
    assert rc == 0, f"K2 launcher refused: {rc}"
    return out


#: K2 cases: (n, smoothness, metric_power, noise_free, r, d_feat,
#: heteroscedastic, free nu)
K2_CASES = [
    (8, 1.5, 1, True, 1, 0, False, False),
    (30, 1.5, 1, True, 1, 0, False, False),
    (32, 1.5, 1, True, 1, 0, False, False),
    (33, 1.5, 1, True, 1, 0, False, False),
    (30, 0.5, 1, False, 1, 0, False, False),
    (30, "rbf", 2, True, 2, 0, False, False),
    (30, 2.5, 1, False, 1, 2, False, False),
    (30, math.inf, 1, True, 2, 2, False, False),
    (30, 1.5, 1, False, 1, 0, True, False),
    (30, 1.5, 1, True, 3, 0, False, False),
    (12, 1.5, 1, True, 5, 0, False, False),
    (30, "gen", 1, True, 1, 0, False, False),
    (30, "gen", 1, True, 1, 0, False, True),
    (20, "gen", 1, False, 2, 2, False, True),
]


def k2_errors(lib, case, dtype, B=11):
    """K2 through each design that takes ``case`` against the plain
    version: the largest row error over the row's magnitude, by design."""
    from muygpys_torch.gpu.fused_train import (
        _smoothness_code,
        fused_train_stats_bl_plain,
    )
    from muygpys_torch.gpu.matern_nu import matern_nu_coeffs

    n, nu, power, noise_free, r, d_feat, hetero, free = case
    g = torch.Generator().manual_seed(n + r)
    scale = 0.6 if nu == "gen" else 0.05
    pts = torch.rand((n, 2, B), generator=g, dtype=torch.float64) * scale
    q = torch.rand((2, B), generator=g, dtype=torch.float64) * scale
    dp, dc = pts[:, None] - pts[None], pts - q[None]
    if d_feat:
        pw, cw, ls = dp, dc, [0.3, 0.4]
    else:
        pw, cw, ls = (dp**2).sum(2), (dc**2).sum(1), [0.3]
        if power == 1:
            pw, cw = pw.sqrt(), cw.sqrt()
    params = torch.tensor(ls + [2e-2, 1e-2], dtype=dtype)
    y = torch.randn((n, r, B), generator=g, dtype=torch.float64).to(dtype)
    noise_nn = ((torch.rand((n, B), generator=g, dtype=torch.float64)
                 * 1e-2 + 1e-2).to(dtype) if hetero else None)
    pw, cw = pw.to(dtype).contiguous(), cw.to(dtype).contiguous()
    gen = (matern_nu_coeffs(torch.tensor(1.2, dtype=dtype), need_dnu=free)
           if nu == "gen" else None)
    code = _smoothness_code(nu, gen, power, free)
    ref = fused_train_stats_bl_plain(pw, cw, y, params, noise_nn, gen,
                                     nu, power, noise_free, free, d_feat)
    errors = {}
    for design in ((1, 0) if n <= 32 and r <= 4 else (0,)):
        out = k2_run(lib, design, pw, cw, y, params, noise_nn, gen, code,
                     power, noise_free, free, d_feat)
        assert torch.isfinite(out).all()
        errors[("shared", "registers")[design]] = float(
            ((out - ref).abs().amax(1)
             / ref.abs().amax(1).clamp_min(1e-300)).max())
    return errors


def k5_inputs(m, B, dtype, o=3, seed=0):
    """An unsymmetric batch of K5 inputs (the column is read from the lower
    triangle, the row from the upper) whose block 1 is singular
    (duplicated rows): frontend ``(Kin, Kcross, y)`` and batch-last."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, 2 * m))
    flat = A @ A.transpose(0, 2, 1) / (2 * m) + 0.5 * np.eye(m)
    flat = flat + 1e-3 * rng.standard_normal(flat.shape)
    flat[1, 5, :] = flat[1, 4, :]
    flat[1, :, 5] = flat[1, :, 4]
    front = [torch.as_tensor(a, dtype=dtype).contiguous() for a in
             (flat, rng.standard_normal((B, m, o)),
              rng.standard_normal((B, m)))]
    last = [t.permute(*range(1, t.ndim), 0).contiguous() for t in front]
    return front, last


def k5_run(lib, design, ins, m, o, B, batch_last):
    """One K5 launch of ``design`` (1 registers, 0 shared memory)."""
    dtype = ins[0].dtype
    mean = torch.empty((o, B) if batch_last else (B, o), dtype=dtype)
    S = torch.empty((o, o, B) if batch_last else (B, o, o), dtype=dtype)
    fn = lib.multiout_solve_f32 if dtype == torch.float32 else lib.multiout_solve_f64
    fn.argtypes = [P] * 5 + [ctypes.c_int] * 5 + [P]
    rc = fn(*(ptr(t) for t in (*ins, mean, S)), m, o, B, int(batch_last),
            design, None)
    assert rc == 0, f"K5 launcher refused: {rc}"
    return mean, S


#: one small launch of each design, run under ThreadSanitizer
RACE_LAUNCHES = ("k2-registers", "k2-shared", "k2-registers-free-nu",
                 "k5-shared-24", "k5-registers-60", "k5-registers-90",
                 "k3-fused", "k3-fused-pruned", "k1-registers",
                 "k1-registers-gen", "k1b-registers", "k1b-registers-gen",
                 "k4-coeffs")


def race_launch(out_dir: str, launch: str) -> None:
    """Run one launch of :data:`RACE_LAUNCHES` through the ThreadSanitizer
    builds in ``out_dir`` (in the child process :func:`race_report`
    starts)."""
    if launch.startswith("k3"):
        lib = ctypes.CDLL(os.path.join(out_dir, "libknn_tsan.so"))
        prep = k3_problem(n_train=2048, n_query=16,
                          pruned=launch.endswith("pruned"))
        k3_select(lib, prep, 38)
        return
    if launch.startswith("k4"):
        lib = ctypes.CDLL(os.path.join(out_dir, "libmatern_nu_coeffs_tsan.so"))
        coeffs_run(lib, torch.tensor([1.2], dtype=torch.float64), True,
                   tangent=True)
        return
    if launch.startswith("k1b"):
        lib = ctypes.CDLL(os.path.join(out_dir, "libfused_predict_tsan.so"))
        nu = "gen" if launch.endswith("gen") else 1.5
        k1b_run(lib, 1, *k1b_inputs(30, 2, 9, torch.float32, nu=nu), nu, 1)
        return
    if launch.startswith("k1"):
        lib = ctypes.CDLL(os.path.join(out_dir, "libfused_predict_tsan.so"))
        nu = "gen" if launch.endswith("gen") else 1.5
        ins = k1_inputs(30, 2, 1, 9, torch.float32, hetero=True, nu=nu)
        k1_run(lib, 1, *ins, nu, 1)
        return
    if launch.startswith("k2"):
        from muygpys_torch.gpu.matern_nu import matern_nu_coeffs

        lib = ctypes.CDLL(os.path.join(out_dir, "libfused_train_tsan.so"))
        free = launch.endswith("free-nu")
        n, B, r = (20 if free else 30), 9, 1
        g = torch.Generator().manual_seed(0)
        pts = torch.rand((n, 2, B), generator=g, dtype=torch.float64) * 0.3
        q = torch.rand((2, B), generator=g, dtype=torch.float64) * 0.3
        pw = ((pts[:, None] - pts[None]) ** 2).sum(2).sqrt().contiguous()
        cw = ((pts - q[None]) ** 2).sum(1).sqrt().contiguous()
        y = torch.randn((n, r, B), generator=g, dtype=torch.float64)
        params = torch.tensor([0.3, 2e-2, 1e-2], dtype=torch.float64)
        gen = (matern_nu_coeffs(torch.tensor(1.2, dtype=torch.float64), True)
               if free else None)
        design = 0 if launch == "k2-shared" else 1
        k2_run(lib, design, pw, cw, y, params, None, gen, 5 if free else 1, 1,
               True, free, 0)
    else:
        lib = ctypes.CDLL(os.path.join(out_dir, "libmultiout_solve_tsan.so"))
        _, design, m = launch.split("-")
        front, _ = k5_inputs(int(m), 2, torch.float32)
        k5_run(lib, int(design == "registers"), front, int(m), 3, 2, False)


def race_report(out_dir: str, launch: str):
    """Run :func:`race_launch` in a child process with ThreadSanitizer's
    runtime preloaded; returns (its exit code, the number of races it
    reported, its standard error)."""
    env = dict(os.environ, LD_PRELOAD=tsan_runtime(),
               PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, _cuda_emulation as e; e.race_launch(*sys.argv[1:])",
         out_dir, launch],
        env=env, capture_output=True, text=True, cwd=REPO,
    )
    return (res.returncode, res.stderr.count("WARNING: ThreadSanitizer"),
            res.stderr)


def k3_problem(n_train=2048, n_query=24, d=2, pruned=False, bins=256, k=38,
               seed=0, query_tile=8, train_tile=256):
    """A K3 search prepared by the glue on the CPU: a uniform Morton-sorted
    train set and queries clustered in one corner (so the pruned variant
    skips tiles)."""
    from muygpys_torch.gpu import knn as K

    rng = np.random.default_rng(seed)
    train = torch.as_tensor(rng.uniform(size=(n_train, d)).astype(np.float32))
    train = train[K.spatial_sort(train)]
    queries = torch.as_tensor(
        (0.1 * rng.uniform(size=(n_query, d))).astype(np.float32))
    prep = (K.prepare_pruned if pruned else K.prepare)(
        train, queries, k, query_tile=query_tile, train_tile=train_tile,
        bins=bins)
    return prep


def k3_select(lib, prep, k):
    """One launch of the fused K3 design: ``(idx, d2)`` of ``(Q_pad, k)``."""
    q_count, feat = prep.q.shape
    idx = torch.full((q_count, k), -1, dtype=torch.int64)
    d2 = torch.full((q_count, k), math.nan, dtype=torch.float32)
    fn = lib.knn_select
    fn.argtypes = [P] * 8 + [ctypes.c_int] * 9 + [P]
    rc = fn(*(ptr(t) for t in (prep.q, prep.qsq, prep.tT, prep.tsq, prep.lb,
                               prep.ub, idx, d2)),
            q_count, feat, prep.tT.shape[1], prep.bins, prep.train_tile,
            prep.query_tile, prep.chunk_mask, k, prep.train_count, None)
    assert rc == 0, f"K3 launcher refused: {rc}"
    return idx, d2


def k3_keys(lib, prep):
    """One launch of the kept K3 design: ``s1, s2`` of ``(Q_pad, bins)``."""
    q_count, feat = prep.q.shape
    s1 = torch.zeros((q_count, prep.bins), dtype=torch.int32)
    s2 = torch.zeros_like(s1)
    fn = lib.knn_candidates
    fn.argtypes = [P] * 8 + [ctypes.c_int] * 7 + [P]
    rc = fn(*(ptr(t) for t in (prep.q, prep.qsq, prep.tT, prep.tsq, prep.lb,
                               prep.ub, s1, s2)),
            q_count, feat, prep.tT.shape[1], prep.bins, prep.train_tile,
            prep.query_tile, prep.chunk_mask, None)
    assert rc == 0, f"K3 launcher refused: {rc}"
    return s1, s2


def k1_inputs(n, d, r, B, dtype, hetero=False, seed=0, nu=1.5):
    """K1 inputs ``(nf, q, y, params, noise_nn, gen)`` on the CPU."""
    from muygpys_torch.gpu.matern_nu import matern_nu_coeffs_host

    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64, generator=g)
    nf = torch.rand((n, d, B), **f64).to(dtype)
    q = torch.rand((d, B), **f64).to(dtype)
    y = torch.randn((n, r, B), **f64).to(dtype)
    params = torch.tensor([0.5, 0.7, 0.9][:d] + [1e-3], dtype=dtype)
    noise_nn = (torch.rand((n, B), **f64) * 1e-2 + 1e-4).to(dtype) if hetero else None
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    gen = (torch.as_tensor(matern_nu_coeffs_host(1.2, np_dtype))
           if nu == "gen" else None)
    return nf, q, y, params, noise_nn, gen


def k1_run(lib, design, nf, q, y, params, noise_nn, gen, nu, power):
    """One K1 launch of ``design`` (1 registers, 0 shared memory)."""
    from muygpys_torch.gpu import matern_nu as _nu
    from muygpys_torch.gpu.fused_predict import serve_tail_terms

    n, d, B = nf.shape
    r = y.shape[1]
    code = _nu.check_smoothness("k1", nu, gen, power, _nu._LEN_VAL)
    mean = torch.full((r, B), math.nan, dtype=nf.dtype)
    var = torch.full((B,), math.nan, dtype=nf.dtype)
    fn = (lib.fused_predict_coords_f32 if nf.dtype == torch.float32
          else lib.fused_predict_coords_f64)
    fn.argtypes = [P] * 8 + [ctypes.c_int] * 8 + [P]
    rc = fn(*(ptr(t) for t in (nf, q, y, params, noise_nn, gen, mean, var)),
            n, d, r, B, code, power, serve_tail_terms(nf.dtype), design, None)
    assert rc == 0, f"K1 launcher refused: {rc}"
    return mean, var


def k1b_inputs(n, r, B, dtype, nu=1.5, power=1, seed=0, symmetric=True,
               noise=1e-3):
    """K1b inputs ``(pw, cw, y, params, gen)`` on the CPU: distances of
    uniform points (F2 with ``power=2``); ``symmetric=False`` scales the
    upper triangle of ``pw`` by up to 10%, the lower one kept."""
    from muygpys_torch.gpu.matern_nu import matern_nu_coeffs_host

    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64, generator=g)
    pts = torch.rand((n, 2, B), **f64)
    q = torch.rand((2, B), **f64)
    pw = ((pts[:, None] - pts[None]) ** 2).sum(2)
    cw = ((pts - q[None]) ** 2).sum(1)
    if power == 1:
        pw, cw = pw.sqrt(), cw.sqrt()
    if not symmetric:
        upper = torch.triu(torch.ones((n, n), dtype=torch.float64), 1)
        pw = pw * (1.0 + 0.1 * upper[:, :, None] * torch.rand((n, n, B), **f64))
    y = torch.randn((n, r, B), **f64)
    params = torch.tensor([0.6, noise], dtype=dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    gen = (torch.as_tensor(matern_nu_coeffs_host(1.2, np_dtype))
           if nu == "gen" else None)
    return (*(t.to(dtype).contiguous() for t in (pw, cw, y)), params, gen)


def k1b_run(lib, design, pw, cw, y, params, gen, nu, power):
    """One K1b launch of ``design`` (1 registers, 0 shared memory)."""
    from muygpys_torch.gpu import matern_nu as _nu
    from muygpys_torch.gpu.fused_predict import serve_tail_terms

    n, r, B = y.shape
    code = _nu.check_smoothness("k1b", nu, gen, power, _nu._LEN_VAL)
    gen = None if gen is None else gen[:_nu._LEN_VAL].contiguous()
    mean = torch.full((r, B), math.nan, dtype=pw.dtype)
    var = torch.full((B,), math.nan, dtype=pw.dtype)
    fn = (lib.fused_predict_f32 if pw.dtype == torch.float32
          else lib.fused_predict_f64)
    fn.argtypes = [P] * 7 + [ctypes.c_int] * 7 + [P]
    rc = fn(*(ptr(t) for t in (pw, cw, y, params, gen, mean, var)),
            n, r, B, code, power, serve_tail_terms(pw.dtype), design, None)
    assert rc == 0, f"K1b launcher refused: {rc}"
    return mean, var


def coeffs_run(lib, nu, need_dnu, tangent=False):
    """One launch of K4's constructor on a one-element CPU ``nu``: the
    vector and, with ``tangent``, d vector / d nu of its first _LEN_DT
    entries."""
    from muygpys_torch.gpu import matern_nu as _nu

    dtype = nu.dtype
    consts = _nu._kernel_constants(dtype, nu.device)
    assert lib.matern_nu_coeffs_constants_length() == consts.numel()
    out = torch.full((_nu._LEN_DNU if need_dnu else _nu._LEN_DT,), math.nan,
                     dtype=dtype)
    dout = (torch.full((_nu._LEN_DT,), math.nan, dtype=dtype) if tangent
            else None)
    fn = (lib.matern_nu_coeffs_f32 if dtype == torch.float32
          else lib.matern_nu_coeffs_f64)
    fn.argtypes = [P] * 4 + [ctypes.c_int, P]
    rc = fn(ptr(nu), ptr(consts), ptr(out), ptr(dout), int(need_dnu), None)
    assert rc == 0, f"K4 constructor refused: {rc}"
    return out, dout


def digamma_run(lib, x):
    """The constructor's device digamma, elementwise over a CPU tensor."""
    out = torch.full_like(x, math.nan)
    fn = (lib.matern_nu_digamma_f32 if x.dtype == torch.float32
          else lib.matern_nu_digamma_f64)
    fn.argtypes = [P, P, ctypes.c_int, P]
    assert fn(ptr(x), ptr(out), x.numel(), None) == 0
    return out
