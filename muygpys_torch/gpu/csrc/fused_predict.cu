// K1 and K1b: fused posterior solves, hand-written for Hopper.
//
// K1 replaces muygpys_tpu/pallas/fused_predict.py:fused_predict_coords_bl
// (the Pallas kernel _coords_body + _matern + _solve_and_emit); K1b, the
// second __global__ below, replaces fused_predict_bl (_kernel_body) of the
// same file: the same kernel function and elimination fed from distances
// pw (n, n, B), cw (n, B) scaled by 1/ls (l2) or 1/ls^2 (F2).  Per query b
// K1 computes:
//   u_p(i,c) = |(x_i - x_c) / ls|, u_c(i) = |(x_i - q) / ls|   (per-feature ls;
//             F2 metric: the squared sum, no sqrt)
//   K = k(u_p) + nugget I,  kc = k(u_c)          (Matern 1/2, 3/2, 5/2, inf,
//                                                  RBF on the F2 distance, or
//                                                  any nu through K4,
//                                                  matern_nu.cuh, "gen")
//   eliminate the augmented [K | kc | y] in place (one rsqrt per pivot, one
//   fused multiply-subtract over the trailing block; NO pivot floor, exactly
//   as the TPU kernel), giving zc = L^{-1} kc, zy = L^{-1} y
//   mean(r, b) = zc . zy(r),  var(b) = 1 - zc . zc
//
// What bounds it on an H100: at the serving shape (n=30, d=2, r=1, B=8192)
// the kernel moves (n d + d + n r + r + 1) * 4 * B ~ 3.1 MB (~0.9 us at
// 3.35 TB/s) but does ~11k multiply-adds of elimination and ~465 exp per
// query (~180 MFLOP per bucket, ~3 us at the 67 TFLOP/s fp32 rate): it is
// bound by operations and, at this size, by the latency of the n dependent
// pivot steps.
//
// Two designs each of K1 and K1b; the launcher's caller picks
// (muygpys_torch/gpu/fused_predict.py:k1_design): the register design for
// n <= 32 and r <= 4, the shared-memory design otherwise.  The two register
// designs run one elimination, regs_solve_and_emit.
//
// The register design (fused_predict_coords_regs_kernel), K2's pattern: one
// warp per query, up to 8 queries a block.  The block forms the reciprocal
// length scales once, stages the K4 coefficients once under "gen", and
// loads its queries' coordinates (scaled), targets and nuggets
// cooperatively, query index fastest.  Each warp evaluates the lower
// triangle of K once, its n(n+1)/2 pairs spread evenly over the lanes, and
// mirrors every value into a per-warp copy (K is symmetric bit for bit:
// (a - b)^2 = (b - a)^2); lane i then holds row i of K + nugget in 32
// registers (n <= 32 a compile-time bound; identity padding past n) beside
// its entries of [kc | y].  The elimination is right-looking and fully
// unrolled, so every register index is static: at pivot j lane j publishes
// its row through a double-buffered shared row (16-byte stores, broadcast
// reads, one __syncwarp a step); every lane takes rsqrt of the pivot (no
// pivot floor, as the TPU kernel and the plain version) and updates its
// whole row and right-hand sides with independent fused multiply-adds.
// mean = zc . zy and var = 1 - zc . zc are warp sums.
//
// The shared-memory design (fused_predict_coords_kernel): lanes over the
// m = n + 1 + r columns of the augmented matrix, which lives in shared
// memory row-major (lane c owns column c, so a warp's row access hits
// consecutive banks).  Pivot step j reads the pivot, scales row j, stages
// the scaled column below the pivot in a per-warp vector, then each lane
// updates its own column with n-1-j fused multiply-subtracts; only
// __syncwarp separates the steps.  A block holds up to 8 queries (8 warps);
// the block's neighbor coordinates and targets are loaded cooperatively
// with the query index fastest, so each (row, 8 queries) read is one
// contiguous segment of the batch-last inputs.  The Pallas kernel instead
// ran the whole elimination as full-width vector ops over a 512-query lane
// tile in VMEM; on Hopper that tile would not fit the 227 KB of shared
// memory, and warps give the latency hiding.
//
// K1b moves n^2 + n + n r + r + 1 values per query (~3.9 KB at n=30, f32:
// ~9.4 us per 8192 queries at 3.35 TB/s) against the same ~11k multiply-adds:
// it is bound by bytes.  Its register design (fused_predict_regs_kernel)
// is K1's, fed from distances: a block of 8 queries in f32 (4 in f64)
// copies each (row, queries) segment of the batch-last pw as 32
// contiguous bytes, query fastest, by cp.async into a per-query row-major
// copy of K, turns each distance into its kernel value in place; lane i
// then loads row i.  pw is
// the caller's, not symmetric by construction, and the elimination reads
// both triangles (the pivot row from the upper, the column below it from
// the lower), so all n^2 values are evaluated and read.  Its shared-memory
// design (fused_predict_kernel) stages each query's distances straight
// into the augmented matrix (one 32-byte segment per row and 8 queries),
// turns them into kernel values in place and eliminates as K1's
// shared-memory design; shared memory is n(n+1+r) + n per query.
//
// Under "gen" the block stages the coefficient vector once in shared memory
// (matern_nu::stage) and every kernel evaluation is matern_nu::eval on
// t = coef[0] u.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "matern_nu.cuh"

namespace {

enum Smoothness { NU05 = 0, NU15 = 1, NU25 = 2, NUINF = 3, RBF = 4, GEN = 5 };

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// the closed forms of muygpys_tpu/pallas/fused_predict.py:_matern
template <typename T>
__device__ __forceinline__ T kernel_value(T u, int code, const T* co, int nt) {
  switch (code) {
    case GEN: {
      T phi, unused_dt, unused_dnu;
      matern_nu::eval(co[0] * u, co, nt, false, false, phi, unused_dt, unused_dnu);
      return phi;
    }
    case NU05:
      return exp_t(-u);
    case NU15: {
      const T t = u * T(1.7320508075688772);
      return (T(1) + t) * exp_t(-t);
    }
    case NU25: {
      const T t = u * T(2.23606797749979);
      return (T(1) + t + t * t / T(3)) * exp_t(-t);
    }
    case NUINF:
      return exp_t(-(u * u) / T(2));
    default:  // RBF: u is already the F2 distance scaled by 1/ls^2
      return exp_t(-u / T(2));
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// In-place elimination of one warp's augmented [K | kc | y] (n rows of
// m = n + 1 + r columns; lc is an n-vector of scratch), then
// mean = zc . zy, var = 1 - zc . zc: the tail K1 and K1b share.
template <typename T>
__device__ void solve_and_emit(T* work, T* lc, T* __restrict__ mean, T* __restrict__ var,
                               int n, int r, int b, int B, int lane) {
  const int m = n + 1 + r;
  for (int j = 0; j < n; ++j) {
    const T inv = rsqrt_t(work[j * m + j]);
    __syncwarp();  // every lane has read the pivot before row j is scaled
    for (int c = j + lane; c < m; c += 32) work[j * m + c] *= inv;
    for (int i = j + 1 + lane; i < n; i += 32) lc[i] = work[i * m + j] * inv;
    __syncwarp();
    // column j below the pivot is never read again: update columns > j
    for (int c = j + 1 + lane; c < m; c += 32) {
      const T rj = work[j * m + c];
      for (int i = j + 1; i < n; ++i) work[i * m + c] -= lc[i] * rj;
    }
    __syncwarp();
  }

  // mean = zc . zy, var = 1 - zc . zc
  T zz = T(0);
  for (int i = lane; i < n; i += 32) {
    const T zc = work[i * m + n];
    zz += zc * zc;
  }
  zz = warp_sum(zz);
  if (lane == 0) var[b] = T(1) - zz;
  for (int k = 0; k < r; ++k) {
    T s = T(0);
    for (int i = lane; i < n; i += 32) s += work[i * m + n] * work[i * m + n + 1 + k];
    s = warp_sum(s);
    if (lane == 0) mean[(size_t)k * B + b] = s;
  }
}

template <typename T>
__global__ void fused_predict_coords_kernel(
    const T* __restrict__ nf,        // (n, d, B)
    const T* __restrict__ q,         // (d, B)
    const T* __restrict__ y,         // (n, r, B)
    const T* __restrict__ params,    // (d + 1): ls_0..ls_{d-1}, noise
    const T* __restrict__ noise_nn,  // (n, B) or null
    const T* __restrict__ gen,       // K4 coefficients (>= LEN_VAL) or null
    T* __restrict__ mean,            // (r, B)
    T* __restrict__ var,             // (B,)
    int n, int d, int r, int B, int code, int metric_power, int nt) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tq = blockDim.x / 32;  // queries (warps) per block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m = n + 1 + r;
  const int b0 = blockIdx.x * tq;

  T* xs = smem;                   // [tq][n][d] length-scaled coordinates
  T* qs = xs + tq * n * d;        // [tq][d]
  T* works = qs + tq * d;         // [tq][n][m] augmented matrices
  T* lcs = works + tq * n * m;    // [tq][n] staged pivot column / nuggets
  T* co = lcs + tq * n;           // [LEN_VAL] K4 coefficients under gen

  if (code == GEN) matern_nu::stage(co, gen, matern_nu::LEN_VAL, nt);
  // cooperative, query-fastest loads of the block's slice of the inputs
  for (int e = threadIdx.x; e < n * d * tq; e += blockDim.x) {
    const int w = e % tq, row = e / tq, b = b0 + w;  // row = i * d + f
    const T inv = T(1) / params[row % d];
    xs[w * n * d + row] = b < B ? nf[(size_t)row * B + b] * inv : T(0);
  }
  for (int e = threadIdx.x; e < d * tq; e += blockDim.x) {
    const int w = e % tq, f = e / tq, b = b0 + w;
    const T inv = T(1) / params[f];
    qs[w * d + f] = b < B ? q[(size_t)f * B + b] * inv : T(0);
  }
  for (int e = threadIdx.x; e < n * r * tq; e += blockDim.x) {
    const int w = e % tq, row = e / tq, b = b0 + w;  // row = i * r + k
    const int i = row / r, k = row % r;
    works[w * n * m + i * m + n + 1 + k] = b < B ? y[(size_t)row * B + b] : T(0);
  }
  if (noise_nn != nullptr) {
    for (int e = threadIdx.x; e < n * tq; e += blockDim.x) {
      const int w = e % tq, i = e / tq, b = b0 + w;
      lcs[w * n + i] = b < B ? noise_nn[(size_t)i * B + b] : T(0);
    }
  }
  __syncthreads();

  const int b = b0 + warp;
  if (b >= B) return;  // no block-wide barrier below this point
  const T* x = xs + warp * n * d;
  const T* qq = qs + warp * d;
  T* work = works + warp * n * m;
  T* lc = lcs + warp * n;
  const T noise = params[d];

  // K = k(u_p) + nugget I and kc = k(u_c)
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, c = e % n;
    T acc = T(0);
    for (int f = 0; f < d; ++f) {
      const T diff = x[i * d + f] - x[c * d + f];
      acc += diff * diff;
    }
    T k = kernel_value(metric_power == 1 ? sqrt_t(acc) : acc, code, co, nt);
    if (i == c) k += noise_nn != nullptr ? lc[i] : noise;
    work[i * m + c] = k;
  }
  for (int i = lane; i < n; i += 32) {
    T acc = T(0);
    for (int f = 0; f < d; ++f) {
      const T diff = x[i * d + f] - qq[f];
      acc += diff * diff;
    }
    work[i * m + n] = kernel_value(metric_power == 1 ? sqrt_t(acc) : acc, code, co, nt);
  }
  __syncwarp();

  solve_and_emit(work, lc, mean, var, n, r, b, B, lane);
}

// ---- the register design of K1 --------------------------------------------

constexpr int kRows = 32;  // one lane per row
constexpr int kLdK = 33;   // row stride of the mirrored K: odd, so a row and a column hit distinct banks

__device__ __forceinline__ void st16(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void st16(double* d, const double* s) {
  *reinterpret_cast<double2*>(d) = make_double2(s[0], s[1]);
}
__device__ __forceinline__ void ld16(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}
__device__ __forceinline__ void ld16(double* d, const double* s) {
  const double2 v = *reinterpret_cast<const double2*>(s);
  d[0] = v.x, d[1] = v.y;
}

// widths for value type T and R right-hand sides: NC = 1 + R columns
// [kc | y], padded to XP for 16-byte moves; RB is one published row
template <typename T, int R>
struct RegShape {
  static constexpr int VW = 16 / sizeof(T);
  static constexpr int NC = 1 + R;
  static constexpr int XP = (NC + VW - 1) / VW * VW;
  static constexpr int RB = kRows + XP;
};

// blocks of 8 warps an SM the register design asks the compiler for: in f32
// with one right-hand side 4 (a 64-register cap, which measured faster than
// asking for 2 at the serving headline: chip_variants.py), else 2 in f32, 1
// in f64
template <typename T, int R>
struct RegsMinBlocks {
  static constexpr int value = sizeof(T) == 4 ? (R == 1 ? 4 : 2) : 1;
};

// The register design's elimination and emit, shared by K1 and K1b: lane i
// holds row i of K + nugget in A (identity rows past n) and its entries of
// [kc | y] in x.  Right-looking and fully unrolled, so every register index
// is static: at pivot j lane j publishes its row through the warp's
// double-buffered shared row `rows` (2 RB elements, 16-byte aligned; one
// __syncwarp a step); every lane takes rsqrt of the pivot (no pivot floor)
// and updates its row and right-hand sides.  Column j of the rows below the
// pivot is read from their own registers and row j from the published
// copy, so both triangles of K are read, as the plain version reads them.
// mean = zc . zy and var = 1 - zc . zc are warp sums.
template <typename T, int R>
__device__ __forceinline__ void regs_solve_and_emit(T (&A)[kRows], T (&x)[RegShape<T, R>::XP],
                                                    T* rows, T* __restrict__ mean,
                                                    T* __restrict__ var, int n, int r, int b,
                                                    int B, int lane) {
  using Shape = RegShape<T, R>;
  constexpr int VW = Shape::VW, NC = Shape::NC, XP = Shape::XP, RB = Shape::RB;
  // right-looking elimination of [K | kc | y], one rsqrt per pivot
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j < n) {
      T* buf = rows + (j & 1) * RB;  // double-buffered: one barrier a step
      if (lane == j) {
#pragma unroll
        for (int c0 = j / VW * VW; c0 < kRows; c0 += VW) st16(buf + c0, A + c0);
#pragma unroll
        for (int k0 = 0; k0 < XP; k0 += VW) st16(buf + kRows + k0, x + k0);
      }
      __syncwarp();
      const T pinv = rsqrt_t(buf[j]);
      const bool below = lane > j;
      const T l = below ? A[j] * pinv : T(0);
      T z[XP];
#pragma unroll
      for (int k0 = 0; k0 < XP; k0 += VW) ld16(z + k0, buf + kRows + k0);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const T zj = z[k] * pinv;
        x[k] = below ? x[k] - l * zj : (lane == j ? zj : x[k]);
      }
#pragma unroll
      for (int c0 = (j + 1) / VW * VW; c0 < kRows; c0 += VW) {
        T rr[VW];
        ld16(rr, buf + c0);
#pragma unroll
        for (int e = 0; e < VW; ++e)
          if (c0 + e > j) A[c0 + e] -= l * (rr[e] * pinv);
      }
    }
  }

  // lanes past n hold zeros
  const T zz = warp_sum(x[0] * x[0]);
  if (lane == 0) var[b] = T(1) - zz;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < r) {
      const T s = warp_sum(x[0] * x[1 + k]);
      if (lane == 0) mean[(size_t)k * B + b] = s;
    }
}


// shared-memory elements of one query: two published rows, the mirrored K
// (row c of the copy, stride kLdK, is column c of K), the scaled coordinates, the scaled
// query, the targets and the nuggets; a multiple of 4 so every query stays
// 16-byte aligned
__host__ __device__ __forceinline__ size_t coords_regs_elems(int n, int d, int R, int rb) {
  const size_t e = (size_t)2 * rb + (size_t)n * kLdK + (size_t)n * d + d + (size_t)n * R + n;
  return (e + 3) / 4 * 4;
}

template <typename T, int R>
__global__ void __launch_bounds__(256, RegsMinBlocks<T, R>::value) fused_predict_coords_regs_kernel(
    const T* __restrict__ nf,        // (n, d, B)
    const T* __restrict__ q,         // (d, B)
    const T* __restrict__ y,         // (n, r, B)
    const T* __restrict__ params,    // (d + 1): ls_0..ls_{d-1}, noise
    const T* __restrict__ noise_nn,  // (n, B) or null
    const T* __restrict__ gen,       // K4 coefficients (>= LEN_VAL) or null
    T* __restrict__ mean,            // (r, B)
    T* __restrict__ var,             // (B,)
    int n, int d, int r, int B, int code, int metric_power, int nt) {
  using Shape = RegShape<T, R>;
  constexpr int XP = Shape::XP, RB = Shape::RB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = blockDim.x / 32;  // queries (warps) per block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * P;
  const size_t per = coords_regs_elems(n, d, R, RB);
  // per-query carve-up (offsets in elements)
  const size_t oK = 2 * RB, oX = oK + (size_t)n * kLdK, oQ = oX + (size_t)n * d,
               oY = oQ + d, oN = oY + (size_t)n * R;

  T* base = reinterpret_cast<T*>(smem_raw);
  T* inv = base + P * per;  // [d] reciprocal length scales
  T* co = inv + d;          // [LEN_VAL] K4 coefficients under gen
  if (code == GEN) matern_nu::stage(co, gen, matern_nu::LEN_VAL, nt);
  for (int f = threadIdx.x; f < d; f += blockDim.x) inv[f] = T(1) / params[f];
  __syncthreads();
  // cooperative, query-fastest loads of the block's slice of the inputs
  for (int e = threadIdx.x; e < n * d * P; e += blockDim.x) {
    const int w = e % P, row = e / P, b = b0 + w;  // row = i * d + f
    base[w * per + oX + row] = b < B ? nf[(size_t)row * B + b] * inv[row % d] : T(0);
  }
  for (int e = threadIdx.x; e < d * P; e += blockDim.x) {
    const int w = e % P, f = e / P, b = b0 + w;
    base[w * per + oQ + f] = b < B ? q[(size_t)f * B + b] * inv[f] : T(0);
  }
  for (int e = threadIdx.x; e < n * r * P; e += blockDim.x) {
    const int w = e % P, row = e / P, b = b0 + w;  // row = i * r + k
    base[w * per + oY + row] = b < B ? y[(size_t)row * B + b] : T(0);
  }
  if (noise_nn != nullptr) {
    for (int e = threadIdx.x; e < n * P; e += blockDim.x) {
      const int w = e % P, i = e / P, b = b0 + w;
      base[w * per + oN + i] = b < B ? noise_nn[(size_t)i * B + b] : T(0);
    }
  }
  __syncthreads();

  const int b = b0 + warp;
  if (b >= B) return;  // no block-wide barrier below this point
  T* sm = base + warp * per;
  T* rows = sm;
  T* Ks = sm + oK;
  const T* xs = sm + oX;
  const T* qs = sm + oQ;
  const T noise = params[d];
  auto nugget = [&](int i) { return noise_nn != nullptr ? sm[oN + i] : noise; };
  auto value = [&](const T* xa, const T* xb) {
    T acc = T(0);
    for (int f = 0; f < d; ++f) {
      const T diff = xa[f] - xb[f];
      acc += diff * diff;
    }
    return kernel_value(metric_power == 1 ? sqrt_t(acc) : acc, code, co, nt);
  };

  // the lower triangle of K + nugget I, pair p = i (i + 1) / 2 + j (j <= i)
  // on lane p % 32, mirrored: Ks[c * kLdK + i] = K(i, c)
  {
    int i = 0, j = lane;
    while (j > i) j -= ++i;
    while (i < n) {
      T v = value(xs + i * d, xs + j * d);
      if (i == j) v += nugget(i);
      Ks[j * kLdK + i] = v;
      Ks[i * kLdK + j] = v;
      j += 32;
      while (j > i) j -= ++i;
    }
  }
  const bool live = lane < n;
  T x[XP];
#pragma unroll
  for (int k = 0; k < XP; ++k) x[k] = T(0);
  if (live) {
    x[0] = value(xs + lane * d, qs);  // kc
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < r) x[1 + k] = sm[oY + lane * r + k];
  }
  __syncwarp();
  T A[kRows];
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    T v = c == lane ? T(1) : T(0);
    if (c < n && live) v = Ks[c * kLdK + lane];
    A[c] = v;
  }

  regs_solve_and_emit<T, R>(A, x, rows, mean, var, n, r, b, B, lane);
}

// ---- the register design of K1b -------------------------------------------

// bytes of one (row, queries) segment of K1b's batch-last inputs a block
// copies: 32, so 8 queries a block in f32 and 4 in f64 (measured faster
// than 64 bytes, 16 and 8 queries, at the headline: chip_variants.py)
constexpr int kDistsSegmentBytes = 32;

template <typename T, int R>
struct DistsRegsBounds {
  static constexpr int queries = kDistsSegmentBytes / (int)sizeof(T);
  static constexpr int threads = 32 * queries;
  // a 64-register cap in f32 with one right-hand side, 128 with more; f64
  // uncapped
  static constexpr int min_blocks = sizeof(T) == 4 && R == 1 ? 65536 / 64 / threads : 1;
};

// shared-memory elements of one query of K1b's register design: K + noise I
// row-major (row stride kLdK), kc, then y (R a row); padded so that the
// block's queries, stored query-fastest, fall on distinct banks (an odd
// number of 8-byte words apart in f32, of 8-byte elements in f64)
__host__ __device__ __forceinline__ size_t dists_regs_elems(int n, int R, int elem_bytes) {
  const size_t e = (size_t)n * kLdK + n + (size_t)n * R;
  const size_t period = elem_bytes == 4 ? 32 : 16, want = elem_bytes == 4 ? 2 : 1;
  return e + (want + period - e % period) % period;
}

// K1b in registers: one warp per query, lane i on row i, K1's elimination
// (regs_solve_and_emit).  The block's inputs are staged by asynchronous
// copies (cp.async), query fastest, so each (row, queries) segment is one
// contiguous read: a thread owns query tid % P and every 32nd row from
// tid / P, and has all its copies in flight at once (a register load each
// would leave one in flight a thread, a quarter of what the memory rate
// needs).  Each thread then turns the distances it copied into kernel
// values in place.  pw arrives from the caller, so nothing makes it
// symmetric bit for bit: all n^2 values are evaluated, as the plain version
// does, into each query's row-major K, and lane i loads its row of the
// whole square.
template <typename T, int R>
__global__ void __launch_bounds__(DistsRegsBounds<T, R>::threads, DistsRegsBounds<T, R>::min_blocks)
    fused_predict_regs_kernel(const T* __restrict__ pw,      // (n, n, B)
                              const T* __restrict__ cw,      // (n, B)
                              const T* __restrict__ y,       // (n, r, B)
                              const T* __restrict__ params,  // (2): ls, noise
                              const T* __restrict__ gen,     // K4 coefficients or null
                              T* __restrict__ mean,          // (r, B)
                              T* __restrict__ var,           // (B,)
                              int n, int r, int B, int code, int metric_power, int nt) {
  using Shape = RegShape<T, R>;
  constexpr int XP = Shape::XP, RB = Shape::RB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = blockDim.x / 32;  // queries (warps) per block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * P;
  const size_t per = dists_regs_elems(n, R, sizeof(T));
  const size_t oC = (size_t)n * kLdK, oY = oC + n;  // per-query offsets

  T* rows = reinterpret_cast<T*>(smem_raw);  // [P][2 RB] published rows
  T* base = rows + (size_t)P * 2 * RB;        // [P][per] the queries
  T* co = base + P * per;                     // [LEN_VAL] K4 coefficients under gen

  // the copies of this thread's query: rows tid / P, + 32, ... (blockDim is
  // 32 P) of pw, cw and y
  const int w = threadIdx.x % P, b = b0 + w, first = threadIdx.x / P;
  T* q = base + w * per;
  if (b < B) {
    for (int row = first, i = first / n, c = first % n; row < n * n; row += 32) {
      __pipeline_memcpy_async(q + i * kLdK + c, pw + (size_t)row * B + b, sizeof(T));
      for (c += 32; c >= n; c -= n) ++i;
    }
    for (int i = first; i < n; i += 32)
      __pipeline_memcpy_async(q + oC + i, cw + (size_t)i * B + b, sizeof(T));
    for (int row = first; row < n * r; row += 32)
      __pipeline_memcpy_async(q + oY + row, y + (size_t)row * B + b, sizeof(T));
  }
  __pipeline_commit();
  if (code == GEN) matern_nu::stage(co, gen, matern_nu::LEN_VAL, nt);
  __syncthreads();  // the staged coefficients
  __pipeline_wait_prior(0);
  if (b < B) {
    const T ls = params[0], noise = params[1];
    const T inv = metric_power == 1 ? T(1) / ls : T(1) / (ls * ls);
    for (int row = first, i = first / n, c = first % n; row < n * n; row += 32) {
      T* e = q + i * kLdK + c;
      T v = kernel_value(*e * inv, code, co, nt);
      if (i == c) v += noise;
      *e = v;
      for (c += 32; c >= n; c -= n) ++i;
    }
    for (int i = first; i < n; i += 32) q[oC + i] = kernel_value(q[oC + i] * inv, code, co, nt);
  }
  __syncthreads();

  if (b0 + warp >= B) return;  // no block-wide barrier below this point
  const T* sm = base + warp * per;
  const bool live = lane < n;
  T x[XP];
#pragma unroll
  for (int k = 0; k < XP; ++k) x[k] = T(0);
  if (live) {
    x[0] = sm[oC + lane];
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < r) x[1 + k] = sm[oY + lane * r + k];
  }
  T A[kRows];
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    T v = c == lane ? T(1) : T(0);
    if (c < n && live) v = sm[lane * kLdK + c];
    A[c] = v;
  }
  regs_solve_and_emit<T, R>(A, x, rows + warp * 2 * RB, mean, var, n, r, b0 + warp, B, lane);
}

// K1b: the same posterior from distances.  pw (n, n, B) and cw (n, B) are
// scaled by 1/ls (l2) or 1/ls^2 (F2); params = [ls, noise].
template <typename T>
__global__ void fused_predict_kernel(
    const T* __restrict__ pw,      // (n, n, B)
    const T* __restrict__ cw,      // (n, B)
    const T* __restrict__ y,       // (n, r, B)
    const T* __restrict__ params,  // (2): ls, noise
    const T* __restrict__ gen,     // K4 coefficients (>= LEN_VAL) or null
    T* __restrict__ mean,          // (r, B)
    T* __restrict__ var,           // (B,)
    int n, int r, int B, int code, int metric_power, int nt) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tq = blockDim.x / 32;  // queries (warps) per block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m = n + 1 + r;
  const int b0 = blockIdx.x * tq;

  T* works = smem;              // [tq][n][m] distances, then augmented matrices
  T* lcs = works + tq * n * m;  // [tq][n] staged pivot column
  T* co = lcs + tq * n;         // [LEN_VAL] K4 coefficients under gen

  if (code == GEN) matern_nu::stage(co, gen, matern_nu::LEN_VAL, nt);
  // cooperative, query-fastest loads: row = i * n + c of pw, i of cw,
  // i * r + k of y, each straight into its place in the augmented matrix
  for (int e = threadIdx.x; e < n * n * tq; e += blockDim.x) {
    const int w = e % tq, row = e / tq, b = b0 + w;
    works[w * n * m + (row / n) * m + row % n] = b < B ? pw[(size_t)row * B + b] : T(0);
  }
  for (int e = threadIdx.x; e < n * tq; e += blockDim.x) {
    const int w = e % tq, i = e / tq, b = b0 + w;
    works[w * n * m + i * m + n] = b < B ? cw[(size_t)i * B + b] : T(0);
  }
  for (int e = threadIdx.x; e < n * r * tq; e += blockDim.x) {
    const int w = e % tq, row = e / tq, b = b0 + w;
    works[w * n * m + (row / r) * m + n + 1 + row % r] = b < B ? y[(size_t)row * B + b] : T(0);
  }
  __syncthreads();

  const int b = b0 + warp;
  if (b >= B) return;  // no block-wide barrier below this point
  T* work = works + warp * n * m;
  const T ls = params[0], noise = params[1];
  const T inv = metric_power == 1 ? T(1) / ls : T(1) / (ls * ls);

  // K = k(pw / ls) + noise I and kc = k(cw / ls), in place
  for (int e = lane; e < n * (n + 1); e += 32) {
    const int i = e / (n + 1), c = e % (n + 1);
    T k = kernel_value(work[i * m + c] * inv, code, co, nt);
    if (i == c) k += noise;
    work[i * m + c] = k;
  }
  __syncwarp();

  solve_and_emit(work, lcs + warp * n, mean, var, n, r, b, B, lane);
}

constexpr size_t kMaxSmem = 232448;  // 227 KB a block can opt into on sm_90

// Queries per block: 8, halved until `per_query` elements each plus `fixed`
// elements for the block fit the shared memory a block can opt into; 0 when
// one query does not fit.
template <typename T>
int queries_per_block(size_t per_query, size_t fixed, size_t* bytes) {
  for (int tq = 8; tq >= 1; tq /= 2) {
    *bytes = sizeof(T) * (tq * per_query + fixed);
    if (*bytes <= kMaxSmem) return tq;
  }
  return 0;
}

template <typename T, int R>
int launch_coords_regs(const T* nf, const T* q, const T* y, const T* params, const T* noise_nn,
                       const T* gen, T* mean, T* var, int n, int d, int r, int B, int code,
                       int metric_power, int nt, void* stream) {
  size_t bytes = 0;
  const int tq = queries_per_block<T>(coords_regs_elems(n, d, R, RegShape<T, R>::RB),
                                      (size_t)d + (code == GEN ? matern_nu::LEN_VAL : 0),
                                      &bytes);
  if (tq < 1) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fused_predict_coords_regs_kernel<T, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + tq - 1) / tq;
  fused_predict_coords_regs_kernel<T, R><<<grid, 32 * tq, bytes, (cudaStream_t)stream>>>(
      nf, q, y, params, noise_nn, gen, mean, var, n, d, r, B, code, metric_power, nt);
  return (int)cudaGetLastError();
}

// design 1: the register design (n <= 32, r <= 4; R = 1, 2 or 4 right-hand
// sides compiled); design 0: the shared-memory design
template <typename T>
int launch_coords(const T* nf, const T* q, const T* y, const T* params, const T* noise_nn,
                  const T* gen, T* mean, T* var, int n, int d, int r, int B, int code,
                  int metric_power, int nt, int design, void* stream) {
  if (B == 0) return 0;
  if (design == 1) {
    if (n < 1 || n > kRows || r < 1 || r > 4 || d < 1) return (int)cudaErrorInvalidValue;
    auto go = r == 1   ? launch_coords_regs<T, 1>
              : r == 2 ? launch_coords_regs<T, 2>
                       : launch_coords_regs<T, 4>;
    return go(nf, q, y, params, noise_nn, gen, mean, var, n, d, r, B, code, metric_power, nt,
              stream);
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  const int m = n + 1 + r;
  size_t bytes = 0;
  const int tq = queries_per_block<T>((size_t)n * d + d + (size_t)n * m + n,
                                      code == GEN ? matern_nu::LEN_VAL : 0, &bytes);
  if (tq < 1) return (int)cudaErrorInvalidValue;  // one query's matrix does not fit
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_predict_coords_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + tq - 1) / tq;
  fused_predict_coords_kernel<T><<<grid, 32 * tq, bytes, (cudaStream_t)stream>>>(
      nf, q, y, params, noise_nn, gen, mean, var, n, d, r, B, code, metric_power, nt);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_dists_regs(const T* pw, const T* cw, const T* y, const T* params, const T* gen,
                      T* mean, T* var, int n, int r, int B, int code, int metric_power, int nt,
                      void* stream) {
  constexpr int P = DistsRegsBounds<T, R>::queries;
  const size_t bytes =
      sizeof(T) * (P * (2 * RegShape<T, R>::RB + dists_regs_elems(n, R, sizeof(T))) +
                   (code == GEN ? matern_nu::LEN_VAL : 0));
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fused_predict_regs_kernel<T, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + P - 1) / P;
  fused_predict_regs_kernel<T, R><<<grid, 32 * P, bytes, (cudaStream_t)stream>>>(
      pw, cw, y, params, gen, mean, var, n, r, B, code, metric_power, nt);
  return (int)cudaGetLastError();
}

// design 1: the register design (n <= 32, r <= 4); design 0: the
// shared-memory design
template <typename T>
int launch_dists(const T* pw, const T* cw, const T* y, const T* params, const T* gen,
                 T* mean, T* var, int n, int r, int B, int code, int metric_power, int nt,
                 int design, void* stream) {
  if (B == 0) return 0;
  if (design == 1) {
    if (n < 1 || n > kRows || r < 1 || r > 4) return (int)cudaErrorInvalidValue;
    auto go = r == 1   ? launch_dists_regs<T, 1>
              : r == 2 ? launch_dists_regs<T, 2>
                       : launch_dists_regs<T, 4>;
    return go(pw, cw, y, params, gen, mean, var, n, r, B, code, metric_power, nt, stream);
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  const int m = n + 1 + r;
  size_t bytes = 0;
  const int tq = queries_per_block<T>((size_t)n * m + n,
                                      code == GEN ? matern_nu::LEN_VAL : 0, &bytes);
  if (tq < 1) return (int)cudaErrorInvalidValue;  // one query's matrix does not fit
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_predict_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + tq - 1) / tq;
  fused_predict_kernel<T><<<grid, 32 * tq, bytes, (cudaStream_t)stream>>>(
      pw, cw, y, params, gen, mean, var, n, r, B, code, metric_power, nt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_predict_coords_f32(const float* nf, const float* q, const float* y,
                             const float* params, const float* noise_nn, const float* gen,
                             float* mean, float* var, int n, int d, int r, int B, int code,
                             int metric_power, int nt, int design, void* stream) {
  return launch_coords<float>(nf, q, y, params, noise_nn, gen, mean, var, n, d, r, B, code,
                              metric_power, nt, design, stream);
}

int fused_predict_coords_f64(const double* nf, const double* q, const double* y,
                             const double* params, const double* noise_nn,
                             const double* gen, double* mean, double* var, int n, int d,
                             int r, int B, int code, int metric_power, int nt, int design,
                             void* stream) {
  return launch_coords<double>(nf, q, y, params, noise_nn, gen, mean, var, n, d, r, B, code,
                               metric_power, nt, design, stream);
}

int fused_predict_f32(const float* pw, const float* cw, const float* y, const float* params,
                      const float* gen, float* mean, float* var, int n, int r, int B,
                      int code, int metric_power, int nt, int design, void* stream) {
  return launch_dists<float>(pw, cw, y, params, gen, mean, var, n, r, B, code, metric_power,
                             nt, design, stream);
}

int fused_predict_f64(const double* pw, const double* cw, const double* y,
                      const double* params, const double* gen, double* mean, double* var,
                      int n, int r, int B, int code, int metric_power, int nt, int design,
                      void* stream) {
  return launch_dists<double>(pw, cw, y, params, gen, mean, var, n, r, B, code,
                              metric_power, nt, design, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
