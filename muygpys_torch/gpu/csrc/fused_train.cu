// K2: fused leave-one-out statistics and their analytic derivatives,
// hand-written for Hopper.
//
// Replaces muygpys_tpu/pallas/fused_train.py:fused_train_stats_bl (the
// Pallas kernel _train_body with _kernel_and_deriv, _chol_bl, _fwd_bl,
// _bwd_bl and _matvec_bl).  Per batch point b, from the distances pw (n, n)
// and cw (n) (isotropic) or the per-feature differences pw (n, n, d) and
// cw (n, d) (anisotropic), with params = [ls_0..ls_{G-1}, noise, noise0]:
//   u = scaled distance; K = k(u) and H = u dk/du elementwise (Matern 1/2,
//   3/2, 5/2, inf, RBF on the F2 distance, or any nu through K4,
//   matern_nu.cuh, "gen": t = coef[0] u, H = t dphi/dt); G_g = dK/d ls_g =
//   (-c / ls_g) H (w_g / sum_f w_f under anisotropy, w_f = (diff_f/ls_f)^2);
//   under a free nu also S = dK/dnu = dphi/dnu|_t + coef[4] H
//   L = chol(K + nugget) with the relative Gill-Murray floor: a pivot below
//   10 eps mean(diag) is floored and the column under it zeroed
//   z = L^{-1} [kc | y], [a | b] = L^{-T} z
//   mean = zc.zy, var = 1 - zc.zc, q = zy.zy; when noise_free, a second
//   factor L0 = chol(K + noise0 I) gives b0 and q (the reference's
//   stored-noise sigma^2 quirk)
//   per group g: dmean = gc.b - (G a).b, dvar = -2 gc.a + (G a).a,
//   dq = -sum_k (G b0_k).b0_k; noise: dmean = -a.b, dvar = a.a; a free nu:
//   the group's three contractions once more with S in place of G
// and writes the rows of out (C, B), C = (r+2) + G(r+2) + (r+1) [+ (r+2)],
// in the TPU kernel's order.
//
// What bounds it on an H100 (chip_smoke.py's count): at the training
// headline (n=30, isotropic, r=1, B=2048, f32, noise free) the kernel must
// read the symmetric pw by its n(n+1)/2 rows, cw, y and write its C rows:
// 4.37 MB, 0.0013 ms at 3.35 TB/s; its operations (two n^3/3
// factorizations, four substitutions, two n x n contractions, n(n+1)/2 + n
// kernel evaluations) come to ~0.0011 ms at 67 TFLOP/s: bytes, narrowly.
// What limits a warp-per-point design is the latency of the dependent chain
// of each factorization: 2048 points are one partial wave of ~16 warps per
// SM, four per scheduler, too few to hide a shared-memory round trip per
// multiply-add.
//
// Two designs; the launcher takes the register design whenever n <= 32 and
// r <= 4, the shared-memory design otherwise (fused_train.py:train_design
// states the same rule, and its byte counts).
//
// The register design (fused_train_stats_regs_kernel), one warp per point:
// lane i holds row i of K + nugget in 32 registers (n <= 32 a compile-time
// bound; rows and columns past n are identity padding), beside its entries
// of [kc | y].  The factorization is right-looking and fully unrolled, so
// every register index is static: at pivot j lane j publishes its raw row
// through a double-buffered shared-memory row (16-byte stores and broadcast
// reads, one __syncwarp a step); every lane takes sqrt and ONE division for
// the pivot (the same pivots fall under the floor as in the plain version)
// and updates its whole row with independent fused multiply-adds.  The
// updates keep the trailing block bitwise symmetric (K is built from the
// lower triangle of pw, and fma(a, b, c) = fma(b, a, c)), so after step j
// lane j's own row right of the pivot, times 1/d_j, IS column j of L: the
// backward substitution needs no transpose, only one shuffle per step and
// column.  Eliminating [kc | y] with the matrix is the forward
// substitution.  The stored-noise factorization reloads K from a per-warp
// shared copy written once by the evaluation pass.  The contractions are
// bilinear forms: lane i re-evaluates row i of each G field (and S under a
// free nu) from the staged distances and accumulates (G a)_i and (G b0_k)_i
// against broadcast vectors; one warp sum closes each row.  The n x n G and
// S fields are never stored.
//
// The shared-memory design (fused_train_stats_kernel), kept for n > 32 or
// r > 4: one warp per batch point, up to 8 points per block (halved until
// the block's shared memory fits the 227 KB a block can opt into, with
// cudaFuncSetAttribute above 48 KB).  The block loads its points' slices of
// the batch-last inputs cooperatively, point index fastest, and forms the
// length-scale coefficients (1/ls, -c/ls) once.  Per point, shared memory
// holds:
//   D  (G, n, ld): the distance slab, overwritten in place by the G_g
//      fields once K and H are formed (the matvecs read G, nothing is
//      recomputed);
//   M  (n, ld):    L in the lower triangle; K(i, j) for i > j kept in the
//      strict upper triangle at M[j][i] and the raw diagonal in kd, so the
//      second (stored-noise) factorization runs in the SAME buffer after
//      the first one's solves are done;
//   vectors: kd, nugget, a column scratch, gc (G, n), s (1+r, n) for
//      [kc | y] -> z -> [a | b], s0 (r, n) for y -> z0 -> b0;
//   under a free nu a further field S (n, ld) and vector sc (n): K4 is
//      evaluated ONCE per element, with its d/dnu output kept beside the G
//      fields until the contractions, rather than a second time after the
//      solves.  The launcher's rule counts these bytes.
// Under "gen" the block stages the coefficient vector once in shared memory
// (matern_nu::stage), which also re-derives the d/ds Chebyshev coefficients
// of a truncated tail.
// The row stride ld = n | 1 is odd, so a warp's column accesses (lane =
// row) hit distinct banks.  The factorization is left-looking, column by
// column across lanes (lane = row, a pivot broadcast through shared
// memory); the substitutions are column sweeps (one broadcast and one
// multiply-subtract per lane and step); dot products are warp shuffles.
// The Pallas kernel instead ran whole-tile vector ops over 256 batch lanes
// in VMEM, which does not fit shared memory here.

#include <cfloat>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "matern_nu.cuh"

namespace {

enum Smoothness { NU05 = 0, NU15 = 1, NU25 = 2, NUINF = 3, RBF = 4, GEN = 5 };

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
// IEEE square root and reciprocal without the generic division's slow
// path: the same correctly rounded results as sqrt and 1 / d
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

// K(u), H(u) = u dK/du and, under a free nu, S(u) = dK/dnu at fixed u, as
// muygpys_tpu/pallas/fused_train.py:_kernel_and_deriv
template <typename T>
__device__ __forceinline__ void kernel_and_deriv(T u, int code, const T* co, int nt,
                                                 bool nu_free, T& k, T& h, T& s) {
  s = T(0);
  switch (code) {
    case GEN: {
      const T t = co[0] * u;
      T dphi_dt, dnu_part;
      matern_nu::eval(t, co, nt, true, nu_free, k, dphi_dt, dnu_part);
      h = t * dphi_dt;
      s = dnu_part + co[4] * h;  // the chain term dt/dnu = t / (2 nu)
      break;
    }
    case NU05: {
      const T e = exp_t(-u);
      k = e;
      h = -u * e;
      break;
    }
    case NU15: {
      const T e = exp_t(-u * T(1.7320508075688772));
      k = (T(1) + T(1.7320508075688772) * u) * e;
      h = T(-3) * u * u * e;
      break;
    }
    case NU25: {
      const T e = exp_t(-u * T(2.23606797749979));
      const T t = T(2.23606797749979) * u;
      k = (T(1) + t + t * t / T(3)) * e;
      h = -(T(5) / T(3)) * u * u * (T(1) + t) * e;
      break;
    }
    case NUINF: {
      const T e = exp_t(-(u * u) / T(2));
      k = e;
      h = -u * u * e;
      break;
    }
    default: {  // RBF: u is the F2 distance scaled by 1/ls^2
      const T e = exp_t(-u / T(2));
      k = e;
      h = T(-0.5) * u * e;
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// From the raw distance (isotropic, dd = 1) or the per-feature differences
// x[f * stride] (anisotropic) of one pair: the kernel value, with each G_g
// written back over x[g * stride].  inv[g] scales the distance (1/ls, or
// 1/ls^2 for an isotropic F2 distance) and gco[g] = -c / ls_g.  Under a free
// nu, dK/dnu goes to *s_out.
template <typename T>
__device__ __forceinline__ T assemble(T* x, int stride, bool aniso, int dd,
                                      const T* inv, const T* gco, int code,
                                      int metric_power, const T* co, int nt,
                                      T* s_out) {
  T u, acc = T(0);
  if (!aniso) {
    u = x[0] * inv[0];
  } else {
    for (int f = 0; f < dd; ++f) {
      const T df = x[f * stride] * inv[f];
      acc += df * df;
    }
    u = metric_power == 1 ? sqrt_t(acc) : acc;
  }
  T k, h, s;
  kernel_and_deriv(u, code, co, nt, s_out != nullptr, k, h, s);
  if (s_out != nullptr) *s_out = s;
  if (!aniso) {
    x[0] = gco[0] * h;
  } else {
    const T fa = acc > Lim<T>::tiny() ? acc : Lim<T>::tiny();
    for (int f = 0; f < dd; ++f) {
      const T df = x[f * stride] * inv[f];
      x[f * stride] = gco[f] * h * ((df * df) / fa);
    }
  }
  return k;
}

// Left-looking Cholesky of K + diag(nugget) into the lower triangle of M,
// with the relative Gill-Murray floor of _chol_bl.  K(i, j), i > j, is read
// from M[j * ld + i]; its diagonal from kd.  nug null means the scalar nug0.
template <typename T>
__device__ void cholesky(T* M, const T* kd, const T* nug, T nug0, T* col, int n,
                         int ld, int lane) {
  T part = T(0);
  for (int i = lane; i < n; i += 32) part += kd[i] + (nug ? nug[i] : nug0);
  const T diag_scale = warp_sum(part) / T(n);
  const T pfloor = T(10) * Lim<T>::eps() *
                  (diag_scale > Lim<T>::tiny() ? diag_scale : Lim<T>::tiny());
  for (int j = 0; j < n; ++j) {
    const T* Lj = M + j * ld;
    for (int i = j + lane; i < n; i += 32) {
      T c = i == j ? kd[j] + (nug ? nug[j] : nug0) : M[j * ld + i];
      const T* Li = M + i * ld;
      for (int k = 0; k < j; ++k) c -= Li[k] * Lj[k];
      col[i] = c;
    }
    __syncwarp();
    const T cj = col[j];
    const bool bad = cj < pfloor;
    const T d = sqrt_t(cj > pfloor ? cj : pfloor);
    for (int i = j + lane; i < n; i += 32)
      M[i * ld + j] = i == j ? d : (bad ? T(0) : col[i] / d);
    __syncwarp();
  }
}

// L z = s in place for the m columns of s (column c at s + c * n)
template <typename T>
__device__ void forward(const T* M, T* s, int m, int n, int ld, int lane) {
  for (int j = 0; j < n; ++j) {
    const T ljj = M[j * ld + j];
    for (int c = 0; c < m; ++c) {
      const T zj = s[c * n + j] / ljj;
      for (int i = j + 1 + lane; i < n; i += 32) s[c * n + i] -= M[i * ld + j] * zj;
    }
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32)
    for (int c = 0; c < m; ++c) s[c * n + i] /= M[i * ld + i];
  __syncwarp();
}

// L^T x = s in place for the m columns of s
template <typename T>
__device__ void backward(const T* M, T* s, int m, int n, int ld, int lane) {
  for (int j = n - 1; j >= 0; --j) {
    const T ljj = M[j * ld + j];
    for (int c = 0; c < m; ++c) {
      const T xj = s[c * n + j] / ljj;
      for (int i = lane; i < j; i += 32) s[c * n + i] -= M[j * ld + i] * xj;
    }
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32)
    for (int c = 0; c < m; ++c) s[c * n + i] /= M[i * ld + i];
  __syncwarp();
}

// (G x)_j = sum_i G[i][j] x_i, the contraction order of _matvec_bl
template <typename T>
__device__ __forceinline__ T matvec_row(const T* G, const T* x, int n, int ld, int j) {
  T w = T(0);
  for (int i = 0; i < n; ++i) w += G[i * ld + j] * x[i];
  return w;
}

// shared-memory elements of one point: D, M, kd, nugget, column, gc, s, s0
// and, under a free nu (nu_free = 1), S and sc
__host__ __device__ __forceinline__ size_t point_elems(int n, int dd, int r, int nu_free) {
  const int ld = n | 1;
  return (size_t)n * ld * (dd + 1 + nu_free) +
         (size_t)n * (3 + dd + 1 + 2 * r + nu_free);
}

template <typename T>
__global__ void fused_train_stats_kernel(
    const T* __restrict__ pw,        // (n, n, B) or (n, n, d, B)
    const T* __restrict__ cw,        // (n, B) or (n, d, B)
    const T* __restrict__ y,         // (n, r, B)
    const T* __restrict__ params,    // (dd + 2): ls..., noise, noise0
    const T* __restrict__ noise_nn,  // (n, B) or null
    const T* __restrict__ gen,       // K4 coefficients (ncoef) or null
    T* __restrict__ out,             // (C, B)
    int n, int d_feat, int r, int B, int code, int metric_power, int noise_free,
    int nu_free, int ncoef, int nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = blockDim.x / 32;  // points (warps) per block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool aniso = d_feat > 0;
  const int dd = aniso ? d_feat : 1;  // length-scale groups
  const int ld = n | 1;
  const int b0 = blockIdx.x * P;
  const size_t per_point = point_elems(n, dd, r, nu_free);

  auto base = [&](int w) { return reinterpret_cast<T*>(smem_raw) + w * per_point; };
  // the block's length-scale coefficients, after its P points
  T* inv = base(P);
  T* gco = inv + dd;
  T* co = gco + dd;  // [ncoef] K4 coefficients under gen
  if (code == GEN) matern_nu::stage(co, gen, ncoef, nt);
  if (threadIdx.x < dd) {
    const int f = threadIdx.x;
    const T ls = params[f];
    inv[f] = !aniso && metric_power == 2 ? T(1) / (ls * ls) : T(1) / ls;
    gco[f] = T(-metric_power) / ls;
  }
  // per-point carve-up (offsets in elements)
  const size_t oD = 0, oM = oD + (size_t)dd * n * ld, okd = oM + (size_t)n * ld,
               onug = okd + n, ocol = onug + n, ogc = ocol + n,
               os = ogc + (size_t)dd * n, os0 = os + (size_t)(1 + r) * n,
               oS = os0 + (size_t)r * n, osc = oS + (size_t)n * ld;

  // cooperative, point-fastest loads of the block's slices
  for (int e = threadIdx.x; e < n * n * dd * P; e += blockDim.x) {
    const int w = e % P, row = e / P, b = b0 + w;  // row = (i * n + j) * dd + f
    const int f = row % dd, ij = row / dd;
    base(w)[oD + (size_t)f * n * ld + (ij / n) * ld + ij % n] =
        b < B ? pw[(size_t)row * B + b] : T(0);
  }
  for (int e = threadIdx.x; e < n * dd * P; e += blockDim.x) {
    const int w = e % P, row = e / P, b = b0 + w;  // row = i * dd + f
    base(w)[ogc + (size_t)(row % dd) * n + row / dd] = b < B ? cw[(size_t)row * B + b] : T(0);
  }
  for (int e = threadIdx.x; e < n * r * P; e += blockDim.x) {
    const int w = e % P, row = e / P, b = b0 + w;  // row = i * r + k
    const int i = row / r, k = row % r;
    const T v = b < B ? y[(size_t)row * B + b] : T(0);
    base(w)[os + (size_t)(1 + k) * n + i] = v;
    base(w)[os0 + (size_t)k * n + i] = v;
  }
  if (noise_nn != nullptr) {
    for (int e = threadIdx.x; e < n * P; e += blockDim.x) {
      const int w = e % P, i = e / P, b = b0 + w;
      base(w)[onug + i] = b < B ? noise_nn[(size_t)i * B + b] : T(1);
    }
  }
  __syncthreads();

  const int b = b0 + warp;
  if (b >= B) return;  // no block-wide barrier below this point
  T* sm = base(warp);
  T* D = sm + oD;
  T* M = sm + oM;
  T* kd = sm + okd;
  T* nug = sm + onug;
  T* col = sm + ocol;
  T* gc = sm + ogc;
  T* s = sm + os;
  T* s0 = sm + os0;
  T* S = nu_free ? sm + oS : nullptr;
  T* sc = nu_free ? sm + osc : nullptr;
  const T noise = params[dd];
  const T noise0 = params[dd + 1];
  const T* nugp = noise_nn != nullptr ? nug : nullptr;

  // K (strict upper triangle of M, transposed, and kd) and the G fields
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    const T k = assemble(D + i * ld + j, n * ld, aniso, dd, inv, gco, code, metric_power,
                         co, nt, nu_free ? S + i * ld + j : nullptr);
    if (i > j) M[j * ld + i] = k;
    else if (i == j) kd[i] = k;
  }
  for (int i = lane; i < n; i += 32) {
    s[i] = assemble(gc + i, n, aniso, dd, inv, gco, code, metric_power, co, nt,
                    nu_free ? sc + i : nullptr);  // kc
  }
  __syncwarp();

  cholesky(M, kd, nugp, noise, col, n, ld, lane);
  forward(M, s, 1 + r, n, ld, lane);  // s = [zc | zy]

  size_t row = 0;
  auto emit = [&](T v) {
    if (lane == 0) out[row * B + b] = v;
    ++row;
  };
  const T* zc = s;
  for (int k = 0; k < r; ++k) {
    T p = T(0);
    for (int i = lane; i < n; i += 32) p += zc[i] * s[(1 + k) * n + i];
    emit(warp_sum(p));  // mean
  }
  T p = T(0);
  for (int i = lane; i < n; i += 32) p += zc[i] * zc[i];
  emit(T(1) - warp_sum(p));  // var
  T q = T(0);
  if (!noise_free) {
    p = T(0);
    for (int i = lane; i < n * r; i += 32) p += s[n + i] * s[n + i];
    q = warp_sum(p);
  }
  backward(M, s, 1 + r, n, ld, lane);  // s = [a | b]
  const T* a = s;
  const T* bb = s + n;
  const T* bz = bb;
  if (noise_free) {
    cholesky(M, kd, static_cast<const T*>(nullptr), noise0, col, n, ld, lane);
    forward(M, s0, r, n, ld, lane);
    p = T(0);
    for (int i = lane; i < n * r; i += 32) p += s0[i] * s0[i];
    q = warp_sum(p);
    backward(M, s0, r, n, ld, lane);
    bz = s0;
  }
  emit(q);

  // the three contractions of one derivative field G with its crosswise
  // vector gcg: dmean (r rows), dvar, dq
  auto emit_group = [&](const T* G, const T* gcg) {
    // G a into the (now free) column scratch; each lane reads back only
    // its own rows, so no barrier
    for (int j = lane; j < n; j += 32) col[j] = matvec_row(G, a, n, ld, j);
    for (int k = 0; k < r; ++k) {
      T p1 = T(0), p2 = T(0);
      for (int j = lane; j < n; j += 32) {
        const T bj = bb[k * n + j];
        p1 += gcg[j] * bj;
        p2 += col[j] * bj;
      }
      emit(warp_sum(p1) - warp_sum(p2));  // dmean
    }
    T p1 = T(0), p2 = T(0);
    for (int j = lane; j < n; j += 32) {
      p1 += gcg[j] * a[j];
      p2 += col[j] * a[j];
    }
    emit(T(-2) * warp_sum(p1) + warp_sum(p2));  // dvar
    T dq = T(0);
    for (int k = 0; k < r; ++k) {
      T pk = T(0);
      for (int j = lane; j < n; j += 32) pk += matvec_row(G, bz + k * n, n, ld, j) * bz[k * n + j];
      dq -= warp_sum(pk);
    }
    emit(dq);
  };
  for (int g = 0; g < dd; ++g) emit_group(D + (size_t)g * n * ld, gc + (size_t)g * n);
  for (int k = 0; k < r; ++k) {
    T pk = T(0);
    for (int i = lane; i < n; i += 32) pk += a[i] * bb[k * n + i];
    emit(-warp_sum(pk));  // dmean / dnoise
  }
  p = T(0);
  for (int i = lane; i < n; i += 32) p += a[i] * a[i];
  emit(warp_sum(p));  // dvar / dnoise
  if (nu_free) emit_group(S, sc);  // d / dnu, after the noise rows
}

// ---- the register design (n <= 32, r <= 4) ----

constexpr int kRows = 32;  // one lane per row
constexpr int kLdK = 33;   // row stride of the per-warp copy of K

// 16-byte stores and loads of consecutive values (float4, double2)
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

// the register design's widths for value type T and R right-hand sides:
// NC = 1 + R columns [kc | y], padded to XP for 16-byte moves; RB is the
// length of one published pivot row
template <typename T, int R>
struct RegShape {
  static constexpr int VW = 16 / sizeof(T);
  static constexpr int NC = 1 + R;
  static constexpr int XP = (NC + VW - 1) / VW * VW;
  static constexpr int RB = kRows + XP;
};

// shared-memory elements of one point in the register design: two pivot
// rows, the broadcast vectors a, b, b0, the copy of K, the distance slab,
// cw, y and the nugget; a multiple of 4 so every point stays 16-byte aligned
__host__ __device__ __forceinline__ size_t regs_point_elems(int n, int dd, int R, int rb) {
  const size_t e = (size_t)2 * rb + (size_t)(1 + 2 * R) * kRows + (size_t)n * kLdK +
                   (size_t)dd * n * (n | 1) + (size_t)dd * n + (size_t)R * n + n;
  return (e + 3) / 4 * 4;
}

// the scaled distance u of one pair from its raw distance or per-feature
// differences x[f * stride]; acc = sum_f (x_f / ls_f)^2 under anisotropy
template <typename T>
__device__ __forceinline__ T scaled_u(const T* x, int stride, bool aniso, int dd, const T* inv,
                                      int metric_power, T& acc) {
  acc = T(0);
  if (!aniso) return x[0] * inv[0];
  for (int f = 0; f < dd; ++f) {
    const T df = x[f * stride] * inv[f];
    acc += df * df;
  }
  return metric_power == 1 ? sqrt_t(acc) : acc;
}

// G_g = dK / d ls_g of the same pair, from H = u dK/du
template <typename T>
__device__ __forceinline__ T field_g(T h, const T* x, int stride, bool aniso, int g, const T* inv,
                                     const T* gco, T acc) {
  if (!aniso) return gco[0] * h;
  const T fa = acc > Lim<T>::tiny() ? acc : Lim<T>::tiny();
  const T df = x[g * stride] * inv[g];
  return gco[g] * h * ((df * df) / fa);
}

// K(u) alone
template <typename T>
__device__ __forceinline__ T kernel_value(T u, int code, const T* co, int nt) {
  if (code == GEN) {
    T k, d1, d2;
    matern_nu::eval(co[0] * u, co, nt, false, false, k, d1, d2);
    return k;
  }
  T k, h, s;
  kernel_and_deriv(u, code, co, nt, false, k, h, s);
  return k;
}

// Right-looking elimination of lane i's row A (K + nugget, identity padded)
// and its right-hand-side entries x (NC columns) over the first n pivots.
// After it: A[c] = L[i][c] for c < i, A[i] = d_i, A[c] for c > i the raw
// trailing entry of step i (L[c][i] = A[c] * linv_i); x = L^{-1} x; inv_i
// and linv_i (0 where pivot i fell under the floor).
template <typename T, int NC, int XP>
__device__ __forceinline__ void eliminate(T (&A)[kRows], T (&x)[XP], int n, T pfloor, T* rows,
                                          int lane, T& my_inv, T& my_linv) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int RB = kRows + XP;
  my_inv = T(0);
  my_linv = T(0);
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
      const T piv = buf[j];
      const bool bad = piv < pfloor;
      const T d = sqrt_rn(piv > pfloor ? piv : pfloor);
      const T inv = rcp_rn(d);
      const T linv = bad ? T(0) : inv;
      const bool below = lane > j;
      const T l = below ? A[j] * linv : T(0);
      T z[XP];
#pragma unroll
      for (int k0 = 0; k0 < XP; k0 += VW) ld16(z + k0, buf + kRows + k0);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const T zj = z[k] * inv;
        x[k] = below ? fma_t(-l, zj, x[k]) : (lane == j ? zj : x[k]);
      }
#pragma unroll
      for (int c0 = (j + 1) / VW * VW; c0 < kRows; c0 += VW) {
        T r[VW];
        ld16(r, buf + c0);
#pragma unroll
        for (int e = 0; e < VW; ++e)
          if (c0 + e > j) A[c0 + e] = fma_t(-l, r[e] * linv, A[c0 + e]);
      }
      if (below) A[j] = l;
      if (lane == j) {
        A[j] = d;
        my_inv = inv;
        my_linv = linv;
      }
    }
  }
}

// x = L^{-T} x after eliminate(): step j (descending) takes x_j from lane j
// by a shuffle; lanes above it subtract L[j][i] x_j, L[j][i] = A[j] linv_i
template <typename T, int NC, int XP>
__device__ __forceinline__ void back_substitute(const T (&A)[kRows], T (&x)[XP], int n, T my_inv,
                                                T my_linv, int lane) {
#pragma unroll
  for (int j = kRows - 1; j >= 0; --j) {
    if (j < n) {
      const T lj = A[j] * my_linv;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const T xj = __shfl_sync(0xffffffffu, x[k] * my_inv, j);
        x[k] = lane == j ? xj : (lane < j ? fma_t(-lj, xj, x[k]) : x[k]);
      }
    }
  }
}

// lane i's row of K + nug I from the per-warp copy; identity outside n
template <typename T>
__device__ __forceinline__ void load_row(T (&A)[kRows], const T* Ks, int n, T nug, int lane) {
  const bool live = lane < n;
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    T v = c == lane ? T(1) : T(0);
    if (c < n && live) v = Ks[c * kLdK + lane] + (c == lane ? nug : T(0));
    A[c] = v;
  }
}

template <typename T>
struct RegsMinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;  // f32: 16 warps an SM
};

template <typename T, int R>
__global__ void __launch_bounds__(256, RegsMinBlocks<T>::value) fused_train_stats_regs_kernel(
    const T* __restrict__ pw, const T* __restrict__ cw, const T* __restrict__ y,
    const T* __restrict__ params, const T* __restrict__ noise_nn, const T* __restrict__ gen,
    T* __restrict__ out, int n, int d_feat, int r, int B, int code, int metric_power,
    int noise_free, int nu_free, int ncoef, int nt) {
  using Shape = RegShape<T, R>;
  constexpr int NC = Shape::NC, XP = Shape::XP, RB = Shape::RB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool aniso = d_feat > 0;
  const int dd = aniso ? d_feat : 1;
  const int ld = n | 1;
  const int b0 = blockIdx.x * P;
  const size_t per_point = regs_point_elems(n, dd, R, RB);

  auto base = [&](int w) { return reinterpret_cast<T*>(smem_raw) + w * per_point; };
  T* inv = base(P);
  T* gco = inv + dd;
  T* co = gco + dd;
  if (code == GEN) matern_nu::stage(co, gen, ncoef, nt);
  if (threadIdx.x < dd) {
    const int f = threadIdx.x;
    const T ls = params[f];
    inv[f] = !aniso && metric_power == 2 ? T(1) / (ls * ls) : T(1) / ls;
    gco[f] = T(-metric_power) / ls;
  }
  // per-point carve-up (offsets in elements)
  const size_t oVec = 2 * RB, oK = oVec + (size_t)(1 + 2 * R) * kRows,
               oD = oK + (size_t)n * kLdK, oC = oD + (size_t)dd * n * ld, oY = oC + (size_t)dd * n,
               oN = oY + (size_t)R * n;

  // cooperative, point-fastest loads: thread t serves point w = t % P and
  // walks the lower triangle of pw from pair t / P in steps of 32 pairs
  // (blockDim = 32 P), copying each element asynchronously to (i, j) and
  // (j, i) of the slab, so all of a thread's copies are in flight at once
  // and the slab is symmetric from the lower triangle, which is all the
  // plain version reads of K.  A point past B copies point B - 1 (its warp
  // returns before using it).
  {
    const int w = threadIdx.x % P, s0 = threadIdx.x / P;
    const size_t bw = (size_t)min(b0 + w, B - 1);
    T* sw = base(w);
    int i = 0, j = s0;  // pair s0 = i (i + 1) / 2 + j, j <= i
    while (j > i) j -= ++i;
    for (; i < n;) {
      for (int f = 0; f < dd; ++f) {
        const T* src = pw + ((size_t)(i * n + j) * dd + f) * B + bw;
        T* slab = sw + oD + (size_t)f * n * ld;
        __pipeline_memcpy_async(slab + i * ld + j, src, sizeof(T));
        if (i != j) __pipeline_memcpy_async(slab + j * ld + i, src, sizeof(T));
      }
      j += 32;
      while (j > i) j -= ++i;
    }
    for (int row = s0; row < n * dd; row += 32)  // row = i * dd + f
      __pipeline_memcpy_async(sw + oC + (size_t)(row % dd) * n + row / dd,
                              cw + (size_t)row * B + bw, sizeof(T));
    for (int row = s0; row < n * r; row += 32)  // row = i * r + k
      __pipeline_memcpy_async(sw + oY + (size_t)(row % r) * n + row / r,
                              y + (size_t)row * B + bw, sizeof(T));
    if (noise_nn != nullptr)
      for (int row = s0; row < n; row += 32)
        __pipeline_memcpy_async(sw + oN + row, noise_nn + (size_t)row * B + bw, sizeof(T));
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  const int b = b0 + warp;
  if (b >= B) return;  // no block-wide barrier below this point
  T* sm = base(warp);
  T* rows = sm;
  T* vec = sm + oVec;  // a | b_0..b_{R-1} | b0_0..b0_{R-1}, kRows each
  T* Ks = sm + oK;
  const T* D = sm + oD + (size_t)(lane < n ? lane : 0) * ld;  // lane's row
  const T* C = sm + oC + (lane < n ? lane : 0);                // lane's cw
  const int stride = n * ld;
  const bool live = lane < n;
  const T noise = params[dd];
  const T noise0 = params[dd + 1];
  const T nug = noise_nn != nullptr ? (live ? sm[oN + lane] : T(0)) : noise;

  // K row by row into the per-warp copy (lane i writes column i of Ks,
  // i.e. row i of the symmetric K); its diagonal for the floor
  T kdiag = T(0);
  if (live) {
    for (int c = 0; c < n; ++c) {
      T acc;
      const T k = kernel_value(scaled_u(D + c, stride, aniso, dd, inv, metric_power, acc), code,
                               co, nt);
      Ks[c * kLdK + lane] = k;
      if (c == lane) kdiag = k;
    }
  }
  T x[XP];
#pragma unroll
  for (int k = 0; k < XP; ++k) x[k] = T(0);
  if (live) {
    T acc;
    x[0] = kernel_value(scaled_u(C, n, aniso, dd, inv, metric_power, acc), code, co, nt);  // kc
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < r) x[1 + k] = sm[oY + k * n + lane];
  }
  __syncwarp();

  // the relative Gill-Murray floor of K + nugget, and of K + noise0 I
  const T diag1 = warp_sum(live ? kdiag + nug : T(0)) / T(n);
  const T pfloor = T(10) * Lim<T>::eps() * (diag1 > Lim<T>::tiny() ? diag1 : Lim<T>::tiny());

  T A[kRows];
  T my_inv, my_linv;
  load_row(A, Ks, n, nug, lane);
  eliminate<T, NC, XP>(A, x, n, pfloor, rows, lane, my_inv, my_linv);  // x = [zc | zy]

  size_t row = 0;
  auto emit = [&](T v) {
    if (lane == 0) out[row * B + b] = v;
    ++row;
  };
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < r) emit(warp_sum(x[0] * x[1 + k]));  // mean
  emit(T(1) - warp_sum(x[0] * x[0]));             // var
  T q = T(0);
  if (!noise_free) {
    T p = T(0);
#pragma unroll
    for (int k = 0; k < R; ++k) p += x[1 + k] * x[1 + k];
    q = warp_sum(p);
  }
  back_substitute<T, NC, XP>(A, x, n, my_inv, my_linv, lane);  // x = [a | b]
  const T a = x[0];
  vec[lane] = a;
#pragma unroll
  for (int k = 0; k < R; ++k) vec[(1 + k) * kRows + lane] = x[1 + k];
  T bz[R];  // b0: b, or the stored-noise solve's
#pragma unroll
  for (int k = 0; k < R; ++k) bz[k] = x[1 + k];
  if (noise_free) {
    const T diag0 = warp_sum(live ? kdiag + noise0 : T(0)) / T(n);
    const T pfloor0 =
        T(10) * Lim<T>::eps() * (diag0 > Lim<T>::tiny() ? diag0 : Lim<T>::tiny());
    T x0[XP];  // [0 | y]: no crosswise column
#pragma unroll
    for (int k = 0; k < XP; ++k) x0[k] = T(0);
#pragma unroll
    for (int k = 0; k < R; ++k) x0[1 + k] = live && k < r ? sm[oY + k * n + lane] : T(0);
    load_row(A, Ks, n, noise0, lane);
    __syncwarp();  // every lane is done with the first elimination's rows
    eliminate<T, NC, XP>(A, x0, n, pfloor0, rows, lane, my_inv, my_linv);
    T p = T(0);
#pragma unroll
    for (int k = 0; k < R; ++k) p += x0[1 + k] * x0[1 + k];
    q = warp_sum(p);
    back_substitute<T, NC, XP>(A, x0, n, my_inv, my_linv, lane);
#pragma unroll
    for (int k = 0; k < R; ++k) bz[k] = x0[1 + k];
  }
  emit(q);
#pragma unroll
  for (int k = 0; k < R; ++k) vec[(1 + R + k) * kRows + lane] = bz[k];
  __syncwarp();

  // per length-scale group g: lane i's row of G_g (and, with g = 0 under a
  // free nu, of S) contracted with the broadcast a and b0; the S rows wait
  // until after the noise rows
  T s_wa = T(0), s_sc = T(0), s_wb0[R];
#pragma unroll
  for (int k = 0; k < R; ++k) s_wb0[k] = T(0);
  for (int g = 0; g < dd; ++g) {
    const bool with_s = nu_free && g == 0;
    T wa = T(0), wb0[R];
#pragma unroll
    for (int k = 0; k < R; ++k) wb0[k] = T(0);
    T gcg = T(0);
    if (live) {
      for (int c = 0; c < n; ++c) {
        T acc, k, h, s;
        const T u = scaled_u(D + c, stride, aniso, dd, inv, metric_power, acc);
        kernel_and_deriv(u, code, co, nt, with_s, k, h, s);
        const T G = field_g(h, D + c, stride, aniso, g, inv, gco, acc);
        const T ac = vec[c];
        wa = fma_t(G, ac, wa);
        if (with_s) s_wa = fma_t(s, ac, s_wa);
#pragma unroll
        for (int kk = 0; kk < R; ++kk) {
          const T bc = vec[(1 + R + kk) * kRows + c];
          wb0[kk] = fma_t(G, bc, wb0[kk]);
          if (with_s) s_wb0[kk] = fma_t(s, bc, s_wb0[kk]);
        }
      }
      T acc, k, h, s;
      const T u = scaled_u(C, n, aniso, dd, inv, metric_power, acc);
      kernel_and_deriv(u, code, co, nt, with_s, k, h, s);
      gcg = field_g(h, C, n, aniso, g, inv, gco, acc);
      if (with_s) s_sc = s;
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < r) {
        const T bk = x[1 + k];
        emit(warp_sum(gcg * bk) - warp_sum(wa * bk));  // dmean
      }
    emit(T(-2) * warp_sum(gcg * a) + warp_sum(wa * a));  // dvar
    T dq = T(0);
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < r) dq -= warp_sum(wb0[k] * bz[k]);
    emit(dq);
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < r) emit(-warp_sum(a * x[1 + k]));  // dmean / dnoise
  emit(warp_sum(a * a));                        // dvar / dnoise
  if (nu_free) {                                // d / dnu
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < r) {
        const T bk = x[1 + k];
        emit(warp_sum(s_sc * bk) - warp_sum(s_wa * bk));
      }
    emit(T(-2) * warp_sum(s_sc * a) + warp_sum(s_wa * a));
    T dq = T(0);
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < r) dq -= warp_sum(s_wb0[k] * bz[k]);
    emit(dq);
  }
}

constexpr size_t kMaxSmem = 232448;  // 227 KB a block can opt into on sm_90
constexpr int kMaxDevices = 64;      // devices whose kernel attributes are remembered

// One launch of either design.  P points (warps) per block: 8, halved until
// the block's shared memory fits the 227 KB a block can opt into; a shape
// whose one point does not fit is refused, never shrunk further.
// `configured[device]` is the shared memory the kernel's attributes were last
// set for on that device (CUDA keeps them per device): the runtime calls that
// set them run once per kernel, device and size, not on every launch (a
// training run launches K2 once per objective evaluation).  A device past
// kMaxDevices has them set on every launch.
template <typename T, typename Kernel, typename Elems>
int launch_design(Kernel kernel, size_t* configured, Elems point_elems_of, const T* pw,
                  const T* cw, const T* y, const T* params, const T* noise_nn, const T* gen,
                  T* out, int n, int d_feat, int r, int B, int code, int metric_power,
                  int noise_free, int nu_free, int ncoef, int nt, void* stream) {
  const int dd = d_feat > 0 ? d_feat : 1;
  int P = 8;
  size_t bytes = 0;
  for (; P >= 1; P /= 2) {
    bytes = sizeof(T) * ((size_t)P * point_elems_of() + 2 * dd + ncoef);
    if (bytes <= kMaxSmem) break;
  }
  if (P < 1) return (int)cudaErrorInvalidValue;  // one point does not fit
  int device = 0;
  const cudaError_t derr = cudaGetDevice(&device);
  if (derr != cudaSuccess) return (int)derr;
  size_t unremembered = 0;
  size_t& done = device < kMaxDevices ? configured[device] : unremembered;
  if (bytes > done) {
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    // as much of the SM's 256 KB as shared memory as the blocks can use
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    done = bytes;
  }
  const int grid = (B + P - 1) / P;
  kernel<<<grid, 32 * P, bytes, (cudaStream_t)stream>>>(pw, cw, y, params, noise_nn, gen, out, n,
                                                        d_feat, r, B, code, metric_power,
                                                        noise_free, nu_free, ncoef, nt);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_regs(const T* pw, const T* cw, const T* y, const T* params, const T* noise_nn,
                const T* gen, T* out, int n, int d_feat, int r, int B, int code,
                int metric_power, int noise_free, int nu_free, int ncoef, int nt, void* stream) {
  const int dd = d_feat > 0 ? d_feat : 1;
  static size_t configured[kMaxDevices] = {};  // one per instantiation
  return launch_design<T>(
      fused_train_stats_regs_kernel<T, R>, configured,
      [&] { return regs_point_elems(n, dd, R, RegShape<T, R>::RB); }, pw, cw, y, params,
      noise_nn, gen, out, n, d_feat, r, B, code, metric_power, noise_free, nu_free, ncoef, nt,
      stream);
}

// design 1: the register design (n <= 32, r <= 4, R = 1, 2 or 4 right-hand
// sides compiled); design 0: the shared-memory design
template <typename T>
int launch(const T* pw, const T* cw, const T* y, const T* params, const T* noise_nn,
           const T* gen, T* out, int n, int d_feat, int r, int B, int code,
           int metric_power, int noise_free, int nu_free, int ncoef, int nt, int design,
           void* stream) {
  if (B == 0) return 0;
  if (n < 1 || r < 1) return (int)cudaErrorInvalidValue;
  const int dd = d_feat > 0 ? d_feat : 1;
  if (code != GEN) ncoef = 0;
  if (design == 1) {
    if (n > kRows || r > 4) return (int)cudaErrorInvalidValue;
    auto go = r == 1 ? launch_regs<T, 1> : r == 2 ? launch_regs<T, 2> : launch_regs<T, 4>;
    return go(pw, cw, y, params, noise_nn, gen, out, n, d_feat, r, B, code, metric_power,
              noise_free, nu_free, ncoef, nt, stream);
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  static size_t configured[kMaxDevices] = {};  // one per instantiation
  return launch_design<T>(
      fused_train_stats_kernel<T>, configured, [&] { return point_elems(n, dd, r, nu_free); },
      pw, cw, y, params, noise_nn, gen, out, n, d_feat, r, B, code, metric_power, noise_free,
      nu_free, ncoef, nt, stream);
}

}  // namespace

extern "C" {

int fused_train_stats_f32(const float* pw, const float* cw, const float* y,
                          const float* params, const float* noise_nn, const float* gen,
                          float* out, int n, int d_feat, int r, int B, int code,
                          int metric_power, int noise_free, int nu_free, int ncoef, int nt,
                          int design, void* stream) {
  return launch<float>(pw, cw, y, params, noise_nn, gen, out, n, d_feat, r, B, code,
                       metric_power, noise_free, nu_free, ncoef, nt, design, stream);
}

int fused_train_stats_f64(const double* pw, const double* cw, const double* y,
                          const double* params, const double* noise_nn, const double* gen,
                          double* out, int n, int d_feat, int r, int B, int code,
                          int metric_power, int noise_free, int nu_free, int ncoef, int nt,
                          int design, void* stream) {
  return launch<double>(pw, cw, y, params, noise_nn, gen, out, n, d_feat, r, B, code,
                        metric_power, noise_free, nu_free, ncoef, nt, design, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
