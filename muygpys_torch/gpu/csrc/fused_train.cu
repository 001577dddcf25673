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
// What bounds it on an H100: at the training headline (n=30, isotropic,
// r=1, B=2048, f32, noise free) the kernel must read pw, n*n*B*4 ~ 7.4 MB of
// its ~7.9 MB (~2.4 us at 3.35 TB/s), while its ~35 kflop per point (two
// n^3/3 factorizations, four substitutions, two n x n matvecs, ~500 kernel
// evaluations) come to ~1.1 us at 67 TFLOP/s: the bound is bytes.  What
// actually limits this first design is latency: each point is one warp
// walking ~n^2/2 dependent shared-memory multiply-adds per factorization.
// All 2048 points are resident at once (one wave), so the kernel takes
// about one warp's latency.
//
// Design: one warp per batch point, up to 8 points per block (halved until
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
#include <cuda_runtime.h>

#include "matern_nu.cuh"

namespace {

enum Smoothness { NU05 = 0, NU15 = 1, NU25 = 2, NUINF = 3, RBF = 4, GEN = 5 };

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

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

constexpr size_t kMaxSmem = 232448;  // 227 KB a block can opt into on sm_90

template <typename T>
int launch(const T* pw, const T* cw, const T* y, const T* params, const T* noise_nn,
           const T* gen, T* out, int n, int d_feat, int r, int B, int code,
           int metric_power, int noise_free, int nu_free, int ncoef, int nt, void* stream) {
  if (B == 0) return 0;
  const int dd = d_feat > 0 ? d_feat : 1;
  if (code != GEN) ncoef = 0;
  int P = 8;
  size_t bytes = 0;
  for (; P >= 1; P /= 2) {
    bytes = sizeof(T) * ((size_t)P * point_elems(n, dd, r, nu_free) + 2 * dd + ncoef);
    if (bytes <= kMaxSmem) break;
  }
  if (P < 1) return (int)cudaErrorInvalidValue;  // one point does not fit
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_train_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + P - 1) / P;
  fused_train_stats_kernel<T><<<grid, 32 * P, bytes, (cudaStream_t)stream>>>(
      pw, cw, y, params, noise_nn, gen, out, n, d_feat, r, B, code, metric_power,
      noise_free, nu_free, ncoef, nt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_train_stats_f32(const float* pw, const float* cw, const float* y,
                          const float* params, const float* noise_nn, const float* gen,
                          float* out, int n, int d_feat, int r, int B, int code,
                          int metric_power, int noise_free, int nu_free, int ncoef, int nt,
                          void* stream) {
  return launch<float>(pw, cw, y, params, noise_nn, gen, out, n, d_feat, r, B, code,
                       metric_power, noise_free, nu_free, ncoef, nt, stream);
}

int fused_train_stats_f64(const double* pw, const double* cw, const double* y,
                          const double* params, const double* noise_nn, const double* gen,
                          double* out, int n, int d_feat, int r, int B, int code,
                          int metric_power, int noise_free, int nu_free, int ncoef, int nt,
                          void* stream) {
  return launch<double>(pw, cw, y, params, noise_nn, gen, out, n, d_feat, r, B, code,
                        metric_power, noise_free, nu_free, ncoef, nt, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
