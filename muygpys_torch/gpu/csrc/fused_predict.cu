// K1: fused coordinate-streaming posterior solve, hand-written for Hopper.
//
// Replaces muygpys_tpu/pallas/fused_predict.py:fused_predict_coords_bl (the
// Pallas kernel _coords_body + _matern + _solve_and_emit).  Per query b:
//   u_p(i,c) = |(x_i - x_c) / ls|, u_c(i) = |(x_i - q) / ls|   (per-feature ls;
//             F2 metric: the squared sum, no sqrt)
//   K = k(u_p) + nugget I,  kc = k(u_c)          (Matern 1/2, 3/2, 5/2, inf or
//                                                  RBF on the F2 distance)
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
// Design: one warp per query, lanes over the m = n + 1 + r columns of the
// augmented matrix, which lives in shared memory row-major (lane c owns
// column c, so a warp's row access hits consecutive banks).  Pivot step j
// reads the pivot, scales row j, stages the scaled column below the pivot in
// a per-warp vector, then each lane updates its own column with n-1-j
// fused multiply-subtracts; only __syncwarp separates the steps.  A block
// holds up to 8 queries (8 warps); the block's neighbor coordinates and
// targets are loaded cooperatively with the query index fastest, so each
// (row, 8 queries) read is one contiguous segment of the batch-last inputs.
// The Pallas kernel instead ran the whole elimination as full-width vector
// ops over a 512-query lane tile in VMEM; on Hopper that tile would not fit
// the 227 KB of shared memory, and warps give the latency hiding.

#include <cuda_runtime.h>

namespace {

enum Smoothness { NU05 = 0, NU15 = 1, NU25 = 2, NUINF = 3, RBF = 4 };

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// the closed forms of muygpys_tpu/pallas/fused_predict.py:_matern
template <typename T>
__device__ __forceinline__ T kernel_value(T u, int code) {
  switch (code) {
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

template <typename T>
__global__ void fused_predict_coords_kernel(
    const T* __restrict__ nf,        // (n, d, B)
    const T* __restrict__ q,         // (d, B)
    const T* __restrict__ y,         // (n, r, B)
    const T* __restrict__ params,    // (d + 1): ls_0..ls_{d-1}, noise
    const T* __restrict__ noise_nn,  // (n, B) or null
    T* __restrict__ mean,            // (r, B)
    T* __restrict__ var,             // (B,)
    int n, int d, int r, int B, int code, int metric_power) {
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
    T k = kernel_value(metric_power == 1 ? sqrt_t(acc) : acc, code);
    if (i == c) k += noise_nn != nullptr ? lc[i] : noise;
    work[i * m + c] = k;
  }
  for (int i = lane; i < n; i += 32) {
    T acc = T(0);
    for (int f = 0; f < d; ++f) {
      const T diff = x[i * d + f] - qq[f];
      acc += diff * diff;
    }
    work[i * m + n] = kernel_value(metric_power == 1 ? sqrt_t(acc) : acc, code);
  }
  __syncwarp();

  // in-place elimination of [K | kc | y]
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

constexpr size_t kMaxSmem = 232448;  // 227 KB a block can opt into on sm_90

template <typename T>
int launch(const T* nf, const T* q, const T* y, const T* params, const T* noise_nn,
           T* mean, T* var, int n, int d, int r, int B, int code, int metric_power,
           void* stream) {
  if (B == 0) return 0;
  const int m = n + 1 + r;
  int tq = 8;
  size_t bytes = 0;
  for (; tq >= 1; tq /= 2) {
    bytes = sizeof(T) * (size_t)tq * (n * d + d + n * m + n);
    if (bytes <= kMaxSmem) break;
  }
  if (tq < 1) return (int)cudaErrorInvalidValue;  // one query's matrix does not fit
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_predict_coords_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + tq - 1) / tq;
  fused_predict_coords_kernel<T><<<grid, 32 * tq, bytes, (cudaStream_t)stream>>>(
      nf, q, y, params, noise_nn, mean, var, n, d, r, B, code, metric_power);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_predict_coords_f32(const float* nf, const float* q, const float* y,
                             const float* params, const float* noise_nn, float* mean,
                             float* var, int n, int d, int r, int B, int code,
                             int metric_power, void* stream) {
  return launch<float>(nf, q, y, params, noise_nn, mean, var, n, d, r, B, code,
                       metric_power, stream);
}

int fused_predict_coords_f64(const double* nf, const double* q, const double* y,
                             const double* params, const double* noise_nn, double* mean,
                             double* var, int n, int d, int r, int B, int code,
                             int metric_power, void* stream) {
  return launch<double>(nf, q, y, params, noise_nn, mean, var, n, d, r, B, code,
                        metric_power, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
