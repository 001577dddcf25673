// K5: fused multi-output (block) posterior solve, hand-written for Hopper.
//
// Replaces muygpys_tpu/pallas/multiout_solve.py:fused_multiout_solve_bl (the
// Pallas kernel _multiout_body).  The lensing shear family conditions each
// query on a FLATTENED observation block of m = I * nn rows (90 for the
// 3-in/3-out kernel at nn = 30, 60 for 2-in/3-out) and predicts o = 3 outputs
// with their full covariance.  Per query the kernel
//   reads the augmented matrix  work = [Kin | Kcross (o columns) | y]
//   floor = 10 eps * max(mean(diag Kin), tiny)          (before any elimination)
//   for each pivot j:  piv = work[j][j];  d = sqrt(max(piv, floor));  inv = 1/d
//        row j is scaled by inv (its Kcross and y columns included)
//        lcol[i] = work[i][j] * inv for i > j, or 0 where piv < floor
//        work[i][c] -= lcol[i] * (work[j][c] * inv)     for i > j, c > j
//   zc = the scaled Kcross columns, zy = the scaled y column
//   mean(k) = zc(:, k) . zy,   S(k, l) = zc(:, k) . zc(:, l)
// and the wrapper forms cov = Kout - S.  This is the relative Gill-Murray
// pivot floor of the TPU kernel: where it acts, row j is still divided by
// sqrt(floor), only the column below the pivot is zeroed and the trailing
// block is left untouched.  sqrt then 1/d, never rsqrt, so the same pivots
// fall under the floor as in the plain version.
//
// Which triangle is read: as the TPU kernel, the column below the pivot comes
// from the LOWER triangle (work[i][j]), the pivot row from the UPPER
// (work[j][c]), and the whole trailing square is updated; no symmetry of Kin
// is assumed.
//
// What bounds it on an H100: at the serving shape (m = 90, o = 3, B = 2048,
// f32) the inputs are m (m + o + 1) * 4 * B = 69 MB (21 us at 3.35 TB/s)
// against m^3/3 + m^2 (o + 1) = 275k multiply-adds per query (17 us at the
// 67 TFLOP/s fp32 rate): bytes, narrowly.  What it actually waits for is
// shared memory: each multiply-subtract of the trailing update loads and
// stores one element there (2 MB per query through a port of 128 bytes a
// clock: ~0.14 ms for the batch at best), and the m pivot steps depend on
// one another.  Measured 0.40 ms on an H100 (PERF.md): a design that keeps
// the matrix in registers is what would go under that floor.
//
// Design.  One query's augmented matrix is m (m + o + 1) values: 33.8 KB in
// f32 and 67.7 KB in f64 at m = 90, so K1's geometry (8 queries of one warp
// each per block) does not fit the 227 KB a block can use.  Here ONE BLOCK of
// 4 warps owns ONE query; 6 such blocks (f32) or 3 (f64) share an SM and hide
// each other's pivot latency.  The matrix lives in shared memory row-major
// (row stride m + o + 1, lanes on consecutive columns, so no bank conflicts).
// Pivot step j: every thread reads the pivot (a broadcast) and computes inv
// itself; warp w takes rows j+1+w, j+5+w, ...; a lane keeps the scaled pivot
// row of its (up to 4 at a time) columns in registers, reads the row's lcol
// once (a broadcast) and updates its columns.  Row j is NOT scaled in place
// (other warps are still reading it): inv goes to a vector dinv[j], and the
// right-hand-side columns are scaled once at the end.  One __syncthreads per
// pivot.  The last step reduces the o + o^2 dot products, one per warp at a
// time, by warp shuffles.
//
// Layouts.  The kernel takes an element stride and a query stride for every
// tensor, so one build serves both public entries:
//   batch-last  Kin (m, m, B), Kcross (m, o, B), y (m, B) -> mean (o, B),
//               S (o, o, B): the TPU kernel's contract; one query's values lie
//               B elements apart, so its loads are 4 useful bytes per sector;
//   frontend    Kin (B, m, m), Kcross (B, m, o), y (B, m) -> mean (B, o),
//               S (B, o, o): what the serving path has before any transpose;
//               one query's values are contiguous and the loads coalesce.
// The TPU's VMEM tile rule (multiout_tile_cap) has no counterpart but the
// launcher's shared-memory rule: a shape whose one query does not fit 227 KB
// (m > 238 in f32, 167 in f64, at o = 3) is refused, never shrunk.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 128;        // 4 warps per query
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;            // columns a lane holds in registers at a time
constexpr size_t kMaxSmem = 232448;  // 227 KB a block can opt into on sm_90

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) { return fmax(a, b); }

// the dtype's machine epsilon and smallest normal number
__device__ __forceinline__ float eps_of(float) { return FLT_EPSILON; }
__device__ __forceinline__ double eps_of(double) { return DBL_EPSILON; }
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }
__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Element e of query b lies at base[b * query_stride + e * elem_stride].
template <typename T>
__global__ void __launch_bounds__(kThreads) multiout_solve_kernel(
    const T* __restrict__ Kin,     // m * m elements per query
    const T* __restrict__ Kcross,  // m * o
    const T* __restrict__ y,       // m
    T* __restrict__ mean,          // o
    T* __restrict__ S,             // o * o
    int m, int o, long long elem_stride, long long kin_q, long long kc_q, long long y_q,
    long long mean_q, long long s_q) {
  extern __shared__ unsigned char smem_raw[];
  T* work = reinterpret_cast<T*>(smem_raw);  // [m][W] augmented matrix
  const int W = m + o + 1;
  T* dinv = work + (size_t)m * W;            // [m] 1 / sqrt(floored pivot)
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long b = blockIdx.x;

  const T* kin_b = Kin + b * kin_q;
  for (int e = tid; e < m * m; e += kThreads)
    work[(e / m) * W + e % m] = kin_b[(long long)e * elem_stride];
  const T* kc_b = Kcross + b * kc_q;
  for (int e = tid; e < m * o; e += kThreads)
    work[(e / o) * W + m + e % o] = kc_b[(long long)e * elem_stride];
  const T* y_b = y + b * y_q;
  for (int e = tid; e < m; e += kThreads) work[e * W + m + o] = y_b[(long long)e * elem_stride];
  __syncthreads();

  // the floor's inputs: the mean of the INPUT's diagonal, summed in order
  T diag = T(0);
  for (int j = 0; j < m; ++j) diag += work[j * W + j];
  const T pivot_floor = T(10) * eps_of(T(0)) * max_t(diag / T(m), tiny_of(T(0)));

  for (int j = 0; j < m; ++j) {
    const T piv = work[j * W + j];
    const bool bad = piv < pivot_floor;
    const T inv = T(1) / sqrt_t(max_t(piv, pivot_floor));
    if (tid == 0) dinv[j] = inv;
    if (!bad) {  // uniform over the block: every thread read the same pivot
      const T* rowj = work + j * W;
      for (int c0 = j + 1 + lane; c0 < W; c0 += 32 * kSlots) {
        T rj[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int c = c0 + 32 * s;
          rj[s] = c < W ? rowj[c] * inv : T(0);
        }
        for (int i = j + 1 + warp; i < m; i += kWarps) {
          T* rowi = work + i * W;
          const T l = rowi[j] * inv;
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const int c = c0 + 32 * s;
            if (c < W) rowi[c] -= l * rj[s];
          }
        }
      }
    }
    __syncthreads();  // step j + 1 reads what every warp wrote in step j
  }

  // zc, zy: the right-hand-side columns scaled by their row's inv
  for (int e = tid; e < m * (o + 1); e += kThreads) {
    const int i = e / (o + 1);
    work[i * W + m + e % (o + 1)] *= dinv[i];
  }
  __syncthreads();

  // mean(k) = zc(:, k) . zy and S(k, l) = zc(:, k) . zc(:, l), a warp each
  T* mean_b = mean + b * mean_q;
  T* s_b = S + b * s_q;
  for (int t = warp; t < o + o * o; t += kWarps) {
    const int ca = t < o ? t : (t - o) / o;
    const int cb = t < o ? o : (t - o) % o;
    T acc = T(0);
    for (int i = lane; i < m; i += 32) acc += work[i * W + m + ca] * work[i * W + m + cb];
    acc = warp_sum(acc);
    if (lane == 0) {
      if (t < o) mean_b[(long long)t * elem_stride] = acc;
      else s_b[(long long)(t - o) * elem_stride] = acc;
    }
  }
}

template <typename T>
int launch(const T* Kin, const T* Kcross, const T* y, T* mean, T* S, int m, int o, int B,
           int batch_last, void* stream) {
  if (B == 0) return 0;
  if (m < 1 || o < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(T) * ((size_t)m * (m + o + 1) + m);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;  // one query does not fit
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        multiout_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long es = batch_last ? B : 1;
  const long long mm = (long long)m * m, mo = (long long)m * o;
  multiout_solve_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      Kin, Kcross, y, mean, S, m, o, es, batch_last ? 1 : mm, batch_last ? 1 : mo,
      batch_last ? 1 : m, batch_last ? 1 : o, batch_last ? 1 : (long long)o * o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int multiout_solve_f32(const float* Kin, const float* Kcross, const float* y, float* mean,
                       float* S, int m, int o, int B, int batch_last, void* stream) {
  return launch<float>(Kin, Kcross, y, mean, S, m, o, B, batch_last, stream);
}

int multiout_solve_f64(const double* Kin, const double* Kcross, const double* y,
                       double* mean, double* S, int m, int o, int B, int batch_last,
                       void* stream) {
  return launch<double>(Kin, Kcross, y, mean, S, m, o, B, batch_last, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
