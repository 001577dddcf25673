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
// What bounds it on an H100 (chip_smoke.py's count): at the serving shape
// (m = 90, o = 3, B = 2048, f32) the kernel reads m (m + o + 1) values and
// writes o + o^2 per query, 69.4 MB (0.0207 ms at 3.35 TB/s), against ~521k
// operations per query over the whole trailing square (0.0159 ms at the 67
// TFLOP/s fp32 rate): bytes, narrowly.  A design with the matrix in shared
// memory waits for shared memory instead: every multiply-subtract of the
// trailing update loads and stores one element there.
//
// Two designs.  The launcher takes the register design for the shapes it is
// compiled for, (m, o) = (90, 3) in f32 and f64 and (60, 3) in f32, and the
// shared-memory design for any other shape (multiout_solve.py:multiout_design
// states the same rule).  In f64 at m = 60 the shared-memory design was as
// fast (0.2424 against 0.2486 ms on an H100 at B = 2048), at m = 90 it was
// 1.5x slower.
//
// The register design (multiout_regs_kernel): one block of TR x TC threads
// owns one query, and the augmented matrix lives in registers, spread
// cyclically over rows and columns (thread (tr, tc) holds rows tr, tr + TR,
// ... and columns tc, tc + TC, ...), so every thread keeps a share of the
// shrinking trailing square.  The pivot loop is fully unrolled over the
// compile-time m, so every register index is static and tiles that are
// done drop out of the code.  Pivot step j: the owners of row j and of
// column j write them, raw, to a double-buffered shared row and column
// (one __syncthreads a step), zero wherever they must not act and laid out
// so that each thread's share is contiguous: a reader needs no index tests
// and takes its l and r values in 16-byte loads.  Every thread reads the
// pivot and takes one correctly rounded square root and reciprocal
// (__fsqrt_rn, __frcp_rn: the results of sqrt and 1 / d, without the
// generic division's slow path); both scales go on l (l = column * linv *
// inv, r = the raw row), and it updates its tile with independent fused
// multiply-adds.  A warp whose rows of a tile are all above the pivot skips
// them (the test is uniform over the warp: tc is the fast thread index).
// Row j's right-hand-side entries are scaled in place by their owners.  f32
// runs 16 x 8 threads (a 6 x 12 tile at m = 90), f64 32 x 8 (3 x 12), the
// fastest geometries measured on the card (PERF.md, Findings).

// The shared-memory design (multiout_solve_kernel), kept for every other
// shape: one query's augmented matrix is m (m + o + 1) values: 33.8 KB in
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
// Layouts.  Both designs take an element stride and a query stride for every
// tensor, so one build serves both public entries:
//   batch-last  Kin (m, m, B), Kcross (m, o, B), y (m, B) -> mean (o, B),
//               S (o, o, B): the TPU kernel's contract; one query's values lie
//               B elements apart, so its loads are 4 useful bytes per sector;
//   frontend    Kin (B, m, m), Kcross (B, m, o), y (B, m) -> mean (B, o),
//               S (B, o, o): what the serving path has before any transpose;
//               one query's values are contiguous and the loads coalesce.
// The TPU's VMEM tile rule (multiout_tile_cap) has no counterpart but the
// launcher's shared-memory rule: a shape whose one query does not fit 227 KB
// in the shared-memory design (m > 238 in f32, 167 in f64, at o = 3) is
// refused, never shrunk.

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
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

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
  __syncthreads();  // step 0 updates the diagonal: every thread has read it first

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

// ---- the register design: compile-time m and o ----

// IEEE square root and reciprocal without the generic division's slow
// path: the same correctly rounded results as sqrt and 1 / d
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }

// four consecutive values to and from shared memory in 16-byte moves
__device__ __forceinline__ void st4(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void st4(double* d, const double* s) {  // two 16-byte moves
  reinterpret_cast<double2*>(d)[0] = make_double2(s[0], s[1]);
  reinterpret_cast<double2*>(d)[1] = make_double2(s[2], s[3]);
}
__device__ __forceinline__ void ld4(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}
__device__ __forceinline__ void ld4(double* d, const double* s) {
  const double2 v0 = reinterpret_cast<const double2*>(s)[0];
  const double2 v1 = reinterpret_cast<const double2*>(s)[1];
  d[0] = v0.x, d[1] = v0.y, d[2] = v1.x, d[3] = v1.y;
}

// thread geometry of the register design: TR x TC threads; thread (tr, tc)
// holds rows tr, tr + TR, ... and columns tc, tc + TC, ... (TC divides 32
// and TR * TC is a multiple of 32)
template <typename T> struct RegGeometry;
template <> struct RegGeometry<float> { static constexpr int TR = 16, TC = 8; };
template <> struct RegGeometry<double> { static constexpr int TR = 32, TC = 8; };

template <typename T, int M, int O>
__global__ void __launch_bounds__(RegGeometry<T>::TR * RegGeometry<T>::TC)
    multiout_regs_kernel(const T* __restrict__ Kin, const T* __restrict__ Kcross,
                         const T* __restrict__ y, T* __restrict__ mean, T* __restrict__ S,
                         long long elem_stride, long long kin_q, long long kc_q, long long y_q,
                         long long mean_q, long long s_q) {
  constexpr int TR = RegGeometry<T>::TR, TC = RegGeometry<T>::TC;
  constexpr int NT = TR * TC, NW = NT / 32;
  constexpr int W = M + O + 1;
  constexpr int RT = (M + TR - 1) / TR, CT = (W + TC - 1) / TC;  // tile rows, columns
  constexpr int RTP = (RT + 3) / 4 * 4, CTP = (CT + 3) / 4 * 4;  // padded to 16 bytes
  constexpr int ROWS_PER_WARP = 32 / TC;  // warp w holds tr = w * ROWS_PER_WARP + 0, 1, ...
  // the raw pivot row and the raw column under the pivot, double-buffered,
  // each thread's share contiguous (row: [tc][ci], column: [tr][ri]) and
  // zero wherever it must not act (left of the pivot, above it)
  __shared__ __align__(16) T rowbuf[2][TC * CTP];
  __shared__ __align__(16) T colbuf[2][TR * RTP];
  __shared__ T diag[M];
  __shared__ T rhs[M * (O + 1)];
  const int tid = threadIdx.x;
  const int tc = tid % TC, tr = tid / TC;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long b = blockIdx.x;

  // the tile: a[ri][ci] = work[ri TR + tr][ci TC + tc]; zero outside the
  // matrix; every load independent of the others
  T a[RT][CT];
  const T* kin_b = Kin + b * kin_q;
  const T* kc_b = Kcross + b * kc_q;
  const T* y_b = y + b * y_q;
#pragma unroll
  for (int ri = 0; ri < RT; ++ri) {
    const int i = ri * TR + tr;
#pragma unroll
    for (int ci = 0; ci < CT; ++ci) {
      const int c = ci * TC + tc;
      const T* src = c < M       ? kin_b + (long long)(i * M + c) * elem_stride
                     : c < M + O ? kc_b + (long long)(i * O + c - M) * elem_stride
                                 : y_b + (long long)i * elem_stride;
      const T v = i < M && c < W ? *src : T(0);
      if (i < M && c == i) diag[i] = v;
      a[ri][ci] = v;
    }
  }
  __syncthreads();
  // the floor's inputs: the mean of the INPUT's diagonal, summed in order
  T dsum = T(0);
  for (int j = 0; j < M; ++j) dsum += diag[j];
  const T pivot_floor = T(10) * eps_of(T(0)) * max_t(dsum / T(M), tiny_of(T(0)));

#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int pri = j / TR, pr = j % TR;  // row j: tile row, owner tr
    const int pci = j / TC, pc = j % TC;  // column j: tile column, owner tc
    T* rb = rowbuf[j & 1];
    T* cb = colbuf[j & 1];
    if (tr == pr) {  // row j from the pivot on, zero to its left
#pragma unroll
      for (int g = 0; g < CTP; g += 4) {
        if ((g + 3) * TC + TC - 1 < j) continue;
        T v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = g + e < CT && (g + e) * TC + tc >= j ? a[pri][g + e < CT ? g + e : 0] : T(0);
        st4(rb + tc * CTP + g, v);
      }
    }
    if (tc == pc) {  // column j below the pivot, zero above
#pragma unroll
      for (int g = 0; g < RTP; g += 4) {
        if ((g + 3) * TR + TR - 1 <= j) continue;
        T v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = g + e < RT && (g + e) * TR + tr > j ? a[g + e < RT ? g + e : 0][pci] : T(0);
        st4(cb + tr * RTP + g, v);
      }
    }
    __syncthreads();
    const T piv = rb[pc * CTP + pci];
    const T inv = rcp_rn(sqrt_rn(max_t(piv, pivot_floor)));
    // l = column * linv and r = row * inv, with both scales on l
    const T scale = piv < pivot_floor ? T(0) : inv * inv;
    if (tr == pr) {  // row j's right-hand sides, scaled in place
#pragma unroll
      for (int ci = 0; ci < CT; ++ci)
        if (ci * TC + TC - 1 >= M && ci * TC + tc >= M) a[pri][ci] *= inv;
    }
    T l[RTP], r[CTP];
#pragma unroll
    for (int g = 0; g < RTP; g += 4) {
      if ((g + 3) * TR + TR - 1 <= j) continue;
      ld4(l + g, cb + tr * RTP + g);
    }
#pragma unroll
    for (int g = 0; g < CTP; g += 4) {
      if ((g + 3) * TC + TC - 1 < j) continue;
      ld4(r + g, rb + tc * CTP + g);
    }
#pragma unroll
    for (int ri = 0; ri < RT; ++ri) {
      if (ri * TR + TR - 1 <= j) continue;  // every thread's row ri is done
      // this warp's rows of tile ri: uniform over the warp
      if (ri * TR + (warp + 1) * ROWS_PER_WARP - 1 <= j) continue;
      const T li = l[ri] * scale;
#pragma unroll
      for (int ci = 0; ci < CT; ++ci) {
        if (ci * TC + TC - 1 <= j) continue;
        a[ri][ci] = fma_t(-li, r[ci], a[ri][ci]);
      }
    }
  }

  // zc, zy to shared memory; mean(k) = zc(:, k) . zy and S(k, l) =
  // zc(:, k) . zc(:, l), a warp each
#pragma unroll
  for (int ri = 0; ri < RT; ++ri) {
    const int i = ri * TR + tr;
#pragma unroll
    for (int ci = 0; ci < CT; ++ci) {
      const int c = ci * TC + tc;
      if (ci * TC + TC - 1 >= M && i < M && c >= M && c < W)
        rhs[i * (O + 1) + c - M] = a[ri][ci];
    }
  }
  __syncthreads();
  T* mean_b = mean + b * mean_q;
  T* s_b = S + b * s_q;
  for (int t = warp; t < O + O * O; t += NW) {
    const int ca = t < O ? t : (t - O) / O;
    const int cb2 = t < O ? O : (t - O) % O;
    T acc = T(0);
    for (int i = lane; i < M; i += 32) acc += rhs[i * (O + 1) + ca] * rhs[i * (O + 1) + cb2];
    acc = warp_sum(acc);
    if (lane == 0) {
      if (t < O) mean_b[(long long)t * elem_stride] = acc;
      else s_b[(long long)(t - O) * elem_stride] = acc;
    }
  }
}

// the strides of both layouts: element stride, then the query strides of
// Kin, Kcross, y, mean and S
struct Strides {
  long long es, kin, kc, y, mean, s;
};
inline Strides strides_of(int m, int o, int B, int batch_last) {
  if (batch_last) return {B, 1, 1, 1, 1, 1};
  return {1, (long long)m * m, (long long)m * o, m, o, (long long)o * o};
}

template <typename T, int M, int O>
int launch_regs(const T* Kin, const T* Kcross, const T* y, T* mean, T* S, int B,
                const Strides& st, void* stream) {
  constexpr int NT = RegGeometry<T>::TR * RegGeometry<T>::TC;
  multiout_regs_kernel<T, M, O><<<B, NT, 0, (cudaStream_t)stream>>>(
      Kin, Kcross, y, mean, S, st.es, st.kin, st.kc, st.y, st.mean, st.s);
  return (int)cudaGetLastError();
}

// design 1: the register design, for the compiled (m, o); design 0: the
// shared-memory design for any shape that fits
template <typename T>
int launch(const T* Kin, const T* Kcross, const T* y, T* mean, T* S, int m, int o, int B,
           int batch_last, int design, void* stream) {
  if (B == 0) return 0;
  if (m < 1 || o < 1) return (int)cudaErrorInvalidValue;
  const Strides st = strides_of(m, o, B, batch_last);
  if (design == 1) {
    if (m == 90 && o == 3) return launch_regs<T, 90, 3>(Kin, Kcross, y, mean, S, B, st, stream);
    if constexpr (sizeof(T) == sizeof(float)) {
      if (m == 60 && o == 3) return launch_regs<T, 60, 3>(Kin, Kcross, y, mean, S, B, st, stream);
    }
    return (int)cudaErrorInvalidValue;  // not a compiled shape
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(T) * ((size_t)m * (m + o + 1) + m);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;  // one query does not fit
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        multiout_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  multiout_solve_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      Kin, Kcross, y, mean, S, m, o, st.es, st.kin, st.kc, st.y, st.mean, st.s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int multiout_solve_f32(const float* Kin, const float* Kcross, const float* y, float* mean,
                       float* S, int m, int o, int B, int batch_last, int design,
                       void* stream) {
  return launch<float>(Kin, Kcross, y, mean, S, m, o, B, batch_last, design, stream);
}

int multiout_solve_f64(const double* Kin, const double* Kcross, const double* y,
                       double* mean, double* S, int m, int o, int B, int batch_last,
                       int design, void* stream) {
  return launch<double>(Kin, Kcross, y, mean, S, m, o, B, batch_last, design, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
