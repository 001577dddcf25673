// K3: packed-key KNN candidate kernel, hand-written for Hopper.
//
// Replaces muygpys_tpu/pallas/knn.py:knn_pallas (_knn_body, _knn_tile_update)
// and, with a skip table, knn_pallas_pruned (_knn_body_pruned).  The contract
// is kept bit for bit:
//   d(q, col) = max((|q|^2 + |t|^2) - 2 (q . t), 0) in f32 (each product and
//   sum rounded on its own: no fused multiply-add, so the plain PyTorch
//   mirror in muygpys_torch/gpu/knn.py gives the same bits);
//   key = (bits(d) & ~chunk_mask) | chunk, chunk = col / bins;
//   per query and residue bin col % bins, the two smallest keys are kept
//   with integer min / max (start: sentinel 0x7F000000);
//   output s1, s2 (Q_pad, bins) int32.
// Pruned variant: train tile j is skipped for query tile i when
// lb[i, j] > ub[i] (the same conservative test as the TPU kernel).
//
// What bounds it on an H100: per (query, train column) it does 2 d + 2
// float operations and ~5 integer operations and moves nothing: the train
// set (50k x 2 f32 = 400 KB) stays in L2, and the only output is the
// 2 x Q x bins key state (33.5 MB at Q = 8192, bins = 512, ~10 us at
// 3.35 TB/s).  So it is bound by operations: ~4e8 distance evaluations per
// unpruned 8192-query bucket at 50k points.
//
// Design: the TPU held each query tile's state in a VMEM output block
// revisited across a sequential train-tile grid axis.  On Hopper a block
// owns 8 queries and a range of bins; thread t owns bin `bin` and walks every
// chunk of the train set, so neighbouring threads read neighbouring train
// columns (coalesced) and the 8 queries' two keys each stay in registers for
// the whole walk — the loop inside the block replaces the sequential grid
// axis, and the state is written once at the end.  Queries sit in shared
// memory (broadcast reads).  The pruning test is uniform across the block
// (its 8 queries lie in one query tile), so a skipped tile costs nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7F000000;
constexpr int kTQ = 8;  // queries per block

__global__ void knn_candidates_kernel(
    const float* __restrict__ q,    // (Q_pad, feat)
    const float* __restrict__ qsq,  // (Q_pad,)
    const float* __restrict__ tT,   // (feat, T_pad)
    const float* __restrict__ tsq,  // (T_pad,) padded columns hold 1e30
    const float* __restrict__ lb,   // (nq, nt) or null
    const float* __restrict__ ub,   // (nq,) or null
    int* __restrict__ s1, int* __restrict__ s2,  // (Q_pad, bins)
    int feat, int t_count, int bins, int train_tile, int query_tile,
    int chunk_mask) {
  extern __shared__ float sq[];  // [kTQ][feat] queries, then [kTQ] norms
  const int q0 = blockIdx.x * kTQ;
  const int bin = blockIdx.y * blockDim.x + threadIdx.x;
  for (int e = threadIdx.x; e < kTQ * feat; e += blockDim.x) sq[e] = q[(size_t)q0 * feat + e];
  if (threadIdx.x < kTQ) sq[kTQ * feat + threadIdx.x] = qsq[q0 + threadIdx.x];
  __syncthreads();
  const float* qn = sq + kTQ * feat;

  int k1[kTQ], k2[kTQ];
#pragma unroll
  for (int t = 0; t < kTQ; ++t) k1[t] = k2[t] = kSentinel;

  const int chunks_per_tile = train_tile / bins;
  const int nt = t_count / train_tile;
  const int qtile = q0 / query_tile;
  for (int j = 0; j < nt; ++j) {
    if (lb != nullptr && lb[(size_t)qtile * nt + j] > ub[qtile]) continue;
    for (int g = 0; g < chunks_per_tile; ++g) {
      const int chunk = j * chunks_per_tile + g;
      const int col = chunk * bins + bin;
      const float tn = tsq[col];
      float dot[kTQ];
      const float t0 = tT[col];
#pragma unroll
      for (int t = 0; t < kTQ; ++t) dot[t] = __fmul_rn(sq[t * feat], t0);
      for (int f = 1; f < feat; ++f) {
        const float tf = tT[(size_t)f * t_count + col];
#pragma unroll
        for (int t = 0; t < kTQ; ++t)
          dot[t] = __fadd_rn(dot[t], __fmul_rn(sq[t * feat + f], tf));
      }
#pragma unroll
      for (int t = 0; t < kTQ; ++t) {
        const float dist =
            fmaxf(__fsub_rn(__fadd_rn(qn[t], tn), __fmul_rn(2.0f, dot[t])), 0.0f);
        const int key = (__float_as_int(dist) & ~chunk_mask) | chunk;
        const int lo = min(key, k1[t]);
        k2[t] = min(max(key, k1[t]), k2[t]);
        k1[t] = lo;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    s1[(size_t)(q0 + t) * bins + bin] = k1[t];
    s2[(size_t)(q0 + t) * bins + bin] = k2[t];
  }
}

}  // namespace

extern "C" {

// q_count must be a multiple of query_tile, query_tile of 8, t_count of
// train_tile, train_tile of bins; bins must be <= 256 or a multiple of 256.
int knn_candidates(const float* q, const float* qsq, const float* tT, const float* tsq,
                   const float* lb, const float* ub, int* s1, int* s2, int q_count,
                   int feat, int t_count, int bins, int train_tile, int query_tile,
                   int chunk_mask, void* stream) {
  if (q_count == 0) return 0;
  const int threads = bins <= 256 ? bins : 256;
  if (bins % threads != 0 || q_count % kTQ != 0 || query_tile % kTQ != 0 ||
      train_tile % bins != 0 || t_count % train_tile != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(q_count / kTQ, bins / threads);
  const size_t bytes = sizeof(float) * kTQ * (feat + 1);
  knn_candidates_kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      q, qsq, tT, tsq, lb, ub, s1, s2, feat, t_count, bins, train_tile, query_tile,
      chunk_mask);
  return (int)cudaGetLastError();
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
