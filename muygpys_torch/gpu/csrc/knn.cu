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
//   with integer min / max (start: sentinel 0x7F000000).
// Pruned variant: train tile j is skipped for query tile i when
// lb[i, j] > ub[i] (the same conservative test as the TPU kernel).
//
// What bounds it on an H100: per (query, train column) it does 2 d + 2
// float operations and ~5 integer operations; the train set (50k x 2 f32 =
// 400 KB) stays in L2.  So it is bound by operations: ~4e8 distance
// evaluations per unpruned 8192-query bucket at 50k points.
//
// Two designs, one __global__ each, both variants in each; the launcher's
// caller picks (muygpys_torch/gpu/knn.py:knn_design).
//
// The fused design (knn_select_kernel, feat <= 4, k <= 64, bins in {256,
// 512, 1024}) also merges each query's 2 bins surviving keys (the keys
// design leaves that to torch.topk in the glue), and writes only the result:
// idx int64 and d2 f32 (Q, k), 12 bytes a slot, in place of the 2 x Q x
// bins int32 key state (33.5 MB at Q = 8192, 512 bins) and its read-back.
//   - A block owns 8 queries (one query tile holds them, so the skip test
//     stays uniform) and ALL their bins: thread t owns bins t + 256 i,
//     i < bins / 256.  feat and bins are template arguments, so each
//     thread keeps its queries' coordinates and norms and its bins' two
//     keys in registers for the whole walk.
//   - Each column's coordinates and norm are read once a thread, through
//     the read-only path from L2 (the 50k x 2 train set stays there), and
//     serve the thread's 8 queries (the keys design re-reads each query's
//     coordinates and norm from shared memory per pair).  Staging each
//     train tile in shared memory by double-buffered cp.async instead
//     measured 13-45% slower on an H100 at every main-path shape
//     (chip_variants.py), so the walk reads L2 directly.
//   - Selection, exact: after the walk the block writes its keys to shared
//     memory and warp w takes query w: its lanes hold the 2 bins keys in
//     registers, a 31-pass radix select over the key bits (non-negative
//     f32 distances with chunk bits order as integers) finds the k-th
//     smallest key v with one warp reduction a pass (the top 11 passes
//     count every key, the low 20 only the few keys compacted from v's
//     bucket of the top bits); the keys below v and,
//     in position order, as many keys equal to v as are missing are
//     compacted by ballots into a k-entry list; each entry's rank in
//     (key, position) order gives its output slot, so the result is in
//     ascending key order.  Keys equal to each other may come out in
//     another order than torch.topk's; the distances are the same bits.
//   - Decode as _merge_decode: index = chunk * bins + position % bins,
//     clamped to train_count - 1; a distance >= 1e29 (sentinel or padded
//     column) becomes +inf.
//
// The keys design (knn_candidates_kernel, kept for the shapes the fused
// design does not take): the TPU held each query tile's state in a VMEM
// output block revisited across a sequential train-tile grid axis.  On
// Hopper a block owns 8 queries and a range of bins; thread t owns bin
// `bin` and walks every chunk of the train set, so neighbouring threads read
// neighbouring train columns (coalesced) and the 8 queries' two keys each
// stay in registers for the whole walk; the state s1, s2 (Q_pad, bins) is
// written once at the end, and the glue merges it (_merge_decode).  Queries
// sit in shared memory (broadcast reads).

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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kTQ][feat] queries, [kTQ] norms
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

// ---- the fused design ----------------------------------------------------

constexpr int kThreads = 256;  // threads a block: 8 warps, one per query
constexpr int kMaxK = 64;      // the most neighbours the selection returns
constexpr int kSplit = 20;     // the radix select's low bits, counted on the bucket
static_assert(kThreads / 32 == kTQ, "one warp per query in the selection");

// shared memory of one block: the keys of its queries, then each warp's
// list of the k selected
__host__ __device__ inline size_t select_smem_bytes(int bins) {
  return sizeof(int) * (size_t)kTQ * 2 * bins + sizeof(int2) * kTQ * kMaxK;
}

template <int FEAT, int BPT>
__global__ void __launch_bounds__(kThreads) knn_select_kernel(
    const float* __restrict__ q,    // (Q_pad, FEAT)
    const float* __restrict__ qsq,  // (Q_pad,)
    const float* __restrict__ tT,   // (FEAT, T_pad)
    const float* __restrict__ tsq,  // (T_pad,) padded columns hold 1e30
    const float* __restrict__ lb,   // (nq, nt) or null
    const float* __restrict__ ub,   // (nq,) or null
    long long* __restrict__ out_idx, float* __restrict__ out_d2,  // (Q_pad, k)
    int t_count, int train_tile, int query_tile, int chunk_mask, int k,
    int train_count) {
  constexpr int BINS = BPT * kThreads;
  constexpr int KPL = 2 * BINS / 32;  // keys a lane holds in the selection
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTQ;

  float qc[kTQ][FEAT], qn[kTQ];
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
#pragma unroll
    for (int f = 0; f < FEAT; ++f) qc[t][f] = q[(size_t)(q0 + t) * FEAT + f];
    qn[t] = qsq[q0 + t];
  }
  int k1[kTQ][BPT], k2[kTQ][BPT];
#pragma unroll
  for (int t = 0; t < kTQ; ++t)
#pragma unroll
    for (int b = 0; b < BPT; ++b) k1[t][b] = k2[t][b] = kSentinel;

  const int nt = t_count / train_tile;
  const int qtile = q0 / query_tile;
  const int cpt = train_tile / BINS;  // chunks a tile
  for (int j = 0; j < nt; ++j) {
    if (lb != nullptr && lb[(size_t)qtile * nt + j] > ub[qtile]) continue;
    const float* tj = tT + (size_t)j * train_tile;
    const float* sj = tsq + (size_t)j * train_tile;
    for (int g = 0; g < cpt; ++g) {
      const int chunk = j * cpt + g;
#pragma unroll
      for (int b = 0; b < BPT; ++b) {
        const int col = g * BINS + b * kThreads + tid;
        float tf[FEAT];
#pragma unroll
        for (int f = 0; f < FEAT; ++f) tf[f] = __ldg(tj + (size_t)f * t_count + col);
        const float tn = __ldg(sj + col);
#pragma unroll
        for (int t = 0; t < kTQ; ++t) {
          float dot = __fmul_rn(qc[t][0], tf[0]);
#pragma unroll
          for (int f = 1; f < FEAT; ++f) dot = __fadd_rn(dot, __fmul_rn(qc[t][f], tf[f]));
          const float dist =
              fmaxf(__fsub_rn(__fadd_rn(qn[t], tn), __fmul_rn(2.0f, dot)), 0.0f);
          const int key = (__float_as_int(dist) & ~chunk_mask) | chunk;
          const int lo = min(key, k1[t][b]);
          k2[t][b] = min(max(key, k1[t][b]), k2[t][b]);
          k1[t][b] = lo;
        }
      }
    }
  }

  // keys of query t: [s1 of bins 0..BINS) | s2 of bins 0..BINS), the
  // order of the glue's torch.cat([s1, s2]), so position % BINS is the bin
  int* keys = reinterpret_cast<int*>(smem_raw);
#pragma unroll
  for (int t = 0; t < kTQ; ++t)
#pragma unroll
    for (int b = 0; b < BPT; ++b) {
      keys[t * 2 * BINS + b * kThreads + tid] = k1[t][b];
      keys[t * 2 * BINS + BINS + b * kThreads + tid] = k2[t][b];
    }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1u;
  int key[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) key[i] = keys[warp * 2 * BINS + i * 32 + lane];

  // radix select: v = the k-th smallest key, built from the top bit down
  // (bit 31 is 0 in every key); count(keys <= v) >= k > count(keys < v).
  // The bits down to kSplit count every key in registers; the keys that
  // share those bits with v (few: a bucket 2^-3 of v's size wide) are then
  // compacted into the warp's own row of `keys`, and the low bits count
  // only them against k less the keys below the bucket
  int v = 0;
  for (int bit = 30; bit >= kSplit; --bit) {
    const int cand = v | ((1 << bit) - 1);
    int c = 0;
#pragma unroll
    for (int i = 0; i < KPL; ++i) c += key[i] <= cand;
    if (__reduce_add_sync(full, c) < k) v |= 1 << bit;
  }
  const int lo = v, hi = v | ((1 << kSplit) - 1);
  int under = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) under += key[i] < lo;
  const int k_in = k - __reduce_add_sync(full, under);  // >= 1
  __syncwarp();  // every lane holds its keys: the warp's row is free
  int* bucket = keys + warp * 2 * BINS;
  int m = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const bool in = key[i] >= lo && key[i] <= hi;
    const unsigned in_mask = __ballot_sync(full, in);
    if (in) bucket[m + __popc(in_mask & below)] = key[i];
    m += __popc(in_mask);
  }
  __syncwarp();
  for (int bit = kSplit - 1; bit >= 0; --bit) {
    const int cand = v | ((1 << bit) - 1);
    int c = 0;
    for (int e = lane; e < m; e += 32) c += bucket[e] <= cand;
    if (__reduce_add_sync(full, c) < k_in) v |= 1 << bit;
  }
  int lt = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) lt += key[i] < v;
  int eq_left = k - __reduce_add_sync(full, lt);  // keys equal to v still to take

  // compact the k selected (key, position) pairs, in position order
  int2* list = reinterpret_cast<int2*>(keys + kTQ * 2 * BINS) + warp * kMaxK;
  int taken = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const bool is_eq = key[i] == v;
    const unsigned eq_mask = __ballot_sync(full, is_eq);
    const bool take = key[i] < v || (is_eq && __popc(eq_mask & below) < eq_left);
    const unsigned take_mask = __ballot_sync(full, take);
    if (take) list[taken + __popc(take_mask & below)] = make_int2(key[i], i * 32 + lane);
    taken += __popc(take_mask);
    eq_left -= __popc(eq_mask);
  }
  __syncwarp();

  // each entry's rank in (key, position) order is its output slot
  const size_t row = (size_t)(q0 + warp) * k;
  for (int e = lane; e < k; e += 32) {
    const int2 me = list[e];
    int rank = 0;
    for (int o = 0; o < k; ++o) {
      const int2 other = list[o];
      rank += other.x < me.x || (other.x == me.x && other.y < me.y);
    }
    long long idx = (long long)(me.x & chunk_mask) * BINS + (me.y & (BINS - 1));
    if (idx > train_count - 1) idx = train_count - 1;
    float d2 = __int_as_float(me.x & ~chunk_mask);
    if (d2 >= 1e29f) d2 = __int_as_float(0x7f800000);  // +inf
    out_idx[row + rank] = idx;
    out_d2[row + rank] = d2;
  }
}

constexpr size_t kMaxSmem = 232448;  // 227 KB a block can opt into on sm_90

template <int FEAT, int BPT>
int launch_select(const float* q, const float* qsq, const float* tT, const float* tsq,
                  const float* lb, const float* ub, long long* out_idx, float* out_d2,
                  int q_count, int t_count, int train_tile, int query_tile, int chunk_mask,
                  int k, int train_count, void* stream) {
  const size_t bytes = select_smem_bytes(BPT * kThreads);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_select_kernel<FEAT, BPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  knn_select_kernel<FEAT, BPT><<<q_count / kTQ, kThreads, bytes, (cudaStream_t)stream>>>(
      q, qsq, tT, tsq, lb, ub, out_idx, out_d2, t_count, train_tile, query_tile, chunk_mask, k,
      train_count);
  return (int)cudaGetLastError();
}

template <int FEAT>
int launch_select_bins(int bins, const float* q, const float* qsq, const float* tT,
                       const float* tsq, const float* lb, const float* ub, long long* out_idx,
                       float* out_d2, int q_count, int t_count, int train_tile, int query_tile,
                       int chunk_mask, int k, int train_count, void* stream) {
  auto go = bins == 256 ? launch_select<FEAT, 1>
                        : bins == 512 ? launch_select<FEAT, 2> : launch_select<FEAT, 4>;
  return go(q, qsq, tT, tsq, lb, ub, out_idx, out_d2, q_count, t_count, train_tile, query_tile,
            chunk_mask, k, train_count, stream);
}

}  // namespace

extern "C" {

// The keys design: q_count must be a multiple of query_tile, query_tile of 8, t_count of
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

// The fused design: the k nearest candidates per query, (Q_pad, k) idx int64
// and d2 f32 in ascending key order.  feat in 1..4, bins in {256, 512,
// 1024}, 1 <= k <= 64; q_count a multiple of query_tile, query_tile of 8,
// t_count of train_tile, train_tile of bins.
int knn_select(const float* q, const float* qsq, const float* tT, const float* tsq,
               const float* lb, const float* ub, long long* out_idx, float* out_d2,
               int q_count, int feat, int t_count, int bins, int train_tile, int query_tile,
               int chunk_mask, int k, int train_count, void* stream) {
  if (q_count == 0) return 0;
  if (feat < 1 || feat > 4 || (bins != 256 && bins != 512 && bins != 1024) || k < 1 ||
      k > kMaxK || q_count % query_tile != 0 || query_tile % kTQ != 0 ||
      train_tile % bins != 0 || t_count % train_tile != 0 || train_count < 1)
    return (int)cudaErrorInvalidValue;
  auto go = feat == 1   ? launch_select_bins<1>
            : feat == 2 ? launch_select_bins<2>
            : feat == 3 ? launch_select_bins<3>
                        : launch_select_bins<4>;
  return go(bins, q, qsq, tT, tsq, lb, ub, out_idx, out_d2, q_count, t_count, train_tile,
            query_tile, chunk_mask, k, train_count, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
