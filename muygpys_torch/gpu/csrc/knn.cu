// K3: packed-key KNN candidate kernel, hand-written for Hopper.
//
// Replaces muygpys_tpu/pallas/knn.py:knn_pallas (_knn_body, _knn_tile_update)
// and knn_pallas_pruned (_knn_body_pruned).  The contract is kept bit for
// bit:
//   d(q, col) = max((|q|^2 + |t|^2) - 2 (q . t), 0) in f32 (each product and
//   sum rounded on its own: no fused multiply-add, so the plain PyTorch
//   mirror in muygpys_torch/gpu/knn.py gives the same bits);
//   key = (bits(d) & ~chunk_mask) | chunk, chunk = col / bins;
//   per query and residue bin col % bins, the two smallest keys are kept
//   with integer min / max (start: sentinel 0x7F000000).
// Pruned, one way a design:
//   - the keys design (and the CPU's plain version) takes the skip table,
//     as the TPU kernel: train tile j is skipped for query tile i when
//     lb[i, j] > ub[i], ub from the unpruned search over a 1/16 row
//     subsample;
//   - the fused design takes the bounded route (knn_bounded_kernel): each
//     block of 8 queries bounds itself (below), and its candidates are
//     bit-equal to the unpruned fused kernel's (knn_select_kernel, which
//     takes no table).
//
// What bounds it on an H100: per (query, train column) it does 2 d + 2
// float operations and ~5 integer operations; the train set (50k x 2 f32 =
// 400 KB) stays in L2.  So the unpruned search is bound by operations: ~4e8
// distance evaluations per 8192-query bucket at 50k points.  Pruned, the
// data sets the work (~14 boxes of 256 columns a block of 8 queries on a
// uniform 10^6-point sky), and the fixed costs of a block (its selections,
// the pass over the boxes) weigh as much as the walk.
//
// Two designs, one __global__ each, and the fused design's bounded route a
// third; the launcher's caller picks (muygpys_torch/gpu/knn.py:knn_design).
//
// The fused design (knn_select_kernel, feat <= 4, k <= 64, bins in {256,
// 512, 1024}) also merges each query's 2 bins surviving keys (the keys
// design leaves that to torch.topk in the glue), and writes only the result:
// idx int64 and d2 f32 (Q, k), 12 bytes a slot, in place of the 2 x Q x
// bins int32 key state (33.5 MB at Q = 8192, 512 bins) and its read-back.
//   - A block owns 8 queries and ALL their bins: thread t owns bins
//     t + 256 i, i < bins / 256.  feat and bins are template arguments, so each
//     thread keeps its queries' coordinates and norms and its bins' two
//     keys in registers for the whole walk.
//   - Each column's coordinates and norm are read once a thread, through
//     the read-only path from L2 (the 50k x 2 train set stays there), and
//     serve the thread's 8 queries (the keys design re-reads each query's
//     coordinates and norm from shared memory per pair).  Staging each
//     train tile in shared memory by double-buffered cp.async instead
//     measured 13-45% slower on an H100 at every main-path shape, so the
//     walk reads L2 directly.
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
// The bounded route (knn_bounded_kernel): the walk, keys, selection and
// decode of the fused design, over boxes of kThreads columns: box j is one
// block-wide step of the walk (chunk j / BPT, the threads' bins
// (j % BPT) kThreads + tid) of the Morton-sorted train set, with its
// bounding box and its real columns' largest norm (knn.py:build_index).
// A block owns 8 Morton-consecutive queries:
//   1. Home: warp w finds the box holding query w's Morton code on the
//      index's grid (32 probes a step, as csrc/knn_exact.cu does), and the
//      block walks these boxes and the boxes on either side of each, each
//      once.  A box that straddles a jump of the curve spans two distant
//      runs of rows; a query on its short run would draw its tau from the
//      far one, and its block would walk every box within that tau (up to
//      a third of 3,912).  The rows that continue its run lie in the box
//      next to it.
//   2. tau: warp w runs the selection's top radix passes (bits 30 down to
//      kSplit) over query w's kept keys: v, the top bits of its k-th
//      smallest kept key; tau_w = __int_as_float(v | (2^kSplit - 1)), the
//      largest distance such a key can stand for (the chunk bits lie below
//      kSplit).  A walk only lowers each bin's two kept keys, so the k-th
//      smallest kept key never rises: tau_w bounds query w's final k-th key
//      from above.
//   3. The skip: each thread tests a strided share of the other boxes,
//      first against the block's query box and the largest tau, then
//      against each query and its own tau; a box that no query may reach is
//      skipped.  Survivors are compacted into a shared-memory list by
//      ballot (the list takes the place of the keys, already read), and the
//      block walks the list whenever it could overflow, and at the end.
//   4. The fused design's selection and decode.  Each block adds the
//      index's boxes and the boxes it walked to a device counter (two
//      atomics a block).
// On a uniform 10^6-point sky with 8192 uniform queries a block walks ~14
// of 3,912 boxes.
//
// Exactness.  Let K be a query's k-th smallest kept key after the bounded
// walk.  If every skipped column's key exceeds K, then in every bin the
// kept keys <= K are the same keys, in the same slots, as after the
// unpruned walk (a bin's keys <= K come from the same columns in both), and
// every other kept key exceeds K in both; there are at least k of them, so
// the selection takes the same k (key, position) pairs in both: the
// candidates are bit-equal to knn_select_kernel's.  A box is
// skipped only when, for every query of the block, each of its columns has
// a computed distance d > tau (shown below); then bits(d) > bits(tau) =
// v | (2^kSplit - 1) >= K_home | chunk_mask, so the key exceeds K_home, the
// k-th smallest kept key after the home walk, which is >= K.  Padded columns
// (norm 1e30) have d ~ 1e30 > tau whenever a box is skipped (tau < lb, and
// squared coordinates stay far below 1e29, as the sentinel scheme assumes).
//
// Allowance.  With u = 2^-24, gamma = F u / (1 - F u) (F features), the
// exact Q = |q|^2, T = |t|^2, D = |q - t|^2, and the glue's norms qn, tn
// (rounded squares summed, any order) and the kernel's dot (rounded products
// summed in feature order): qn = Q (1 + a), tn = T (1 + b), |a|, |b| <= gamma;
// dot = q . t + e, |e| <= gamma sum |q_f t_f| <= gamma (Q + T) / 2.  So
// rn(qn + tn) - 2 dot lies within (2 gamma + u (1 + gamma)) (Q + T) of D, and
// after the last rounding and max(., 0)
//   d >= (1 - u) D - (1 + u)(2 gamma + u (1 + gamma)) (Q + T)
//     >= (1 - u) D - A,   A = (2 F + 2) u (qn + tn_box) + 2^-120,
// since Q + T <= (qn + tn_box) / (1 - gamma) and (1 + u)(2 gamma + u (1 +
// gamma)) / (1 - gamma) < (2 F + 2) u for F <= 4; tn_box is the box's largest
// norm, and 2^-120 covers the absolute rounding of subnormal products.  The
// box's bound lb = sum_f g_f^2, g_f = max(lo_f - q_f, q_f - hi_f, 0) (for the
// query box, its corners in place of q), is <= D for every column of the
// box; computed in double its relative error is < 2^-50.  A box is skipped
// when lb > (tau + A) (1 + 2^-20) in double: then
//   (1 - u) D - A >= (1 - u)(1 - 2^-50) lb - A > tau,
// the margin 2^-20 absorbing the test's own double rounding.  So d > tau
// for every column of a skipped box, as the exactness argument needs.
// (tests/test_torch_cuda_emulation_knn_bounded.py holds a column at this
// edge: its d lies under tau while its box's exact bound lies over it.)
//
// The queries' order (knn_query_order_kernel): the bounded route's query
// side, the queries along their own Morton curve, in one launch of one
// block, in place of the glue's plain PyTorch (knn.py:_sorted_queries: the
// grid, the codes' bit interleave one bit a kernel, a stable radix sort,
// the gather and edge pad; and knn_cuda_pruned's inverse argsort), about
// 100 nodes of a captured bucket.  It replaces no TPU kernel: the JAX
// package sorts the queries with XLA.  At 8192 x 2 the work is 16 K
// quantised coordinates and 3 passes over 8192 slots: a few hundred KB
// and no arithmetic to speak of, so one SM's issue rate and shared memory
// bound it (0.041 ms on an H100, against the glue's ~0.19 ms of device
// time and its launches).  A
// block of 32 to 1024 threads holds the queries in shared memory, warp w
// slots w 256 + 32 r + lane for rounds r < 8, so (warp, round, lane) is
// slot order:
//   1. The grid of _morton_grid: each feature's min and max by warp
//      shuffles, then across the warps; scale = (2^bits - 1) / max(hi -
//      lo, 1e-30) in IEEE division, as PyTorch's tensor / tensor.
//   2. The codes of _morton_codes: (x - lo) * scale, each operation rounded
//      on its own, clamped to [0, 2^bits - 1], truncated, bits interleaved;
//      an empty slot's key lies above every code.
//   3. A stable LSD radix sort of (code, slot) over the code's bits, 8 a
//      pass: each warp ranks its slots among its earlier slots of the same
//      digit (a ballot a digit bit, a round), the block scans the (digit,
//      warp) counts digit-major, and a slot moves to its digit's offset plus its
//      warp's plus its rank.  Equal codes keep slot order, so the
//      permutation is torch.argsort(stable=True)'s bit for bit.
//   4. The sorted rows edge-padded to `rows`, the permutation and its
//      inverse (qinv[qperm[i]] = i).
// The queries' norms stay with the glue (torch.sum), whose order of
// addition at 3 or 4 features on a card is its own (knn_exact.py).
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
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads / 32 == kTQ, "one warp per query in the selection");

// shared memory of one block: the keys of its queries, then each warp's
// list of the k selected
__host__ __device__ inline size_t select_smem_bytes(int bins) {
  return sizeof(int) * (size_t)kTQ * 2 * bins + sizeof(int2) * kTQ * kMaxK;
}

// One step of the walk: column col (of chunk `chunk`, the thread's bin
// b kThreads + tid) scored against the block's queries into each query's two
// smallest keys of that bin.
template <int FEAT, int BPT>
__device__ __forceinline__ void score_column(const float (&qc)[kTQ][FEAT], const float (&qn)[kTQ],
                                             int (&k1)[kTQ][BPT], int (&k2)[kTQ][BPT], int b,
                                             const float* __restrict__ tT,
                                             const float* __restrict__ tsq, size_t t_count,
                                             int col, int chunk, int chunk_mask) {
  float tf[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) tf[f] = __ldg(tT + f * t_count + col);
  const float tn = __ldg(tsq + col);
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    float dot = __fmul_rn(qc[t][0], tf[0]);
#pragma unroll
    for (int f = 1; f < FEAT; ++f) dot = __fadd_rn(dot, __fmul_rn(qc[t][f], tf[f]));
    const float dist = fmaxf(__fsub_rn(__fadd_rn(qn[t], tn), __fmul_rn(2.0f, dot)), 0.0f);
    const int key = (__float_as_int(dist) & ~chunk_mask) | chunk;
    const int lo = min(key, k1[t][b]);
    k2[t][b] = min(max(key, k1[t][b]), k2[t][b]);
    k1[t][b] = lo;
  }
}

// The block's queries (rows q0 .. q0 + kTQ) and norms into registers, and
// every kept key at the sentinel.
template <int FEAT, int BPT>
__device__ __forceinline__ void start_block(const float* __restrict__ q,
                                            const float* __restrict__ qsq, int q0,
                                            float (&qc)[kTQ][FEAT], float (&qn)[kTQ],
                                            int (&k1)[kTQ][BPT], int (&k2)[kTQ][BPT]) {
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
#pragma unroll
    for (int f = 0; f < FEAT; ++f) qc[t][f] = q[(size_t)(q0 + t) * FEAT + f];
    qn[t] = qsq[q0 + t];
  }
#pragma unroll
  for (int t = 0; t < kTQ; ++t)
#pragma unroll
    for (int b = 0; b < BPT; ++b) k1[t][b] = k2[t][b] = kSentinel;
}

// Every thread's keys to shared memory, then warp w's lanes load query w's:
// [s1 of bins 0..BINS) | s2 of bins 0..BINS), the order of the glue's
// torch.cat([s1, s2]), so position % BINS is the bin.  Ends with the keys
// in `key`; the block's row of `keys` stays as written.
template <int BPT>
__device__ __forceinline__ void gather_keys(int* keys, const int (&k1)[kTQ][BPT],
                                            const int (&k2)[kTQ][BPT], int tid,
                                            int (&key)[2 * BPT * kThreads / 32]) {
  constexpr int BINS = BPT * kThreads;
#pragma unroll
  for (int t = 0; t < kTQ; ++t)
#pragma unroll
    for (int b = 0; b < BPT; ++b) {
      keys[t * 2 * BINS + b * kThreads + tid] = k1[t][b];
      keys[t * 2 * BINS + BINS + b * kThreads + tid] = k2[t][b];
    }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < 2 * BPT * kThreads / 32; ++i) key[i] = keys[warp * 2 * BINS + i * 32 + lane];
}

// The top bits (30 down to kSplit) of the k-th smallest of the warp's keys
// (bit 31 is 0 in every key); count(keys <= v | (2^kSplit - 1)) >= k >
// count(keys < v).
template <int KPL>
__device__ __forceinline__ int radix_top(const int (&key)[KPL], int k) {
  int v = 0;
  for (int bit = 30; bit >= kSplit; --bit) {
    const int cand = v | ((1 << bit) - 1);
    int c = 0;
#pragma unroll
    for (int i = 0; i < KPL; ++i) c += key[i] <= cand;
    if (__reduce_add_sync(kFull, c) < k) v |= 1 << bit;
  }
  return v;
}

// The selection and decode of every query of the block, after its walk:
// warp w writes query w's k candidates to rows q0 + w of out_idx, out_d2.
template <int BPT>
__device__ __forceinline__ void select_and_write(int* keys, const int (&k1)[kTQ][BPT],
                                                 const int (&k2)[kTQ][BPT], int tid, int q0,
                                                 long long* __restrict__ out_idx,
                                                 float* __restrict__ out_d2, int chunk_mask,
                                                 int k, int train_count) {
  constexpr int BINS = BPT * kThreads;
  constexpr int KPL = 2 * BINS / 32;  // keys a lane holds in the selection
  const int warp = tid / 32, lane = tid % 32;
  const unsigned below = (1u << lane) - 1u;
  int key[KPL];
  gather_keys<BPT>(keys, k1, k2, tid, key);

  // radix select: v = the k-th smallest key, built from the top bit down.
  // The bits down to kSplit count every key in registers; the keys that
  // share those bits with v (few: a bucket 2^-3 of v's size wide) are then
  // compacted into the warp's own row of `keys`, and the low bits count
  // only them against k less the keys below the bucket
  int v = radix_top<KPL>(key, k);
  const int lo = v, hi = v | ((1 << kSplit) - 1);
  int under = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) under += key[i] < lo;
  const int k_in = k - __reduce_add_sync(kFull, under);  // >= 1
  __syncwarp();  // every lane holds its keys: the warp's row is free
  int* bucket = keys + warp * 2 * BINS;
  int m = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const bool in = key[i] >= lo && key[i] <= hi;
    const unsigned in_mask = __ballot_sync(kFull, in);
    if (in) bucket[m + __popc(in_mask & below)] = key[i];
    m += __popc(in_mask);
  }
  __syncwarp();
  for (int bit = kSplit - 1; bit >= 0; --bit) {
    const int cand = v | ((1 << bit) - 1);
    int c = 0;
    for (int e = lane; e < m; e += 32) c += bucket[e] <= cand;
    if (__reduce_add_sync(kFull, c) < k_in) v |= 1 << bit;
  }
  int lt = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) lt += key[i] < v;
  int eq_left = k - __reduce_add_sync(kFull, lt);  // keys equal to v still to take

  // compact the k selected (key, position) pairs, in position order
  int2* list = reinterpret_cast<int2*>(keys + kTQ * 2 * BINS) + warp * kMaxK;
  int taken = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const bool is_eq = key[i] == v;
    const unsigned eq_mask = __ballot_sync(kFull, is_eq);
    const bool take = key[i] < v || (is_eq && __popc(eq_mask & below) < eq_left);
    const unsigned take_mask = __ballot_sync(kFull, take);
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

template <int FEAT, int BPT>
__global__ void __launch_bounds__(kThreads) knn_select_kernel(
    const float* __restrict__ q,    // (Q_pad, FEAT)
    const float* __restrict__ qsq,  // (Q_pad,)
    const float* __restrict__ tT,   // (FEAT, T_pad)
    const float* __restrict__ tsq,  // (T_pad,) padded columns hold 1e30
    long long* __restrict__ out_idx, float* __restrict__ out_d2,  // (Q_pad, k)
    int t_count, int chunk_mask, int k, int train_count) {
  constexpr int BINS = BPT * kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTQ;
  float qc[kTQ][FEAT], qn[kTQ];
  int k1[kTQ][BPT], k2[kTQ][BPT];
  start_block<FEAT, BPT>(q, qsq, q0, qc, qn, k1, k2);
  for (int chunk = 0; chunk < t_count / BINS; ++chunk) {
#pragma unroll
    for (int b = 0; b < BPT; ++b)
      score_column<FEAT, BPT>(qc, qn, k1, k2, b, tT, tsq, t_count,
                              chunk * BINS + b * kThreads + tid, chunk, chunk_mask);
  }
  select_and_write<BPT>(reinterpret_cast<int*>(smem_raw), k1, k2, tid, q0, out_idx, out_d2,
                        chunk_mask, k, train_count);
}

// ---- the bounded route ---------------------------------------------------

// The index's boxes (muygpys_torch/gpu/knn.py:Boxes), as the kernel reads them.
struct Boxes {
  const float* box;             // (2 FEAT, nb): lower corners, then upper
  const float* norm;            // (nb,) largest norm of the box's real columns
  const int* first;             // (nb,) Morton code of the box's first row
  const float* grid;            // (2 FEAT,) the curve's origin, then its scale
  unsigned long long* counts;   // (2,) boxes of the index, boxes walked; added to
  int nb, bits;
};

constexpr double kU = 1.0 / 16777216.0;            // 2^-24
constexpr double kTiny = 7.52316384526264e-37;     // 2^-120
constexpr double kMargin = 1.0 + 1.0 / 1048576.0;  // 1 + 2^-20

// Whether every column of a box lies beyond tau for a point (or a box of
// points) with norm qn: the box's bound lb against tau plus the allowance
// (header: Allowance).
template <int FEAT>
__device__ __forceinline__ bool beyond(const float (&plo)[FEAT], const float (&phi)[FEAT],
                                       const float (&lo)[FEAT], const float (&hi)[FEAT],
                                       float tau, float qn, float tn) {
  double lb = 0.0;
#pragma unroll
  for (int f = 0; f < FEAT; ++f) {
    const double g =
        fmax(fmax((double)lo[f] - (double)phi[f], (double)plo[f] - (double)hi[f]), 0.0);
    lb += g * g;
  }
  const double allow = (2 * FEAT + 2) * kU * ((double)qn + (double)tn) + kTiny;
  return lb > ((double)tau + allow) * kMargin;
}

// Walk box j: the thread's column j kThreads + tid, state slot j % BPT.
template <int FEAT, int BPT>
__device__ __forceinline__ void walk_box(const float (&qc)[kTQ][FEAT], const float (&qn)[kTQ],
                                         int (&k1)[kTQ][BPT], int (&k2)[kTQ][BPT],
                                         const float* __restrict__ tT,
                                         const float* __restrict__ tsq, size_t t_count, int j,
                                         int tid, int chunk_mask) {
  const int slot = j % BPT;
#pragma unroll
  for (int b = 0; b < BPT; ++b)
    if (b == slot)
      score_column<FEAT, BPT>(qc, qn, k1, k2, b, tT, tsq, t_count, j * kThreads + tid, j / BPT,
                              chunk_mask);
}

// shared memory of one block: the fused design's, then each query's home
// box and tau, and the box list's length
__host__ __device__ inline size_t bounded_smem_bytes(int bins) {
  return select_smem_bytes(bins) + sizeof(int) * (2 * kTQ + 1);
}

// CAP: the box list's entries (0, the default: the keys' room, kTQ 2 BINS);
// a smaller list is walked more often inside the loop
template <int FEAT, int BPT, int CAP = 0>
__global__ void __launch_bounds__(kThreads) knn_bounded_kernel(
    const float* __restrict__ q,    // (Q_pad, FEAT), Morton-sorted
    const float* __restrict__ qsq,  // (Q_pad,)
    const float* __restrict__ tT,   // (FEAT, T_pad), Morton-sorted
    const float* __restrict__ tsq,  // (T_pad,) padded columns hold 1e30
    Boxes boxes, long long* __restrict__ out_idx, float* __restrict__ out_d2,  // (Q_pad, k)
    int t_count, int chunk_mask, int k, int train_count) {
  constexpr int BINS = BPT * kThreads;
  constexpr int KPL = 2 * BINS / 32;
  constexpr int kCap = CAP ? CAP : kTQ * 2 * BINS;  // the box list, in the keys' place
  static_assert(kThreads <= kCap && kCap <= kTQ * 2 * BINS, "a round's survivors must fit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* keys = reinterpret_cast<int*>(smem_raw);
  int* home = reinterpret_cast<int*>(smem_raw + select_smem_bytes(BINS));  // [kTQ]
  float* taus = reinterpret_cast<float*>(home + kTQ);                      // [kTQ]
  int* listed = home + 2 * kTQ;                                             // the list's length
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned below = (1u << lane) - 1u;
  const int q0 = blockIdx.x * kTQ;
  const int nb = boxes.nb;
  float qc[kTQ][FEAT], qn[kTQ];
  int k1[kTQ][BPT], k2[kTQ][BPT];
  start_block<FEAT, BPT>(q, qsq, q0, qc, qn, k1, k2);

  // 1. home: the box holding query `warp`'s Morton code, quantised as
  // _morton_codes quantises the rows: the last box whose first code is <=
  // the query's (box 0 if none), 32 probes a step
  {
    const float top = (float)((1 << boxes.bits) - 1);
    int code = 0;
#pragma unroll
    for (int f = 0; f < FEAT; ++f) {
      const float x = __ldg(q + (size_t)(q0 + warp) * FEAT + f);
      const float c = __fmul_rn(__fsub_rn(x, __ldg(boxes.grid + f)), __ldg(boxes.grid + FEAT + f));
      const int cell = (int)fminf(fmaxf(c, 0.0f), top);
      for (int b = 0; b < boxes.bits; ++b) code |= ((cell >> b) & 1) << (b * FEAT + f);
    }
    int lo = 0, hi = nb;
    while (hi - lo > 1) {
      const int step = (hi - lo + 31) / 32;
      const int p = lo + lane * step;
      const unsigned under = __ballot_sync(kFull, p < hi && __ldg(boxes.first + p) <= code);
      if (under == 0) break;
      lo += (__popc(under) - 1) * step;
      hi = min(lo + step, hi);
    }
    if (lane == 0) home[warp] = lo;
  }
  __syncthreads();
  // the home walk: box home[i / 3] - 1 + i % 3 for i < 3 kTQ, where it is in
  // range and not walked for an earlier query; each warp finds the same
  // boxes by one ballot (lane i tests candidate i), and one loop, not
  // unrolled, walks them (nested loops over t and the three boxes, unrolled,
  // took 210 registers in place of 128 on an H100 and slowed every walk)
  static_assert(3 * kTQ <= 32, "a lane a candidate box");
  unsigned todo;
  {
    const int t = min(lane / 3, kTQ - 1), j = home[t] - 1 + lane % 3;
    bool take = lane < 3 * kTQ && j >= 0 && j < nb;
    for (int u = 0; u < t; ++u) take &= abs(home[u] - j) > 1;
    todo = __ballot_sync(kFull, take);
  }
  int walked = 0;
#pragma unroll 1
  for (; todo != 0u; todo &= todo - 1u) {
    const int i = __ffs(todo) - 1;
    walk_box<FEAT, BPT>(qc, qn, k1, k2, tT, tsq, t_count, home[i / 3] - 1 + i % 3, tid,
                        chunk_mask);
    ++walked;
  }

  // 2. tau of each query: the top bits of its k-th smallest kept key
  {
    int key[KPL];
    gather_keys<BPT>(keys, k1, k2, tid, key);
    const int v = radix_top<KPL>(key, k);
    if (lane == 0) taus[warp] = __int_as_float(v | ((1 << kSplit) - 1));
  }
  if (tid == 0) *listed = 0;
  __syncthreads();  // the keys are read: the box list takes their place
  float tau[kTQ], qlo[FEAT], qhi[FEAT];
  float tau_max = 0.0f, qn_max = 0.0f;
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    tau[t] = taus[t];
    tau_max = fmaxf(tau_max, tau[t]);
    qn_max = fmaxf(qn_max, qn[t]);
  }
#pragma unroll
  for (int f = 0; f < FEAT; ++f) {
    qlo[f] = qhi[f] = qc[0][f];
#pragma unroll
    for (int t = 1; t < kTQ; ++t) {
      qlo[f] = fminf(qlo[f], qc[t][f]);
      qhi[f] = fmaxf(qhi[f], qc[t][f]);
    }
  }

  // 3. the skip: survivors listed by ballot, the list walked when it could
  // overflow in the next round, and at the end
  int* list = keys;
  for (int base = 0; base < nb; base += kThreads) {
    const int j = base + tid;
    bool keep = j < nb;
    for (int t = 0; keep && t < kTQ; ++t) keep = abs(home[t] - j) > 1;
    if (keep) {
      float lo[FEAT], hi[FEAT];
#pragma unroll
      for (int f = 0; f < FEAT; ++f) {
        lo[f] = __ldg(boxes.box + (size_t)f * nb + j);
        hi[f] = __ldg(boxes.box + (size_t)(FEAT + f) * nb + j);
      }
      const float tn = __ldg(boxes.norm + j);
      keep = !beyond<FEAT>(qlo, qhi, lo, hi, tau_max, qn_max, tn);
      if (keep) {
        bool reached = false;
#pragma unroll
        for (int t = 0; t < kTQ; ++t)
          reached |= !beyond<FEAT>(qc[t], qc[t], lo, hi, tau[t], qn[t], tn);
        keep = reached;
      }
    }
    const unsigned mask = __ballot_sync(kFull, keep);
    int at = 0;
    if (lane == 0 && mask != 0u) at = atomicAdd(listed, __popc(mask));
    at = __shfl_sync(kFull, at, 0);
    if (keep) list[at + __popc(mask & below)] = j;
    __syncthreads();  // the round's survivors are listed
    const int n = *listed;
    __syncthreads();  // every thread has read the length
    if (n > kCap - kThreads || base + kThreads >= nb) {
      if (tid == 0) *listed = 0;
      for (int i = 0; i < n; ++i)
        walk_box<FEAT, BPT>(qc, qn, k1, k2, tT, tsq, t_count, list[i], tid, chunk_mask);
      walked += n;
      __syncthreads();  // the list is read before it is filled again
    }
  }
  if (tid == 0) {
    atomicAdd(boxes.counts, (unsigned long long)nb);
    atomicAdd(boxes.counts + 1, (unsigned long long)walked);
  }

  // 4. the fused design's selection and decode
  select_and_write<BPT>(keys, k1, k2, tid, q0, out_idx, out_d2, chunk_mask, k, train_count);
}

constexpr size_t kMaxSmem = 232448;  // 227 KB a block can opt into on sm_90

// Opt kernel into `bytes` of dynamic shared memory where it needs more than
// the default 48 KB.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int FEAT, int BPT>
int launch_select(const float* q, const float* qsq, const float* tT, const float* tsq,
                  long long* out_idx, float* out_d2, int q_count, int t_count, int chunk_mask,
                  int k, int train_count, void* stream) {
  const size_t bytes = select_smem_bytes(BPT * kThreads);
  const int err = allow_smem(knn_select_kernel<FEAT, BPT>, bytes);
  if (err != (int)cudaSuccess) return err;
  knn_select_kernel<FEAT, BPT><<<q_count / kTQ, kThreads, bytes, (cudaStream_t)stream>>>(
      q, qsq, tT, tsq, out_idx, out_d2, t_count, chunk_mask, k, train_count);
  return (int)cudaGetLastError();
}

template <int FEAT>
int launch_select_bins(int bins, const float* q, const float* qsq, const float* tT,
                       const float* tsq, long long* out_idx, float* out_d2, int q_count,
                       int t_count, int chunk_mask, int k, int train_count, void* stream) {
  auto go = bins == 256 ? launch_select<FEAT, 1>
                        : bins == 512 ? launch_select<FEAT, 2> : launch_select<FEAT, 4>;
  return go(q, qsq, tT, tsq, out_idx, out_d2, q_count, t_count, chunk_mask, k, train_count,
            stream);
}

template <int FEAT, int BPT, int CAP>
int launch_bounded(const float* q, const float* qsq, const float* tT, const float* tsq,
                   Boxes boxes, long long* out_idx, float* out_d2, int q_count, int t_count,
                   int chunk_mask, int k, int train_count, void* stream) {
  const size_t bytes = bounded_smem_bytes(BPT * kThreads);
  const int err = allow_smem(knn_bounded_kernel<FEAT, BPT, CAP>, bytes);
  if (err != (int)cudaSuccess) return err;
  knn_bounded_kernel<FEAT, BPT, CAP><<<q_count / kTQ, kThreads, bytes, (cudaStream_t)stream>>>(
      q, qsq, tT, tsq, boxes, out_idx, out_d2, t_count, chunk_mask, k, train_count);
  return (int)cudaGetLastError();
}

template <int FEAT, int CAP>
int launch_bounded_bins(int bins, const float* q, const float* qsq, const float* tT,
                        const float* tsq, Boxes boxes, long long* out_idx, float* out_d2,
                        int q_count, int t_count, int chunk_mask, int k, int train_count,
                        void* stream) {
  auto go = bins == 256   ? launch_bounded<FEAT, 1, CAP>
            : bins == 512 ? launch_bounded<FEAT, 2, CAP>
                          : launch_bounded<FEAT, 4, CAP>;
  return go(q, qsq, tT, tsq, boxes, out_idx, out_d2, q_count, t_count, chunk_mask, k,
            train_count, stream);
}

// knn_bounded's checks and dispatch, with the box list's CAP (knn_bounded_kernel)
template <int CAP>
int bounded(const float* q, const float* qsq, const float* tT, const float* tsq,
            const float* box, const float* norm, const int* first, const float* grid,
            long long* out_idx, float* out_d2, long long* counts, int q_count, int feat,
            int t_count, int bins, int nb, int bits, int chunk_mask, int k,
            int train_count, void* stream) {
  if (q_count == 0) return 0;
  if (feat < 1 || feat > 4 || (bins != 256 && bins != 512 && bins != 1024) || k < 1 ||
      k > kMaxK || q_count % kTQ != 0 || t_count % bins != 0 || nb != t_count / kThreads ||
      bits < 1 || bits * feat > 30 || train_count < 1)
    return (int)cudaErrorInvalidValue;
  const Boxes boxes{box, norm, first, grid, (unsigned long long*)counts, nb, bits};
  auto go = feat == 1   ? launch_bounded_bins<1, CAP>
            : feat == 2 ? launch_bounded_bins<2, CAP>
            : feat == 3 ? launch_bounded_bins<3, CAP>
                        : launch_bounded_bins<4, CAP>;
  return go(bins, q, qsq, tT, tsq, boxes, out_idx, out_d2, q_count, t_count, chunk_mask, k,
            train_count, stream);
}

// ---- the queries' order --------------------------------------------------

constexpr int kOrderThreads = 1024;                     // the most threads of its block
constexpr int kOrderItems = 8;                          // slots a lane
constexpr int kOrderCap = kOrderThreads * kOrderItems;  // the most queries a launch orders
constexpr int kDigitBits = 8;                           // code bits a pass
constexpr int kDigits = 1 << kDigitBits;
constexpr int kEmpty = 0x7fffffff;  // an empty slot's key: above every 30-bit code

// shared memory of the order's block of `threads`: keys and slots twice
// (each pass reads one copy and writes the other), each warp's digit
// counts, the digits' offsets, each warp's per-feature min and max
__host__ __device__ inline size_t order_smem_bytes(int threads) {
  const size_t n = (size_t)threads * kOrderItems, warps = threads / 32;
  return sizeof(int) * (4 * n + warps * kDigits + kDigits) + sizeof(float) * warps * 8;
}

// The lanes of the warp whose digit equals this lane's, by one ballot a
// digit bit (MATCH.ANY, __match_any_sync, measured slower on an H100)
__device__ __forceinline__ unsigned digit_peers(int digit) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    const unsigned ones = __ballot_sync(kFull, (digit >> b) & 1);
    peers &= (digit >> b) & 1 ? ones : ~ones;
  }
  return peers;
}

template <int FEAT>
__global__ void __launch_bounds__(kOrderThreads) knn_query_order_kernel(
    const float* __restrict__ q,  // (q_count, FEAT)
    float* __restrict__ q_pad,    // (rows, FEAT)
    long long* __restrict__ qperm, long long* __restrict__ qinv,  // (q_count,)
    int q_count, int rows) {
  // knn.py:_morton_grid's bits: 10 a feature, capped so that a code fits 30
  constexpr int kBits = 30 / FEAT < 10 ? 30 / FEAT : 10;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x / 32, n = blockDim.x * kOrderItems;
  const unsigned below = (1u << lane) - 1u;
  int* keys = reinterpret_cast<int*>(smem_raw);               // [2][n]
  int* slots = keys + 2 * n;                                  // [2][n]
  int* counts = slots + 2 * n;                                // [warps][kDigits]
  int* offset = counts + warps * kDigits;                     // [kDigits]
  float* ext = reinterpret_cast<float*>(offset + kDigits);    // [warps][min 4, max 4]
  const int first = warp * 32 * kOrderItems + lane;           // the lane's slot in round 0

  // 1. the grid
  float lo[FEAT], hi[FEAT], scale[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) {
    lo[f] = __int_as_float(0x7f800000);   // +inf
    hi[f] = __int_as_float(0xff800000);   // -inf
  }
#pragma unroll
  for (int r = 0; r < kOrderItems; ++r) {
    const int s = first + 32 * r;
    if (s < q_count)
#pragma unroll
      for (int f = 0; f < FEAT; ++f) {
        const float x = __ldg(q + (size_t)s * FEAT + f);
        lo[f] = fminf(lo[f], x);
        hi[f] = fmaxf(hi[f], x);
      }
  }
#pragma unroll
  for (int f = 0; f < FEAT; ++f) {
    for (int o = 16; o > 0; o /= 2) {
      lo[f] = fminf(lo[f], __shfl_xor_sync(kFull, lo[f], o));
      hi[f] = fmaxf(hi[f], __shfl_xor_sync(kFull, hi[f], o));
    }
    if (lane == 0) {
      ext[warp * 8 + f] = lo[f];
      ext[warp * 8 + 4 + f] = hi[f];
    }
  }
  __syncthreads();
  const float top = (float)((1 << kBits) - 1);
#pragma unroll
  for (int f = 0; f < FEAT; ++f) {
    for (int w = 0; w < warps; ++w) {
      lo[f] = fminf(lo[f], ext[w * 8 + f]);
      hi[f] = fmaxf(hi[f], ext[w * 8 + 4 + f]);
    }
    scale[f] = __fdiv_rn(top, fmaxf(__fsub_rn(hi[f], lo[f]), 1e-30f));
  }

  // 2. the codes
#pragma unroll
  for (int r = 0; r < kOrderItems; ++r) {
    const int s = first + 32 * r;
    int key = kEmpty;
    if (s < q_count) {
      key = 0;
#pragma unroll
      for (int f = 0; f < FEAT; ++f) {
        const float c = __fmul_rn(__fsub_rn(__ldg(q + (size_t)s * FEAT + f), lo[f]), scale[f]);
        const int cell = __float2int_rz(fminf(fmaxf(c, 0.0f), top));
#pragma unroll
        for (int b = 0; b < kBits; ++b) key |= ((cell >> b) & 1) << (b * FEAT + f);
      }
    }
    keys[s] = key;
    slots[s] = s;
  }

  // 3. the sort, kDigitBits of the code a pass
  int src = 0;
  int* mine = counts + warp * kDigits;
#pragma unroll
  for (int shift = 0; shift < kBits * FEAT; shift += kDigitBits) {
    const int* key_in = keys + src * n;
    const int* slot_in = slots + src * n;
    int* key_out = keys + (1 - src) * n;
    int* slot_out = slots + (1 - src) * n;
    for (int e = tid; e < warps * kDigits; e += blockDim.x) counts[e] = 0;
    __syncthreads();
    int key[kOrderItems], slot[kOrderItems], rank[kOrderItems];
#pragma unroll
    for (int r = 0; r < kOrderItems; ++r) {
      key[r] = key_in[first + 32 * r];
      slot[r] = slot_in[first + 32 * r];
      const int digit = (key[r] >> shift) & (kDigits - 1);
      const unsigned peers = digit_peers(digit);
      const int before = mine[digit];
      rank[r] = before + __popc(peers & below);
      __syncwarp();  // every peer has read the count
      if ((peers & below) == 0u) mine[digit] = before + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // a digit's slots follow every smaller digit's; within a digit, warp
    // w's follow the warps' before it
    for (int dg = tid; dg < kDigits; dg += blockDim.x) {
      int run = 0;
      for (int w = 0; w < warps; ++w) {
        const int c = counts[w * kDigits + dg];
        counts[w * kDigits + dg] = run;
        run += c;
      }
      offset[dg] = run;
    }
    __syncthreads();
    if (warp == 0) {  // the digits' totals to their exclusive prefix sums
      constexpr int kPer = kDigits / 32;
      int total[kPer], sum = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        total[i] = offset[lane * kPer + i];
        sum += total[i];
      }
      int incl = sum;
      for (int o = 1; o < 32; o *= 2) {
        const int up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
      }
      int run = incl - sum;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        offset[lane * kPer + i] = run;
        run += total[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kOrderItems; ++r) {
      const int digit = (key[r] >> shift) & (kDigits - 1);
      const int at = offset[digit] + mine[digit] + rank[r];
      key_out[at] = key[r];
      slot_out[at] = slot[r];
    }
    __syncthreads();  // the pass is written before the counts are reused
    src ^= 1;
  }

  // 4. the outputs (rows <= n: a thread's 8 rows, their loads issued
  // together)
  const int* order = slots + src * n;
  int row[kOrderItems];
  float x[kOrderItems][FEAT];
#pragma unroll
  for (int r = 0; r < kOrderItems; ++r) {
    const int i = tid + r * blockDim.x;
    row[r] = order[i < q_count ? i : q_count - 1];
    if (i < rows)
#pragma unroll
      for (int f = 0; f < FEAT; ++f) x[r][f] = __ldg(q + (size_t)row[r] * FEAT + f);
  }
#pragma unroll
  for (int r = 0; r < kOrderItems; ++r) {
    const int i = tid + r * blockDim.x;
    if (i < rows)
#pragma unroll
      for (int f = 0; f < FEAT; ++f) q_pad[(size_t)i * FEAT + f] = x[r][f];
    if (i < q_count) {
      qperm[i] = row[r];
      qinv[row[r]] = i;
    }
  }
}

template <int FEAT>
int launch_order(const float* q, float* q_pad, long long* qperm, long long* qinv, int q_count,
                 int rows, void* stream) {
  // a warp a 256 queries
  const int threads = (q_count + 32 * kOrderItems - 1) / (32 * kOrderItems) * 32;
  const size_t bytes = order_smem_bytes(threads);
  const int err = allow_smem(knn_query_order_kernel<FEAT>, bytes);
  if (err != (int)cudaSuccess) return err;
  knn_query_order_kernel<FEAT><<<1, threads, bytes, (cudaStream_t)stream>>>(
      q, q_pad, qperm, qinv, q_count, rows);
  return (int)cudaGetLastError();
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

// The fused design, unpruned: the k nearest candidates per query, (Q_pad, k)
// idx int64 and d2 f32 in ascending key order.  feat in 1..4, bins in {256,
// 512, 1024}, 1 <= k <= 64; q_count a multiple of 8, t_count of bins.
int knn_select(const float* q, const float* qsq, const float* tT, const float* tsq,
               long long* out_idx, float* out_d2, int q_count, int feat, int t_count,
               int bins, int chunk_mask, int k, int train_count, void* stream) {
  if (q_count == 0) return 0;
  if (feat < 1 || feat > 4 || (bins != 256 && bins != 512 && bins != 1024) || k < 1 ||
      k > kMaxK || q_count % kTQ != 0 || t_count % bins != 0 || train_count < 1)
    return (int)cudaErrorInvalidValue;
  auto go = feat == 1   ? launch_select_bins<1>
            : feat == 2 ? launch_select_bins<2>
            : feat == 3 ? launch_select_bins<3>
                        : launch_select_bins<4>;
  return go(bins, q, qsq, tT, tsq, out_idx, out_d2, q_count, t_count, chunk_mask, k,
            train_count, stream);
}

// The bounded route: the fused design's (Q_pad, k) candidates, bit-equal to
// knn_select's without a table, each block pruning the index's boxes of
// kThreads columns against its own bound; adds the boxes of the index and
// those walked, per block, to counts (int64).  feat in 1..4, bins in {256,
// 512, 1024}, 1 <= k <= 64; q_count a multiple of 8, t_count of bins,
// nb = t_count / 256, 1 <= bits, bits * feat <= 30.
int knn_bounded(const float* q, const float* qsq, const float* tT, const float* tsq,
                const float* box, const float* norm, const int* first, const float* grid,
                long long* out_idx, float* out_d2, long long* counts, int q_count, int feat,
                int t_count, int bins, int nb, int bits, int chunk_mask, int k,
                int train_count, void* stream) {
  return bounded<0>(q, qsq, tT, tsq, box, norm, first, grid, out_idx, out_d2, counts, q_count,
                    feat, t_count, bins, nb, bits, chunk_mask, k, train_count, stream);
}

// The bounded route's query order: the rows of q (q_count, feat) f32 along
// their own Morton curve (10 bits a feature, capped so that a code fits 30
// bits, as knn.py:_morton_grid), q_pad (rows, feat) edge-padded, qperm and
// its inverse qinv (q_count,) int64.  feat in 1..4, 1 <= q_count <= 8192,
// q_count <= rows.
int knn_query_order(const float* q, float* q_pad, long long* qperm, long long* qinv,
                    int q_count, int feat, int rows, void* stream) {
  if (feat < 1 || feat > 4 || q_count < 1 || q_count > kOrderCap || rows < q_count)
    return (int)cudaErrorInvalidValue;
  auto go = feat == 1   ? launch_order<1>
            : feat == 2 ? launch_order<2>
            : feat == 3 ? launch_order<3>
                        : launch_order<4>;
  return go(q, q_pad, qperm, qinv, q_count, rows, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
