// The exact nearest-neighbour search at low dimension, hand-written for
// Hopper: each query's exact k nearest training rows (k <= 64, feat <= 4)
// over the Morton-sorted index of muygpys_torch/gpu/knn_exact.py, one warp
// a query, every tile whose bounding box lies provably beyond the query's
// current k-th distance skipped.
//
// It replaces no kernel under muygpys_tpu/pallas/: the JAX package does its
// exact search as an XLA matrix product reduced by lax.approx_min_k
// (muygpys_tpu/neighbors.py), and the port did it as tiled cuBLAS addmm +
// torch.topk over an over-fetched candidate set, then an exact re-rank
// (muygpys_torch/neighbors.py:_brute_force_knn, _refine_knn): two library
// launches per (query tile, train tile) block, ~5,300 launches for 2048
// queries against 1,000,000 rows, every row scored and radix-selected for
// every query although a query's 30 neighbours lie within ~0.005 of it.
//
// What bounds it on an H100: the unpruned scan's arithmetic, 3 feat - 1
// operations per (query, row) pair (2048 x 10^6 pairs at feat = 2: ~0.15 ms
// at 67 TFLOP/s fp32), is a ceiling, not the work: the work is what the
// pruning leaves, ~4-10 tiles of 256 rows a query on a uniform sky, and
// depends on the data.  Like K3p it therefore has no roofline.  What is
// left is latency: each query's insertions into its warp's list are a
// chain of warp shuffles, and the 3907-box pass a loop of 122 steps.
//
// Design:
//   - One warp per query (4 queries a block; a bucket of 2048 is 512 blocks,
//     every warp resident at once on the 132 SMs); no shared memory and no
//     block barrier: warps finish at their own pace.
//   - The warp keeps its sorted top-k list in registers, two slots a lane
//     (slot s in lane s / 2): distance and sorted row position.  A row
//     nearer than tau (slot k - 1, the k-th smallest so far; +inf until k
//     rows were seen) is inserted by one ballot (its rank) and one shuffle
//     up (the slots above it move one place); tau is then broadcast again.
//     Rows are scored 32 at a time, a lane each; the lanes under tau are
//     taken in lane order.  (WarpSelect's queues and bitonic merges,
//     Johnson, Douze & Jegou 2017 section 4, pay off when many rows pass the
//     threshold; after the pruning few do, so the insertion is serial.)
//   - Order of the walk: the query's Morton code on the index's grid (the
//     quantisation _morton_codes applies to the rows) is found among the
//     tiles' first codes by a warp-wide search (32 probes a step), and that
//     tile and its two neighbours in Morton order are scored first, which
//     gives tau its near-final value.  Then one pass over every other
//     tile's box, 32 boxes a step (a lane each, read from L2 through the
//     read-only path: the boxes of 10^6 rows are 62.5 KB at feat = 2):
//     a tile is scored only if its box's squared distance is <= tau at that
//     moment; tau only falls.
//   - Output: the list in ascending order, each position mapped to the
//     caller's row through the index's permutation; the tiles the warp
//     scored are added to the index's device counter (one atomic a warp).
//
// Exactness.  A row's distance is the plain mirror's (and _refine_knn's at
// feat <= 2; torch.sum on the card adds 3 or 4 features in another order):
// d = sum over features, in feature order, of (q_f - t_f)^2, each
// difference, square and sum rounded to nearest on its own (the __f*_rn
// intrinsics: nothing contracted into a fused multiply-add).  A box's bound
// is the same expression of the per-feature gaps g_f = max(lo_f - q_f,
// q_f - hi_f, 0), in the same operations.  lo_f and hi_f are coordinates of
// rows of the tile, so for every row t of it |q_f - t_f| >= the exact gap,
// and rounding to nearest is monotone and odd: |rn(q_f - t_f)| >= rn(gap_f)
// = g_f, then rn(x^2) and rn(a + b) are monotone in each argument, so the
// computed bound never exceeds the computed distance of any row in the box.
// A tile is skipped only when its bound is > tau (strictly); every row in
// it then has d > tau >= the final k-th distance, so no skipped row belongs
// to the result.  The result is the k smallest distances of all rows, with
// multiplicity; among rows at equal distances the walk's order chooses (a
// row equal to tau does not displace the one holding tau).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;   // queries a block
constexpr int kMaxK = 64;   // two list slots a lane
constexpr int kMaxFeat = 4;

// A warp's sorted list: slots 2 lane and 2 lane + 1, ascending over the warp.
struct List {
  float v0, v1;  // distances
  int i0, i1;    // sorted row positions, -1 while empty
  float tau;     // slot k - 1, in every lane
};

// Squared distance of the query to sorted row r (tT feature-major, n rows).
template <int F>
__device__ __forceinline__ float row_d2(const float (&qv)[F],
                                        const float* __restrict__ tT, size_t n, int r) {
  float acc = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float d = __fsub_rn(qv[f], __ldg(tT + f * n + r));
    const float s = __fmul_rn(d, d);
    acc = f == 0 ? s : __fadd_rn(acc, s);
  }
  return acc;
}

// Squared distance of the query to tile j's box (box: F rows of lower
// corners, then F rows of upper corners, nt tiles each), in row_d2's
// operations: never above row_d2 of a row in the box.
template <int F>
__device__ __forceinline__ float box_d2(const float (&qv)[F],
                                        const float* __restrict__ box, size_t nt, int j) {
  float acc = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float lo = __ldg(box + f * nt + j);
    const float hi = __ldg(box + (F + f) * nt + j);
    const float g = fmaxf(fmaxf(__fsub_rn(lo, qv[f]), __fsub_rn(qv[f], hi)), 0.0f);
    const float s = __fmul_rn(g, g);
    acc = f == 0 ? s : __fadd_rn(acc, s);
  }
  return acc;
}

// Insert distance x of row xi (x < tau, the same in every lane): it takes
// the slot after every slot <= x, the slots above move up one place.
__device__ __forceinline__ void insert(List& l, float x, int xi, int lane, int k) {
  const int pos = __popc(__ballot_sync(kFull, l.v0 <= x)) +
                  __popc(__ballot_sync(kFull, l.v1 <= x));
  const float below_v = __shfl_up_sync(kFull, l.v1, 1);  // slot 2 lane - 1
  const int below_i = __shfl_up_sync(kFull, l.i1, 1);
  const int s0 = 2 * lane, s1 = s0 + 1;
  const float v1 = s1 < pos ? l.v1 : (s1 == pos ? x : l.v0);
  const int i1 = s1 < pos ? l.i1 : (s1 == pos ? xi : l.i0);
  const float v0 = s0 < pos ? l.v0 : (s0 == pos ? x : below_v);
  const int i0 = s0 < pos ? l.i0 : (s0 == pos ? xi : below_i);
  l.v0 = v0; l.v1 = v1; l.i0 = i0; l.i1 = i1;
  l.tau = __shfl_sync(kFull, ((k - 1) & 1) ? l.v1 : l.v0, (k - 1) >> 1);
}

// Score sorted rows [r0, r1), 32 at a time, into the list.
template <int F>
__device__ __forceinline__ void score(List& l, const float (&qv)[F],
                                      const float* __restrict__ tT, size_t n, int r0, int r1,
                                      int lane, int k) {
  for (int base = r0; base < r1; base += 32) {
    const int r = base + lane;
    const float d = r < r1 ? row_d2<F>(qv, tT, n, r) : INFINITY;
    unsigned m = __ballot_sync(kFull, d < l.tau);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float x = __shfl_sync(kFull, d, src);
      if (x < l.tau) insert(l, x, base + src, lane, k);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kWarps * 32) knn_exact_kernel(
    const float* __restrict__ q,           // (q_count, F) row-major
    const float* __restrict__ tT,          // (F, n) Morton-sorted rows
    const float* __restrict__ box,         // (2 F, nt) tile boxes
    const int* __restrict__ first,         // (nt,) each tile's first Morton code
    const long long* __restrict__ perm,    // (n,) sorted position -> caller's row
    const float* __restrict__ grid,        // (2 F,) Morton grid origin, then scale
    long long* __restrict__ out_idx,       // (q_count, k)
    float* __restrict__ out_d2,            // (q_count, k)
    unsigned long long* __restrict__ scored,  // (1,) tiles scored, accumulated
    int q_count, int n, int tile, int nt, int k, int bits) {
  const int lane = threadIdx.x & 31;
  const int query = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (query >= q_count) return;  // whole warps only
  float qv[F];
#pragma unroll
  for (int f = 0; f < F; ++f) qv[f] = __ldg(q + (size_t)query * F + f);

  // the query's Morton code, quantised as _morton_codes quantises the rows
  const float top = (float)((1 << bits) - 1);
  int code = 0;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float c = __fmul_rn(__fsub_rn(qv[f], __ldg(grid + f)), __ldg(grid + F + f));
    const int cell = (int)fminf(fmaxf(c, 0.0f), top);
    for (int b = 0; b < bits; ++b) code |= ((cell >> b) & 1) << (b * F + f);
  }
  // its tile: the last whose first code is <= code (tile 0 if none), found
  // 32 probes a step; the probes under code form a prefix of the lanes
  int lo = 0, hi = nt;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const unsigned under = __ballot_sync(kFull, p < hi && __ldg(first + p) <= code);
    if (under == 0) break;
    lo += (__popc(under) - 1) * step;
    hi = min(lo + step, hi);
  }
  const int f0 = max(lo - 1, 0), f1 = min(lo + 1, nt - 1);

  List l{INFINITY, INFINITY, -1, -1, INFINITY};
  const size_t rows = (size_t)n;
  score<F>(l, qv, tT, rows, f0 * tile, min((f1 + 1) * tile, n), lane, k);
  unsigned long long count = f1 - f0 + 1;

  // every other tile whose box is within tau
  for (int t0 = 0; t0 < nt; t0 += 32) {
    const int j = t0 + lane;
    const bool open = j < nt && (j < f0 || j > f1);
    const float b = open ? box_d2<F>(qv, box, (size_t)nt, j) : INFINITY;
    unsigned m = __ballot_sync(kFull, open && b <= l.tau);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      if (__shfl_sync(kFull, b, src) <= l.tau) {
        const int r0 = (t0 + src) * tile;
        score<F>(l, qv, tT, rows, r0, min(r0 + tile, n), lane, k);
        ++count;
      }
    }
  }

  const size_t out = (size_t)query * k;
  const int s0 = 2 * lane;
  if (s0 < k) {
    out_d2[out + s0] = l.v0;
    out_idx[out + s0] = l.i0 < 0 ? -1 : perm[l.i0];
  }
  if (s0 + 1 < k) {
    out_d2[out + s0 + 1] = l.v1;
    out_idx[out + s0 + 1] = l.i1 < 0 ? -1 : perm[l.i1];
  }
  if (lane == 0) atomicAdd(scored, count);
}

template <int F>
int launch(const float* q, const float* tT, const float* box, const int* first,
           const long long* perm, const float* grid, long long* out_idx, float* out_d2,
           unsigned long long* scored, int q_count, int n, int tile, int nt, int k, int bits,
           void* stream) {
  const int blocks = (q_count + kWarps - 1) / kWarps;
  knn_exact_kernel<F><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      q, tT, box, first, perm, grid, out_idx, out_d2, scored, q_count, n, tile, nt, k, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each query's k nearest rows, (q_count, k) idx int64 (the caller's rows)
// and d2 f32 in ascending order; adds the tiles scored to *scored (int64).
// feat in 1..4, 1 <= k <= 64, k <= n, nt = ceil(n / tile), bits * feat <= 30.
int knn_exact_select(const float* q, const float* tT, const float* box, const int* first,
                     const long long* perm, const float* grid, long long* out_idx,
                     float* out_d2, long long* scored, int q_count, int feat, int n,
                     int tile, int nt, int k, int bits, void* stream) {
  if (q_count == 0) return 0;
  if (feat < 1 || feat > kMaxFeat || k < 1 || k > kMaxK || k > n || tile < 1 ||
      nt != (n + tile - 1) / tile || bits < 1 || bits * feat > 30)
    return (int)cudaErrorInvalidValue;
  auto go = feat == 1   ? launch<1>
            : feat == 2 ? launch<2>
            : feat == 3 ? launch<3>
                        : launch<4>;
  return go(q, tT, box, first, perm, grid, out_idx, out_d2, (unsigned long long*)scored,
            q_count, n, tile, nt, k, bits, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
