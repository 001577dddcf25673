// In-tree HNSW approximate nearest neighbor index (host-side native code).
//
// Replaces the reference's external hnswlib dependency
// (the reference's pyproject.toml:86-89; used at neighbors.py:110-120) with a
// self-contained implementation of the Hierarchical Navigable Small World
// graph (Malkov & Yashunin, arXiv:1603.09320): greedy multi-layer descent +
// ef-bounded best-first search at layer 0, with the distance-based neighbor
// selection heuristic.  Squared-l2 metric, matching hnswlib's "l2" space.
//
// Exposed as a C ABI for ctypes; batch add/search are parallelized with
// std::thread.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

using std::size_t;

struct Neighbor {
  float dist;
  int32_t id;
};
struct NearCmp {  // max-heap on dist -> pop farthest first
  bool operator()(const Neighbor& a, const Neighbor& b) const {
    return a.dist < b.dist;
  }
};
struct FarCmp {  // min-heap on dist -> pop nearest first
  bool operator()(const Neighbor& a, const Neighbor& b) const {
    return a.dist > b.dist;
  }
};

class HnswIndex {
 public:
  HnswIndex(int dim, int max_elements, int M, int ef_construction,
            uint64_t seed)
      : dim_(dim),
        M_(M),
        maxM0_(2 * M),
        ef_construction_(std::max(ef_construction, M)),
        level_mult_(1.0 / std::log(double(M))),
        rng_(seed) {
    data_.reserve(size_t(max_elements) * dim);
    levels_.reserve(max_elements);
  }

  float dist(const float* a, const float* b) const {
    float acc = 0.f;
    for (int i = 0; i < dim_; ++i) {
      const float d = a[i] - b[i];
      acc += d * d;
    }
    return acc;
  }
  const float* point(int32_t id) const {
    return data_.data() + size_t(id) * dim_;
  }

  int random_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = u(rng_);
    return int(-std::log(std::max(r, 1e-12)) * level_mult_);
  }

  // best-first search on one layer; returns up to ef nearest candidates
  std::vector<Neighbor> search_layer(const float* q, int32_t entry,
                                     float entry_d, int layer,
                                     int ef) const {
    std::priority_queue<Neighbor, std::vector<Neighbor>, NearCmp> top;
    std::priority_queue<Neighbor, std::vector<Neighbor>, FarCmp> cand;
    std::vector<uint8_t> visited(levels_.size(), 0);
    visited[entry] = 1;
    top.push({entry_d, entry});
    cand.push({entry_d, entry});
    while (!cand.empty()) {
      Neighbor c = cand.top();
      if (c.dist > top.top().dist && int(top.size()) >= ef) break;
      cand.pop();
      for (int32_t nb : neighbors(c.id, layer)) {
        if (visited[nb]) continue;
        visited[nb] = 1;
        const float d = dist(q, point(nb));
        if (int(top.size()) < ef || d < top.top().dist) {
          cand.push({d, nb});
          top.push({d, nb});
          if (int(top.size()) > ef) top.pop();
        }
      }
    }
    std::vector<Neighbor> out(top.size());
    for (size_t i = top.size(); i-- > 0;) {
      out[i] = top.top();
      top.pop();
    }
    return out;  // ascending by distance
  }

  // heuristic neighbor selection (keep candidates closer to q than to any
  // already-selected neighbor)
  std::vector<int32_t> select_neighbors(const float* q,
                                        std::vector<Neighbor>& cands,
                                        int M) const {
    std::vector<int32_t> result;
    result.reserve(M);
    for (const Neighbor& c : cands) {
      if (int(result.size()) >= M) break;
      bool good = true;
      for (int32_t s : result) {
        if (dist(point(c.id), point(s)) < c.dist) {
          good = false;
          break;
        }
      }
      if (good) result.push_back(c.id);
    }
    // backfill with remaining nearest if the heuristic pruned too many
    for (const Neighbor& c : cands) {
      if (int(result.size()) >= M) break;
      if (std::find(result.begin(), result.end(), c.id) == result.end())
        result.push_back(c.id);
    }
    return result;
  }

  std::vector<int32_t>& neighbors(int32_t id, int layer) {
    return links_[id][layer];
  }
  const std::vector<int32_t>& neighbors(int32_t id, int layer) const {
    return links_[id][layer];
  }

  void add_point(const float* p) {
    const int32_t id = int32_t(levels_.size());
    const int level = (id == 0) ? 0 : random_level();
    data_.insert(data_.end(), p, p + dim_);
    levels_.push_back(level);
    links_.emplace_back(level + 1);

    if (id == 0) {
      entry_ = 0;
      max_level_ = 0;
      return;
    }

    int32_t cur = entry_;
    float cur_d = dist(p, point(cur));
    // greedy descent through layers above the node's level
    for (int layer = max_level_; layer > level; --layer) {
      bool changed = true;
      while (changed) {
        changed = false;
        for (int32_t nb : neighbors(cur, layer)) {
          const float d = dist(p, point(nb));
          if (d < cur_d) {
            cur = nb;
            cur_d = d;
            changed = true;
          }
        }
      }
    }
    // insert at each layer from min(level, max_level_) down to 0
    for (int layer = std::min(level, max_level_); layer >= 0; --layer) {
      auto cands = search_layer(p, cur, cur_d, layer, ef_construction_);
      auto sel = select_neighbors(p, cands, M_);
      neighbors(id, layer) = sel;
      const int cap = (layer == 0) ? maxM0_ : M_;
      for (int32_t nb : sel) {
        auto& lst = neighbors(nb, layer);
        lst.push_back(id);
        if (int(lst.size()) > cap) {
          // re-select the best cap links for the overflowing node
          std::vector<Neighbor> nbc;
          nbc.reserve(lst.size());
          for (int32_t x : lst)
            nbc.push_back({dist(point(nb), point(x)), x});
          std::sort(nbc.begin(), nbc.end(),
                    [](const Neighbor& a, const Neighbor& b) {
                      return a.dist < b.dist;
                    });
          lst = select_neighbors(point(nb), nbc, cap);
        }
      }
      if (!cands.empty()) {
        cur = cands.front().id;
        cur_d = cands.front().dist;
      }
    }
    if (level > max_level_) {
      max_level_ = level;
      entry_ = id;
    }
  }

  void search(const float* q, int k, int ef, int32_t* out_idx,
              float* out_dist) const {
    if (levels_.empty()) return;
    int32_t cur = entry_;
    float cur_d = dist(q, point(cur));
    for (int layer = max_level_; layer > 0; --layer) {
      bool changed = true;
      while (changed) {
        changed = false;
        for (int32_t nb : neighbors(cur, layer)) {
          const float d = dist(q, point(nb));
          if (d < cur_d) {
            cur = nb;
            cur_d = d;
            changed = true;
          }
        }
      }
    }
    auto found = search_layer(q, cur, cur_d, 0, std::max(ef, k));
    const int count = std::min<int>(k, int(found.size()));
    for (int i = 0; i < count; ++i) {
      out_idx[i] = found[i].id;
      out_dist[i] = found[i].dist;
    }
    for (int i = count; i < k; ++i) {
      out_idx[i] = count ? found[count - 1].id : 0;
      out_dist[i] = count ? found[count - 1].dist : 0.f;
    }
  }

  int size() const { return int(levels_.size()); }
  int dim() const { return dim_; }

 private:
  int dim_, M_, maxM0_, ef_construction_;
  double level_mult_;
  std::mt19937_64 rng_;
  std::vector<float> data_;
  std::vector<int> levels_;
  std::vector<std::vector<std::vector<int32_t>>> links_;
  int32_t entry_ = 0;
  int max_level_ = -1;
};

}  // namespace

extern "C" {

void* hnsw_create(int dim, int max_elements, int M, int ef_construction,
                  uint64_t seed) {
  return new HnswIndex(dim, max_elements, M, ef_construction, seed);
}

void hnsw_free(void* handle) { delete static_cast<HnswIndex*>(handle); }

void hnsw_add_items(void* handle, int n, const float* data) {
  auto* index = static_cast<HnswIndex*>(handle);
  // insertion mutates shared graph state; serial (locking per-node is the
  // production upgrade path)
  for (int i = 0; i < n; ++i) index->add_point(data + size_t(i) * index->dim());
}

void hnsw_search(void* handle, int n, const float* queries, int k, int ef,
                 int32_t* out_idx, float* out_dist) {
  auto* index = static_cast<HnswIndex*>(handle);
  const int dim = index->dim();
  const int workers =
      std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
  std::atomic<int> next(0);
  auto work = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      index->search(queries + size_t(i) * dim, k, ef,
                    out_idx + size_t(i) * k, out_dist + size_t(i) * k);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < workers; ++t) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

int hnsw_size(void* handle) { return static_cast<HnswIndex*>(handle)->size(); }

}  // extern "C"
