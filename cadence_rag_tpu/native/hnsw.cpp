// HNSW graph index: native build + search.
//
// The reference's ANN engine is pgvector's HNSW (C; m=16, ef_construction=64
// build, ef_search query — reference: alembic 0001:98-102,
// app/retrieve.py:290-300). On the device the production ANN is the scan /
// IVF (see ops/ivf.py for the bandwidth argument); this module
// is the literal HNSW counterpart: a host-side graph BUILDER (the native
// "graph-builder" role) and search path used for CPU-only deployments and
// for recall cross-checks, exposed to Python via ctypes (native/hnsw.py).
//
// Algorithm: Malkov & Yashunin 2016. Similarity = inner product over unit
// vectors (cosine), matching the index contract. Neighbor selection is the
// simple top-M rule (pgvector's default behavior class).
//
// Build: g++ -O3 -march=native -shared -fPIC -o _hnsw.so hnsw.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_set>
#include <vector>

namespace {

struct Hnsw {
  int64_t n = 0;
  int32_t dim = 0;
  int32_t M = 16;
  int32_t ef_construction = 64;
  const float* vecs = nullptr;      // borrowed (N, dim), caller keeps alive
  std::vector<float> owned;         // owned copy when requested
  int32_t max_level = -1;
  int64_t entry = -1;
  // neighbors[l][i*Mmax .. ]: padded adjacency per level (-1 = empty)
  std::vector<std::vector<int64_t>> neighbors;
  std::vector<int32_t> levels;      // per node
  std::mt19937_64 rng;

  int32_t mmax(int32_t level) const { return level == 0 ? 2 * M : M; }

  float sim(int64_t a, const float* q) const {
    const float* va = vecs + a * dim;
    float acc = 0.f;
    for (int32_t i = 0; i < dim; ++i) acc += va[i] * q[i];
    return acc;
  }

  using Cand = std::pair<float, int64_t>;  // (similarity, node)

  std::vector<Cand> search_layer(const float* q, int64_t ep, int32_t level,
                                 int32_t ef) const {
    std::priority_queue<Cand, std::vector<Cand>, std::greater<Cand>> top;  // min-heap
    std::priority_queue<Cand> frontier;                                    // max-heap
    std::unordered_set<int64_t> visited;
    float ep_sim = sim(ep, q);
    top.emplace(ep_sim, ep);
    frontier.emplace(ep_sim, ep);
    visited.insert(ep);
    while (!frontier.empty()) {
      Cand cur = frontier.top();
      frontier.pop();
      if (top.size() >= static_cast<size_t>(ef) && cur.first < top.top().first)
        break;
      const int64_t* nbrs = neighbors[level].data() + cur.second * mmax(level);
      for (int32_t j = 0; j < mmax(level); ++j) {
        int64_t nb = nbrs[j];
        if (nb < 0) break;
        if (!visited.insert(nb).second) continue;
        float s = sim(nb, q);
        if (top.size() < static_cast<size_t>(ef) || s > top.top().first) {
          top.emplace(s, nb);
          frontier.emplace(s, nb);
          if (top.size() > static_cast<size_t>(ef)) top.pop();
        }
      }
    }
    std::vector<Cand> out;
    out.reserve(top.size());
    while (!top.empty()) { out.push_back(top.top()); top.pop(); }
    std::sort(out.rbegin(), out.rend());  // best first
    return out;
  }

  // Algorithm 4 (Malkov-Yashunin): keep a candidate only if it is closer
  // to the query node than to every already-selected neighbor — yields
  // direction-diverse edges, which is what gives HNSW its recall.
  std::vector<int64_t> select_heuristic(int64_t node,
                                        std::vector<Cand> cands,
                                        int32_t m) const {
    std::sort(cands.rbegin(), cands.rend());  // best-first
    std::vector<int64_t> selected;
    selected.reserve(m);
    for (const auto& [s_to_node, c] : cands) {
      if (static_cast<int32_t>(selected.size()) >= m) break;
      if (c == node) continue;
      bool dominated = false;
      const float* vc = vecs + c * dim;
      for (int64_t sel : selected) {
        if (sim(sel, vc) > s_to_node) { dominated = true; break; }
      }
      if (!dominated) selected.push_back(c);
    }
    // backfill with best remaining if the heuristic was too strict
    for (const auto& [s, c] : cands) {
      if (static_cast<int32_t>(selected.size()) >= m) break;
      if (c == node) continue;
      if (std::find(selected.begin(), selected.end(), c) == selected.end())
        selected.push_back(c);
    }
    return selected;
  }

  void connect(int64_t node, int64_t nb, int32_t level) {
    int64_t* row = neighbors[level].data() + node * mmax(level);
    for (int32_t j = 0; j < mmax(level); ++j) {
      if (row[j] < 0) { row[j] = nb; return; }
    }
    // full: re-select with the diversity heuristic over row ∪ {nb}
    const float* vnode = vecs + node * dim;
    std::vector<Cand> cands;
    cands.reserve(mmax(level) + 1);
    cands.emplace_back(sim(nb, vnode), nb);
    for (int32_t j = 0; j < mmax(level); ++j)
      cands.emplace_back(sim(row[j], vnode), row[j]);
    auto keep = select_heuristic(node, std::move(cands), mmax(level));
    for (int32_t j = 0; j < mmax(level); ++j)
      row[j] = j < static_cast<int32_t>(keep.size()) ? keep[j] : -1;
  }

  void insert(int64_t node) {
    // level ~ floor(-ln(U) / ln(M))  (Malkov-Yashunin level assignment)
    std::uniform_real_distribution<double> uni(1e-12, 1.0);
    int32_t level = static_cast<int32_t>(
        -std::log(uni(rng)) / std::log(static_cast<double>(M)));
    levels[node] = level;
    while (static_cast<int32_t>(neighbors.size()) <= level) {
      int32_t l = static_cast<int32_t>(neighbors.size());
      neighbors.emplace_back(
          std::vector<int64_t>(static_cast<size_t>(n) * mmax(l), -1));
    }
    const float* q = vecs + node * dim;
    if (entry < 0) { entry = node; max_level = level; return; }

    int64_t ep = entry;
    for (int32_t l = max_level; l > level; --l) {
      bool improved = true;
      float best = sim(ep, q);
      while (improved) {
        improved = false;
        const int64_t* nbrs = neighbors[l].data() + ep * mmax(l);
        for (int32_t j = 0; j < mmax(l); ++j) {
          int64_t nb = nbrs[j];
          if (nb < 0) break;
          float s = sim(nb, q);
          if (s > best) { best = s; ep = nb; improved = true; }
        }
      }
    }
    for (int32_t l = std::min(level, max_level); l >= 0; --l) {
      auto cands = search_layer(q, ep, l, ef_construction);
      if (!cands.empty()) ep = cands.front().second;
      auto picked = select_heuristic(node, cands, M);
      for (int64_t nb : picked) {
        connect(node, nb, l);
        connect(nb, node, l);
      }
    }
    if (level > max_level) { max_level = level; entry = node; }
  }

  void search(const float* q, int32_t ef, int32_t k, int32_t* out_idx,
              float* out_sim) const {
    for (int32_t i = 0; i < k; ++i) { out_idx[i] = -1; out_sim[i] = -1e30f; }
    if (entry < 0) return;
    int64_t ep = entry;
    for (int32_t l = max_level; l > 0; --l) {
      bool improved = true;
      float best = sim(ep, q);
      while (improved) {
        improved = false;
        const int64_t* nbrs = neighbors[l].data() + ep * mmax(l);
        for (int32_t j = 0; j < mmax(l); ++j) {
          int64_t nb = nbrs[j];
          if (nb < 0) break;
          float s = sim(nb, q);
          if (s > best) { best = s; ep = nb; improved = true; }
        }
      }
    }
    auto cands = search_layer(q, ep, 0, std::max(ef, k));
    int32_t count = std::min<int32_t>(k, static_cast<int32_t>(cands.size()));
    for (int32_t i = 0; i < count; ++i) {
      out_idx[i] = static_cast<int32_t>(cands[i].second);
      out_sim[i] = cands[i].first;
    }
  }
};

}  // namespace

extern "C" {

void* hnsw_build(const float* vecs, int64_t n, int32_t dim, int32_t M,
                 int32_t ef_construction, uint64_t seed, int32_t copy_vectors) {
  auto* index = new Hnsw();
  index->n = n;
  index->dim = dim;
  index->M = M > 0 ? M : 16;
  index->ef_construction = ef_construction > 0 ? ef_construction : 64;
  index->rng.seed(seed);
  if (copy_vectors) {
    index->owned.assign(vecs, vecs + n * dim);
    index->vecs = index->owned.data();
  } else {
    index->vecs = vecs;
  }
  index->levels.assign(static_cast<size_t>(n), 0);
  for (int64_t i = 0; i < n; ++i) index->insert(i);
  return index;
}

void hnsw_search(void* handle, const float* q, int32_t ef, int32_t k,
                 int32_t* out_idx, float* out_sim) {
  static_cast<Hnsw*>(handle)->search(q, ef, k, out_idx, out_sim);
}

int32_t hnsw_max_level(void* handle) {
  return static_cast<Hnsw*>(handle)->max_level;
}

void hnsw_free(void* handle) { delete static_cast<Hnsw*>(handle); }

}  // extern "C"
