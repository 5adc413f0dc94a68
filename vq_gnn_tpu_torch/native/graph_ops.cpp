// Native host-side graph kernels for vq_gnn_tpu_torch (a copy of
// vq_gnn_tpu/native/graph_ops.cpp; the two packages share no code).
//
// The reference leans on torch_sparse/torch_cluster C++/CUDA for per-batch
// subgraph extraction, random walks and METIS partitioning (SURVEY §2.2).
// On TPU the per-batch work is host CPU; these kernels keep the input
// pipeline off the Python interpreter's critical path.
//
// Exposed via a plain C ABI consumed with ctypes (vq_gnn_tpu_torch/native/lib.py).
//
// Build: make -C vq_gnn_tpu_torch/native   (produces libvqgnn_graph.so)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

extern "C" {

typedef struct {
  int64_t n_fo;   // number of boundary (B') nodes
  int64_t n_e;    // number of edges
  int64_t *fo;    // [n_fo] global boundary ids (sorted)
  int64_t *er;    // [n_e] local edge rows (batch i -> i, boundary j -> B + j)
  int64_t *ec;    // [n_e] local edge cols
  float *ev;      // [n_e] edge values
} SubgraphResult;

// 1-hop subgraph with the [B || B'] layout, matching the reference
// _k_hop_subgraph (vq_gnn_v2/dataloader.py:98-148).  train_flag keeps all
// edges among the subset; eval keeps only batch rows.
SubgraphResult *vq_khop(const int64_t *rowptr, const int64_t *col,
                        const float *val, int64_t num_N, const int64_t *batch,
                        int64_t B, int train_flag) {
  // position map: -1 unseen, >=0 local index
  std::vector<int64_t> pos(num_N, -1);
  for (int64_t i = 0; i < B; ++i) pos[batch[i]] = i;

  // boundary = neighbors of batch rows not in batch; collect sorted unique
  std::vector<char> seen(num_N, 0);
  std::vector<int64_t> fo;
  for (int64_t i = 0; i < B; ++i) {
    int64_t v = batch[i];
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
      int64_t u = col[e];
      if (pos[u] < 0 && !seen[u]) {
        seen[u] = 1;
        fo.push_back(u);
      }
    }
  }
  std::sort(fo.begin(), fo.end());
  for (size_t j = 0; j < fo.size(); ++j) pos[fo[j]] = B + (int64_t)j;

  std::vector<int64_t> er, ec;
  std::vector<float> ev;
  auto emit_row = [&](int64_t v, bool filter_cols) {
    int64_t r = pos[v];
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
      int64_t c = pos[col[e]];
      if (filter_cols && c < 0) continue;
      er.push_back(r);
      ec.push_back(c);
      ev.push_back(val[e]);
    }
  };
  if (train_flag) {
    for (int64_t i = 0; i < B; ++i) emit_row(batch[i], true);
    for (int64_t j = 0; j < (int64_t)fo.size(); ++j) emit_row(fo[j], true);
  } else {
    // eval: batch rows only; every col of a batch row is in the subset
    for (int64_t i = 0; i < B; ++i) emit_row(batch[i], true);
  }

  auto *res = (SubgraphResult *)malloc(sizeof(SubgraphResult));
  res->n_fo = (int64_t)fo.size();
  res->n_e = (int64_t)er.size();
  res->fo = (int64_t *)malloc(sizeof(int64_t) * fo.size());
  res->er = (int64_t *)malloc(sizeof(int64_t) * er.size());
  res->ec = (int64_t *)malloc(sizeof(int64_t) * ec.size());
  res->ev = (float *)malloc(sizeof(float) * ev.size());
  memcpy(res->fo, fo.data(), sizeof(int64_t) * fo.size());
  memcpy(res->er, er.data(), sizeof(int64_t) * er.size());
  memcpy(res->ec, ec.data(), sizeof(int64_t) * ec.size());
  memcpy(res->ev, ev.data(), sizeof(float) * ev.size());
  return res;
}

void vq_free_subgraph(SubgraphResult *r) {
  if (!r) return;
  free(r->fo);
  free(r->er);
  free(r->ec);
  free(r->ev);
  free(r);
}

// Slot-ELL construction from row-sorted COO (see ops/spmm.py:build_ell_host).
// Splits each row's edges into slots of K; emits (slot row, K cols, K vals)
// padded with (num_rows, num_rows, 0).  out_* are preallocated: ell_row
// [S_pad], ell_col/ell_val [S_pad*K] row-major.
// Rows are dense: a row with no edges still gets one zero-valued dustbin
// slot so sorted slot rows are gap-free over [0, num_rows) — the invariant
// the windowed Pallas segment-sum relies on (ops/pallas_segsum.py).
void vq_build_ell(const int64_t *row, const int64_t *col, const float *val,
                  int64_t E, int64_t num_rows, int64_t K, int64_t S_pad,
                  int32_t *ell_row, int32_t *ell_col, float *ell_val) {
  for (int64_t s = 0; s < S_pad; ++s) ell_row[s] = (int32_t)num_rows;
  for (int64_t i = 0; i < S_pad * K; ++i) {
    ell_col[i] = (int32_t)num_rows;
    ell_val[i] = 0.0f;
  }
  int64_t sid = -1, k = 0, e = 0;
  for (int64_t r = 0; r < num_rows; ++r) {
    if (e >= E || row[e] != r) {  // empty row: one dustbin slot
      ++sid;
      ell_row[sid] = (int32_t)r;
      continue;
    }
    k = K;  // force a fresh slot for this row's first edge
    for (; e < E && row[e] == r; ++e) {
      if (k == K) {
        ++sid;
        k = 0;
        ell_row[sid] = (int32_t)r;
      }
      ell_col[sid * K + k] = (int32_t)col[e];
      ell_val[sid * K + k] = val[e];
      ++k;
    }
  }
}

// Uniform random walk (torch_cluster semantics: isolated nodes stay put).
// out is [n, length+1] row-major, preallocated by the caller.
void vq_random_walk(const int64_t *rowptr, const int64_t *col, int64_t num_N,
                    const int64_t *starts, int64_t n, int64_t length,
                    uint64_t seed, int64_t *out) {
  std::mt19937_64 gen(seed);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cur = starts[i];
    out[i * (length + 1)] = cur;
    for (int64_t s = 0; s < length; ++s) {
      int64_t deg = rowptr[cur + 1] - rowptr[cur];
      if (deg > 0) cur = col[rowptr[cur] + (int64_t)(gen() % (uint64_t)deg)];
      out[i * (length + 1) + s + 1] = cur;
    }
  }
}

// Greedy BFS-grow balanced partitioner (METIS stand-in for the cluster
// sampler, reference misc.py:93-112).  Grows parts from low-degree seeds to
// the balanced target size; BFS frontiers keep parts connected, which is
// what drives the low inter/intra edge ratio the sampler needs.
void vq_partition(const int64_t *rowptr, const int64_t *col, int64_t num_N,
                  int32_t num_parts, int32_t *cluster) {
  const int64_t target = (num_N + num_parts - 1) / num_parts;
  std::vector<int32_t> assign(num_N, -1);

  // seeds in ascending-degree order
  std::vector<int64_t> order(num_N);
  for (int64_t i = 0; i < num_N; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return (rowptr[a + 1] - rowptr[a]) < (rowptr[b + 1] - rowptr[b]);
  });

  std::vector<int64_t> queue;
  queue.reserve(num_N);
  int64_t seed_cursor = 0;
  for (int32_t part = 0; part < num_parts; ++part) {
    int64_t size = 0;
    queue.clear();
    size_t head = 0;
    while (size < target) {
      if (head >= queue.size()) {
        // refill from the next unassigned seed
        while (seed_cursor < num_N && assign[order[seed_cursor]] >= 0)
          ++seed_cursor;
        if (seed_cursor >= num_N) break;
        queue.push_back(order[seed_cursor]);
      }
      int64_t v = queue[head++];
      if (assign[v] >= 0) continue;
      assign[v] = part;
      ++size;
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
        int64_t u = col[e];
        if (assign[u] < 0) queue.push_back(u);
      }
    }
    if (seed_cursor >= num_N && size == 0) {
      // ran out of nodes; remaining parts stay empty
    }
  }
  // any stragglers (disconnected tails) go to the last part
  for (int64_t i = 0; i < num_N; ++i)
    cluster[i] = assign[i] >= 0 ? assign[i] : num_parts - 1;
}

}  // extern "C"

// ---------------- Multilevel k-way partitioner ----------------
// METIS-style pipeline (Karypis & Kumar '98), implemented from scratch:
//   1. coarsen by heavy-edge matching until ~max(128, 16*parts) nodes,
//   2. greedy weighted BFS-grow initial partition on the coarsest graph,
//   3. project back level by level with greedy boundary (FM-flavored)
//      refinement under a 5% node-weight balance ceiling.
// Replaces torch_sparse's METIS binding (reference misc.py:107) for the
// cluster sampler; the input CSR must have a symmetric pattern.

namespace {

struct MLGraph {
  int64_t n = 0;
  std::vector<int64_t> rowptr, col;
  std::vector<int64_t> ew;  // edge weights (contracted multiplicities)
  std::vector<int64_t> nw;  // node weights (contracted sizes)
};

// Heavy-edge matching in random order; writes fine->coarse map, returns nc.
int64_t hem_match(const MLGraph &g, std::mt19937_64 &gen,
                  std::vector<int64_t> &cmap) {
  std::vector<int64_t> order(g.n);
  for (int64_t i = 0; i < g.n; ++i) order[i] = i;
  std::shuffle(order.begin(), order.end(), gen);
  std::vector<int64_t> match(g.n, -1);
  for (int64_t oi = 0; oi < g.n; ++oi) {
    int64_t v = order[oi];
    if (match[v] >= 0) continue;
    int64_t best = -1, bw = -1;
    for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; ++e) {
      int64_t u = g.col[e];
      if (u == v || match[u] >= 0) continue;
      if (g.ew[e] > bw) {
        bw = g.ew[e];
        best = u;
      }
    }
    if (best >= 0) {
      match[v] = best;
      match[best] = v;
    } else {
      match[v] = v;
    }
  }
  cmap.assign(g.n, -1);
  int64_t nc = 0;
  for (int64_t oi = 0; oi < g.n; ++oi) {
    int64_t v = order[oi];
    if (cmap[v] >= 0) continue;
    cmap[v] = nc;
    cmap[match[v]] = nc;
    ++nc;
  }
  return nc;
}

MLGraph contract(const MLGraph &g, const std::vector<int64_t> &cmap,
                 int64_t nc) {
  MLGraph c;
  c.n = nc;
  c.nw.assign(nc, 0);
  for (int64_t v = 0; v < g.n; ++v) c.nw[cmap[v]] += g.nw[v];
  // bucket fine nodes by coarse id
  std::vector<int64_t> cnt(nc + 1, 0);
  for (int64_t v = 0; v < g.n; ++v) ++cnt[cmap[v] + 1];
  for (int64_t i = 0; i < nc; ++i) cnt[i + 1] += cnt[i];
  std::vector<int64_t> members(g.n), cur(cnt.begin(), cnt.end() - 1);
  for (int64_t v = 0; v < g.n; ++v) members[cur[cmap[v]]++] = v;

  c.rowptr.assign(nc + 1, 0);
  std::vector<int64_t> stamp(nc, -1), acc(nc, 0);
  c.col.reserve(g.col.size());
  c.ew.reserve(g.col.size());
  for (int64_t cv = 0; cv < nc; ++cv) {
    int64_t start = (int64_t)c.col.size();
    for (int64_t mi = cnt[cv]; mi < cnt[cv + 1]; ++mi) {
      int64_t v = members[mi];
      for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; ++e) {
        int64_t cu = cmap[g.col[e]];
        if (cu == cv) continue;  // contracted self-edge
        if (stamp[cu] != cv) {
          stamp[cu] = cv;
          acc[cu] = 0;
          c.col.push_back(cu);
        }
        acc[cu] += g.ew[e];
      }
    }
    for (int64_t i = start; i < (int64_t)c.col.size(); ++i)
      c.ew.push_back(acc[c.col[i]]);
    c.rowptr[cv + 1] = (int64_t)c.col.size();
  }
  return c;
}

// Greedy graph growing (GGGP) for the coarsest level: grow each part from
// a low-degree seed, always absorbing the frontier node with the heaviest
// connection to the growing part (node-weight balanced).  The coarsest
// graph is small (<= max(128, 16*parts) nodes), so the lazy heap is cheap.
void greedy_grow_weighted(const MLGraph &g, int32_t parts,
                          std::vector<int32_t> &assign) {
  assign.assign(g.n, -1);
  int64_t remaining = 0;
  for (int64_t v = 0; v < g.n; ++v) remaining += g.nw[v];

  std::vector<int64_t> order(g.n);
  for (int64_t i = 0; i < g.n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return (g.rowptr[a + 1] - g.rowptr[a]) < (g.rowptr[b + 1] - g.rowptr[b]);
  });

  std::vector<int64_t> conn(g.n, 0);  // connection of frontier node to part
  std::priority_queue<std::pair<int64_t, int64_t>> heap;  // (conn, node)
  int64_t seed_cursor = 0;
  for (int32_t part = 0; part < parts; ++part) {
    // remaining-aware target: earlier parts overshoot (lumpy contracted
    // node weights), so a FIXED target starves — or empties — the last
    // parts, and refinement can never repopulate a part no node touches
    const int64_t target = (remaining + (parts - part) - 1) / (parts - part);
    int64_t size = 0;
    while (!heap.empty()) heap.pop();
    for (int64_t v = 0; v < g.n; ++v)
      if (assign[v] < 0) conn[v] = 0;
    while (size < target) {
      int64_t v = -1;
      while (!heap.empty()) {
        auto [w, u] = heap.top();
        heap.pop();
        if (assign[u] < 0 && w == conn[u]) {  // skip stale entries
          v = u;
          break;
        }
      }
      if (v < 0) {  // frontier exhausted: reseed from next unassigned
        while (seed_cursor < g.n && assign[order[seed_cursor]] >= 0)
          ++seed_cursor;
        if (seed_cursor >= g.n) break;
        v = order[seed_cursor];
      }
      assign[v] = part;
      size += g.nw[v];
      remaining -= g.nw[v];
      for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; ++e) {
        const int64_t u = g.col[e];
        if (assign[u] < 0) {
          conn[u] += g.ew[e];
          heap.push({conn[u], u});
        }
      }
    }
  }
  for (int64_t v = 0; v < g.n; ++v)
    if (assign[v] < 0) assign[v] = parts - 1;
}

// Greedy boundary refinement: move nodes to the part they connect to most,
// respecting a balance ceiling; zero-gain moves allowed when they improve
// balance (also serves as the rebalance mechanism between levels).
void refine(const MLGraph &g, int32_t parts, std::vector<int32_t> &assign,
            int max_passes, double ub) {
  std::vector<int64_t> pw(parts, 0);
  int64_t total = 0;
  for (int64_t v = 0; v < g.n; ++v) {
    pw[assign[v]] += g.nw[v];
    total += g.nw[v];
  }
  const int64_t maxw = (int64_t)(ub * (double)total / parts) + 1;

  std::vector<int64_t> conn(parts, 0);
  std::vector<int32_t> touched;
  touched.reserve(64);
  for (int pass = 0; pass < max_passes; ++pass) {
    int64_t moves = 0;
    for (int64_t v = 0; v < g.n; ++v) {
      const int32_t p = assign[v];
      touched.clear();
      for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; ++e) {
        if (g.col[e] == v) continue;
        const int32_t q = assign[g.col[e]];
        if (conn[q] == 0) touched.push_back(q);
        conn[q] += g.ew[e];
      }
      // best-connected OTHER part that fits under the balance ceiling
      int32_t best = p;
      int64_t bw = -1;
      for (int32_t q : touched) {
        if (q == p || pw[q] + g.nw[v] > maxw) continue;
        if (conn[q] > bw || (conn[q] == bw && pw[q] < pw[best])) {
          bw = conn[q];
          best = q;
        }
      }
      if (best != p) {
        const int64_t gain = bw - conn[p];
        // overweight sources shed to the best fitting part at ANY gain —
        // this is the rebalance mechanism, and it bounds pw at maxw as
        // long as the part has boundary nodes
        if (gain > 0 || pw[p] > maxw ||
            (gain == 0 && pw[best] + g.nw[v] < pw[p])) {
          assign[v] = best;
          pw[p] -= g.nw[v];
          pw[best] += g.nw[v];
          ++moves;
        }
      }
      for (int32_t q : touched) conn[q] = 0;
    }
    if (moves == 0) break;
  }
}

}  // namespace

extern "C" {

// Multilevel partitioner entry point; cluster[i] in [0, num_parts).
void vq_partition_ml(const int64_t *rowptr, const int64_t *col, int64_t num_N,
                     int32_t num_parts, uint64_t seed, int32_t *cluster) {
  if (num_parts <= 1 || num_N == 0) {
    for (int64_t v = 0; v < num_N; ++v) cluster[v] = 0;
    return;
  }
  MLGraph g;
  g.n = num_N;
  g.rowptr.assign(rowptr, rowptr + num_N + 1);
  g.col.assign(col, col + rowptr[num_N]);
  g.ew.assign(rowptr[num_N], 1);
  g.nw.assign(num_N, 1);

  std::vector<MLGraph> levels;
  std::vector<std::vector<int64_t>> maps;
  levels.push_back(std::move(g));
  std::mt19937_64 gen(seed);
  const int64_t coarsen_to =
      std::max<int64_t>(128, (int64_t)num_parts * 16);
  while (levels.back().n > coarsen_to) {
    std::vector<int64_t> cmap;
    const int64_t nc = hem_match(levels.back(), gen, cmap);
    if (nc > levels.back().n * 95 / 100) break;  // matching stalled
    MLGraph c = contract(levels.back(), cmap, nc);
    maps.push_back(std::move(cmap));
    levels.push_back(std::move(c));
  }

  std::vector<int32_t> assign;
  greedy_grow_weighted(levels.back(), num_parts, assign);
  refine(levels.back(), num_parts, assign, 20, 1.05);
  for (int64_t l = (int64_t)levels.size() - 2; l >= 0; --l) {
    std::vector<int32_t> fine(levels[l].n);
    for (int64_t v = 0; v < levels[l].n; ++v) fine[v] = assign[maps[l][v]];
    assign = std::move(fine);
    refine(levels[l], num_parts, assign, l == 0 ? 40 : 8, 1.05);
  }
  for (int64_t v = 0; v < num_N; ++v) cluster[v] = assign[v];
}

}  // extern "C"
