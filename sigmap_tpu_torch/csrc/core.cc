// sigmap_tpu_torch native core (a copy of the JAX package's native/core.cc):
// host-side runtime pieces that are inherently
// sequential or latency-sensitive, exposed via a C ABI for ctypes.
//
// Clean-room implementations of the behaviors documented in SURVEY.md;
// reference citations point at the reference Sigmap sources, for parity
// checking only.
//
// Contents:
//   sig_dedup            - point-cloud consecutive dedup (spatial_index.cc:33-57)
//   sig_kd_build/free    - exact k-d tree over overlapping signal windows,
//                          built on every core the process may run on
//   sig_kd_radius        - strict squared-L2 radius search (nanoflann parity)
//   sig_chain            - anchor chaining DP with exact skip/gap semantics
//                          (spatial_index.cc:418-550)
//
// Build: sigmap_tpu_torch/_build.py:native_library (g++, at first use).

#include <sched.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Consecutive-duplicate suppression over one signal-direction stream:
// keep position i if unmasked and (i is the first kept in this stream or
// |v[i] - v[last_kept]| > delta).  Position 0, if unmasked, is always kept
// regardless of the previous stream's tail value (the reference compares
// against point_cloud.back() across stream boundaries ONLY via the
// `signal_position == 0 ||` short-circuit, spatial_index.cc:43-46, so a
// per-stream call reproduces it when the caller passes prev_val for
// positions > 0 of a continuing stream; pass keep_first=1 per stream).
// prev_val/have_prev: last kept value of the preceding stream (the
// reference's point_cloud.back() comparison crosses stream boundaries for
// positions > 0; position 0 short-circuits past it).  out_last receives the
// last kept value for threading into the next stream.
int64_t sig_dedup_stream(const float* vals, const uint8_t* masked, int64_t n,
                         float delta, float prev_val, int32_t have_prev,
                         int32_t* out_idx, float* out_last) {
  int64_t m = 0;
  float last = prev_val;
  bool have_last = have_prev != 0;
  for (int64_t i = 0; i < n; ++i) {
    if (masked && masked[i]) continue;
    if (i == 0 || !have_last || std::fabs(vals[i] - last) > delta) {
      out_idx[m++] = (int32_t)i;
      last = vals[i];
      have_last = true;
    }
  }
  if (out_last) *out_last = last;
  return m;
}

int64_t sig_dedup(const float* vals, const uint8_t* masked, int64_t n,
                  float delta, int32_t* out_idx) {
  return sig_dedup_stream(vals, masked, n, delta, 0.0f, 0, out_idx, nullptr);
}

// ---------------------------------------------------------------------------
// Exact k-d tree over overlapping windows of a flat value array.
// Point i has coordinates vals[i + d] for d in [0, dim); there are
// n_vals - dim + 1 points.  Used as the golden oracle for the TPU bucketed
// radius search and as the CPU baseline engine.
// ---------------------------------------------------------------------------

struct KdNode {
  // leaf: [begin, end) into idx; internal: split dim/val + children
  int32_t left = -1, right = -1;
  int32_t begin = 0, end = 0;
  int32_t split_dim = -1;
  float split_val = 0.0f;
  float bbox_min[16];
  float bbox_max[16];
};

struct KdTree {
  const float* vals;
  int64_t n_points;
  int32_t dim;
  int32_t max_leaf;
  std::vector<int32_t> idx;
  std::vector<KdNode> nodes;

  inline float coord(int32_t p, int32_t d) const { return vals[p + d]; }

  // The subtree over idx[begin, end), appended to `out` in preorder (a
  // node, its left subtree, its right subtree); returns its root's index
  // in `out`.
  int32_t build(std::vector<KdNode>& out, int32_t begin, int32_t end) {
    int32_t ni = (int32_t)out.size();
    out.emplace_back();
    {
      KdNode& n = out[ni];
      for (int d = 0; d < dim; ++d) {
        n.bbox_min[d] = 3.4e38f;
        n.bbox_max[d] = -3.4e38f;
      }
      for (int32_t i = begin; i < end; ++i) {
        for (int d = 0; d < dim; ++d) {
          float v = coord(idx[i], d);
          n.bbox_min[d] = std::min(n.bbox_min[d], v);
          n.bbox_max[d] = std::max(n.bbox_max[d], v);
        }
      }
    }
    if (end - begin <= max_leaf) {
      KdNode& n = out[ni];
      n.begin = begin;
      n.end = end;
      return ni;
    }
    int sd;
    float sv;
    int32_t m = split(out[ni], begin, end, &sd, &sv);
    int32_t li = build(out, begin, m);
    int32_t ri = build(out, m, end);
    KdNode& n = out[ni];
    n.split_dim = sd;
    n.split_val = sv;
    n.left = li;
    n.right = ri;
    return ni;
  }

  // split widest dim at midpoint of the bbox (sliding-midpoint-free,
  // median fallback when degenerate); returns the split's index in idx
  int32_t split(const KdNode& n, int32_t begin, int32_t end, int* sd_out,
                float* sv_out) {
    int sd = 0;
    float width = -1.0f;
    for (int d = 0; d < dim; ++d) {
      float w = n.bbox_max[d] - n.bbox_min[d];
      if (w > width) {
        width = w;
        sd = d;
      }
    }
    float sv = 0.5f * (n.bbox_min[sd] + n.bbox_max[sd]);
    int32_t* base = idx.data();
    int32_t* mid = std::partition(base + begin, base + end, [&](int32_t p) {
      return coord(p, sd) < sv;
    });
    int32_t m = (int32_t)(mid - base);
    if (m == begin || m == end) median(begin, end, sd, &m, &sv);
    *sd_out = sd;
    *sv_out = sv;
    return m;
  }

  void median(int32_t begin, int32_t end, int sd, int32_t* m, float* sv) {
    int32_t* base = idx.data();
    *m = begin + (end - begin) / 2;
    std::nth_element(base + begin, base + *m, base + end,
                     [&](int32_t a, int32_t b) {
                       return coord(a, sd) < coord(b, sd);
                     });
    *sv = coord(base[*m], sd);
  }
};

// ---------------------------------------------------------------------------
// The same tree built on several threads: the same idx order and the same
// nodes, numbered alike, as KdTree::build on one.  The nodes above `grain`
// points are split a level at a time: while a level has fewer nodes than
// threads, each of its nodes has its bbox reduced and its points
// partitioned by all threads; a wider level splits its nodes side by side.
// The subtrees at or below `grain` are then built by KdTree::build, one a
// thread at a time, and spliced in preorder.  The partition of a node over
// threads is the one std::partition makes (libstdc++'s, for any iterator
// at least bidirectional): it swaps the i-th point of the left part that
// belongs right, from the left, with the i-th point of the right part that
// belongs left, from the right, and moves nothing else.  min and max are
// exact in any order, so the bboxes are the one-thread ones.
// ---------------------------------------------------------------------------

}  // extern "C": the helpers below are C++ templates

// the cores this process may run on (its affinity mask)
static int kd_threads() {
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof(set), &set) == 0)
    return std::max(1, CPU_COUNT(&set));
  return std::max(1u, std::thread::hardware_concurrency());
}

// fn(c) for every c in [0, n), on up to `threads` threads (the caller's
// among them), each taking the next c when it is done with one
template <class F>
static void parallel_for(int threads, int64_t n, const F& fn) {
  int t = (int)std::min<int64_t>(threads, n);
  if (t <= 1) {
    for (int64_t c = 0; c < n; ++c) fn(c);
    return;
  }
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (int64_t c; (c = next.fetch_add(1)) < n;) fn(c);
  };
  std::vector<std::thread> pool;
  for (int i = 1; i < t; ++i) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

struct KdParallel {
  KdTree& t;
  int threads;
  int32_t grain;
  // a node above grain (task < 0) with its children here, or a subtree
  // built by task `task` over [begin, end)
  struct Top {
    KdNode node;
    int32_t left = -1, right = -1, task = -1;
  };
  std::vector<Top> top;
  std::vector<std::pair<int32_t, int32_t>> tasks;

  // [begin, end) cut into one range a chunk, `chunks` of them
  static std::pair<int32_t, int32_t> chunk(int32_t begin, int32_t end,
                                           int64_t chunks, int64_t c) {
    int64_t n = end - begin;
    return {(int32_t)(begin + n * c / chunks),
            (int32_t)(begin + n * (c + 1) / chunks)};
  }

  int64_t n_chunks(int32_t begin, int32_t end) const {
    return std::max<int64_t>(
        1, std::min<int64_t>(4 * threads, (end - begin) / 256));
  }

  void bbox(KdNode& n, int32_t begin, int32_t end) {
    int64_t C = n_chunks(begin, end);
    std::vector<KdNode> part(C);
    parallel_for(threads, C, [&](int64_t c) {
      auto r = chunk(begin, end, C, c);
      KdNode& p = part[c];
      for (int d = 0; d < t.dim; ++d) {
        p.bbox_min[d] = 3.4e38f;
        p.bbox_max[d] = -3.4e38f;
      }
      for (int32_t i = r.first; i < r.second; ++i) {
        for (int d = 0; d < t.dim; ++d) {
          float v = t.coord(t.idx[i], d);
          p.bbox_min[d] = std::min(p.bbox_min[d], v);
          p.bbox_max[d] = std::max(p.bbox_max[d], v);
        }
      }
    });
    for (int d = 0; d < t.dim; ++d) {
      n.bbox_min[d] = 3.4e38f;
      n.bbox_max[d] = -3.4e38f;
      for (int64_t c = 0; c < C; ++c) {
        n.bbox_min[d] = std::min(n.bbox_min[d], part[c].bbox_min[d]);
        n.bbox_max[d] = std::max(n.bbox_max[d], part[c].bbox_max[d]);
      }
    }
  }

  // std::partition of idx[begin, end) by coord(p, sd) < sv; returns the
  // first index of the right part
  int32_t partition(int32_t begin, int32_t end, int sd, float sv) {
    int32_t* idx = t.idx.data();
    auto left = [&](int32_t i) { return t.coord(idx[i], sd) < sv; };
    int64_t C = n_chunks(begin, end);
    std::vector<int64_t> cnt(C);
    parallel_for(threads, C, [&](int64_t c) {
      auto r = chunk(begin, end, C, c);
      int64_t k = 0;
      for (int32_t i = r.first; i < r.second; ++i) k += left(i);
      cnt[c] = k;
    });
    int64_t n_left = 0;
    for (int64_t k : cnt) n_left += k;
    int32_t m = (int32_t)(begin + n_left);
    if (m == begin || m == end) return m;   // nothing moves
    // the left part's right-going points, left to right, and the right
    // part's left-going points, right to left
    int64_t CL = n_chunks(begin, m), CR = n_chunks(m, end);
    std::vector<int64_t> off_l(CL + 1, 0), off_r(CR + 1, 0);
    parallel_for(threads, CL + CR, [&](int64_t c) {
      bool is_l = c < CL;
      auto r = is_l ? chunk(begin, m, CL, c) : chunk(m, end, CR, c - CL);
      int64_t k = 0;
      for (int32_t i = r.first; i < r.second; ++i) k += left(i) != is_l;
      (is_l ? off_l[c + 1] : off_r[c - CL + 1]) = k;
    });
    for (int64_t c = 0; c < CL; ++c) off_l[c + 1] += off_l[c];
    for (int64_t c = 0; c < CR; ++c) off_r[c + 1] += off_r[c];
    int64_t n_swap = off_l[CL];
    std::vector<int32_t> from_l(n_swap), from_r(n_swap);
    parallel_for(threads, CL + CR, [&](int64_t c) {
      if (c < CL) {
        auto r = chunk(begin, m, CL, c);
        int64_t o = off_l[c];
        for (int32_t i = r.first; i < r.second; ++i)
          if (!left(i)) from_l[o++] = i;
      } else {
        c -= CL;
        auto r = chunk(m, end, CR, c);
        // chunks later in idx come first
        int64_t o = n_swap - off_r[c + 1];
        for (int32_t i = r.second - 1; i >= r.first; --i)
          if (left(i)) from_r[o++] = i;
      }
    });
    int64_t CS = std::max<int64_t>(1, std::min<int64_t>(4 * threads,
                                                        n_swap / 256));
    parallel_for(threads, CS, [&](int64_t c) {
      for (int64_t i = n_swap * c / CS; i < n_swap * (c + 1) / CS; ++i)
        std::swap(idx[from_l[i]], idx[from_r[i]]);
    });
    return m;
  }

  // The nodes above grain, a level at a time: a level of fewer nodes
  // than threads splits each node on all of them, a wider one splits its
  // nodes side by side, each by KdTree::split; a node at or below grain
  // becomes a task.
  void split_top() {
    std::vector<std::array<int32_t, 3>> level{{0, 0, (int32_t)t.n_points}};
    top.emplace_back();
    while (!level.empty()) {
      std::vector<int32_t> ms(level.size());
      bool wide = (int64_t)level.size() >= threads;
      auto one = [&](int64_t i) {
        auto [ti, begin, end] = level[i];
        KdNode& n = top[ti].node;
        if (wide) {
          bbox_serial(n, begin, end);
          int sd;
          float sv;
          ms[i] = t.split(n, begin, end, &sd, &sv);
          n.split_dim = sd;
          n.split_val = sv;
        } else {
          ms[i] = split_parallel(n, begin, end);
        }
      };
      if (wide)
        parallel_for(threads, (int64_t)level.size(), one);
      else
        for (int64_t i = 0; i < (int64_t)level.size(); ++i) one(i);
      std::vector<std::array<int32_t, 3>> next;
      for (size_t i = 0; i < level.size(); ++i) {
        auto [ti, begin, end] = level[i];
        int32_t kids[2][2] = {{begin, ms[i]}, {ms[i], end}};
        for (int k = 0; k < 2; ++k) {
          int32_t ci = (int32_t)top.size();
          top.emplace_back();
          (k ? top[ti].right : top[ti].left) = ci;
          auto [b, e] = kids[k];
          if (e - b <= grain) {
            top[ci].task = (int32_t)tasks.size();
            tasks.emplace_back(b, e);
          } else {
            next.push_back({ci, b, e});
          }
        }
      }
      level.swap(next);
    }
  }

  void bbox_serial(KdNode& n, int32_t begin, int32_t end) {
    for (int d = 0; d < t.dim; ++d) {
      n.bbox_min[d] = 3.4e38f;
      n.bbox_max[d] = -3.4e38f;
    }
    for (int32_t i = begin; i < end; ++i) {
      for (int d = 0; d < t.dim; ++d) {
        float v = t.coord(t.idx[i], d);
        n.bbox_min[d] = std::min(n.bbox_min[d], v);
        n.bbox_max[d] = std::max(n.bbox_max[d], v);
      }
    }
  }

  // KdTree::split on all threads
  int32_t split_parallel(KdNode& n, int32_t begin, int32_t end) {
    bbox(n, begin, end);
    int sd = 0;
    float width = -1.0f;
    for (int d = 0; d < t.dim; ++d) {
      float w = n.bbox_max[d] - n.bbox_min[d];
      if (w > width) {
        width = w;
        sd = d;
      }
    }
    float sv = 0.5f * (n.bbox_min[sd] + n.bbox_max[sd]);
    int32_t m = partition(begin, end, sd, sv);
    if (m == begin || m == end) t.median(begin, end, sd, &m, &sv);
    n.split_dim = sd;
    n.split_val = sv;
    return m;
  }

  int32_t splice(int32_t ti, std::vector<std::vector<KdNode>>& built) {
    int32_t ni = (int32_t)t.nodes.size();
    if (top[ti].task >= 0) {
      for (KdNode n : built[top[ti].task]) {
        if (n.left >= 0) n.left += ni;
        if (n.right >= 0) n.right += ni;
        t.nodes.push_back(n);
      }
      std::vector<KdNode>().swap(built[top[ti].task]);
      return ni;
    }
    t.nodes.push_back(top[ti].node);
    int32_t li = splice(top[ti].left, built);
    int32_t ri = splice(top[ti].right, built);
    t.nodes[ni].left = li;
    t.nodes[ni].right = ri;
    return ni;
  }

  void run() {
    if (t.n_points <= grain) {
      top.emplace_back();
      top[0].task = 0;
      tasks.emplace_back(0, (int32_t)t.n_points);
    } else {
      split_top();
    }
    std::vector<std::vector<KdNode>> built(tasks.size());
    parallel_for(threads, (int64_t)tasks.size(), [&](int64_t i) {
      t.build(built[i], tasks[i].first, tasks[i].second);
    });
    splice(0, built);
  }
};

extern "C" {

// The tree over windows of vals, built on every core this process may run
// on; the same tree on any number of them.
void* sig_kd_build(const float* vals, int64_t n_vals, int32_t dim,
                   int32_t max_leaf) {
  if (dim > 16) return nullptr;
  KdTree* t = new KdTree();
  t->vals = vals;
  t->n_points = n_vals - dim + 1;
  t->dim = dim;
  t->max_leaf = max_leaf;
  t->idx.resize(t->n_points);
  for (int64_t i = 0; i < t->n_points; ++i) t->idx[i] = (int32_t)i;
  t->nodes.reserve(2 * t->n_points / max_leaf + 4);
  int th = kd_threads();
  if (t->n_points > 0) {
    if (th <= 1) {
      t->build(t->nodes, 0, (int32_t)t->n_points);
    } else {
      // some 8 subtrees a thread below the nodes split by all of them
      int32_t grain = (int32_t)std::max<int64_t>(
          t->n_points / (8 * (int64_t)th), 2 * (int64_t)max_leaf + 1);
      KdParallel{*t, th, grain}.run();
    }
  }
  return t;
}

// The tree's window order (idx, n_points of them) and its nodes: for each,
// left, right, begin, end, split_dim into `links` [n_nodes, 5] and its
// split value into `splits`, where they are not null.  Returns n_nodes.
int64_t sig_kd_layout(void* tree, int32_t* order, int32_t* links,
                      float* splits) {
  KdTree* t = (KdTree*)tree;
  if (order) std::copy(t->idx.begin(), t->idx.end(), order);
  int64_t nn = (int64_t)t->nodes.size();
  for (int64_t i = 0; i < nn; ++i) {
    const KdNode& n = t->nodes[i];
    if (links) {
      int32_t* l = links + 5 * i;
      l[0] = n.left;
      l[1] = n.right;
      l[2] = n.begin;
      l[3] = n.end;
      l[4] = n.split_dim;
    }
    if (splits) splits[i] = n.split_val;
  }
  return nn;
}

void sig_kd_free(void* tree) { delete (KdTree*)tree; }

static void kd_radius_rec(const KdTree* t, int32_t ni, const float* q,
                          float r2, int32_t* out_idx, float* out_dist,
                          int64_t cap, int64_t* m) {
  const KdNode& n = t->nodes[ni];
  // bbox pruning: min squared distance from q to the box
  float mind = 0.0f;
  for (int d = 0; d < t->dim; ++d) {
    float v = q[d];
    float lo = n.bbox_min[d], hi = n.bbox_max[d];
    float diff = v < lo ? lo - v : (v > hi ? v - hi : 0.0f);
    mind += diff * diff;
    if (mind >= r2) return;
  }
  if (n.split_dim < 0) {
    for (int32_t i = n.begin; i < n.end; ++i) {
      int32_t p = t->idx[i];
      float acc = 0.0f;
      for (int d = 0; d < t->dim; ++d) {
        float diff = q[d] - t->vals[p + d];
        acc += diff * diff;
      }
      if (acc < r2 && *m < cap) {  // strict <, nanoflann.hpp:249
        out_idx[*m] = p;
        out_dist[*m] = acc;
        (*m)++;
      }
    }
    return;
  }
  kd_radius_rec(t, n.left, q, r2, out_idx, out_dist, cap, m);
  kd_radius_rec(t, n.right, q, r2, out_idx, out_dist, cap, m);
}

int64_t sig_kd_radius(void* tree, const float* q, float radius_sq,
                      int32_t* out_idx, float* out_dist, int64_t cap) {
  int64_t m = 0;
  KdTree* t = (KdTree*)tree;
  if (t->n_points > 0)
    kd_radius_rec(t, 0, q, radius_sq, out_idx, out_dist, cap, &m);
  return m;
}

// Batched query helper: queries laid out flat [nq * dim]; results appended
// per query with counts in out_counts (each query capped at per_cap).
int64_t sig_kd_radius_batch(void* tree, const float* queries, int64_t nq,
                            float radius_sq, int32_t* out_idx,
                            float* out_dist, int32_t* out_counts,
                            int64_t per_cap) {
  KdTree* t = (KdTree*)tree;
  int64_t total = 0;
  for (int64_t i = 0; i < nq; ++i) {
    int64_t m = 0;
    if (t->n_points > 0)
      kd_radius_rec(t, 0, queries + i * t->dim, radius_sq, out_idx + total,
                    out_dist + total, per_cap, &m);
    out_counts[i] = (int32_t)m;
    total += m;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Anchor chaining DP with the reference's exact banded/skip semantics
// (spatial_index.cc:418-550).  Anchors must be pre-sorted by
// (target_position, query_position, distance) ascending for one
// (reference sequence, strand) group.
//
// Outputs per anchor: score and predecessor (self-index when none).
// ---------------------------------------------------------------------------

void sig_chain_scores(const int32_t* target_pos, const int32_t* query_pos,
                      const float* dist, int64_t n, float search_radius,
                      int32_t dim,
                      // params (spatial_index.cc:284-291)
                      int32_t max_gap_length, int32_t max_target_gap_length,
                      int32_t band_length, int32_t max_num_skips,
                      float* scores, int32_t* pred) {
  for (int64_t i = 0; i < n; ++i) {
    float dist_coef = 1.0f - 0.2f * dist[i] / search_radius;
    scores[i] = dist_coef * dim;
    pred[i] = (int32_t)i;
    int32_t tp = target_pos[i];
    int32_t qp = query_pos[i];
    int64_t start = i > band_length ? i - band_length : 0;
    int32_t num_skips = 0;
    for (int64_t j = i - 1; j >= start; --j) {
      int32_t ptp = target_pos[j];
      int32_t pqp = query_pos[j];
      if (pqp == qp) continue;
      if (ptp == tp) continue;
      if (ptp + max_target_gap_length < tp) break;
      int32_t tdiff = tp - ptp;
      int32_t qdiff = qp - pqp;
      float cand = 0.0f;
      if (qdiff < 0) continue;
      float match_dim =
          (float)std::min(std::min(tdiff, qdiff), dim) * dist_coef;
      int32_t gap = std::abs(tdiff - qdiff);
      float gap_scale = tdiff > 0 ? (float)qdiff / tdiff : 1.0f;
      if (gap < max_gap_length && gap_scale < 5.0f && gap_scale > 0.75f) {
        cand = scores[j] + match_dim;
      }
      if (cand > scores[i]) {
        scores[i] = cand;
        pred[i] = (int32_t)j;
        --num_skips;
      } else {
        ++num_skips;
        if (num_skips > max_num_skips) break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Canonical k-mer counting + high-frequency masking (sigmap.cc:19-185).
// codes: 2-bit bases, >=4 = ambiguous.  Counting uses the rolling fwd/rc
// registers with run-length reset on ambiguous bases; canonical = min.
// ---------------------------------------------------------------------------

int64_t sig_kmer_count(const uint8_t* codes, int64_t n, int32_t k,
                       int64_t* hist) {
  uint64_t mask = (((uint64_t)1) << (2 * k)) - 1;
  uint64_t shift = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int32_t run = 0;
  int64_t num = 0;
  for (int64_t p = 0; p < n; ++p) {
    uint8_t b = codes[p];
    if (b < 4) {
      fwd = ((fwd << 2) | b) & mask;
      rc = (rc >> 2) | (((uint64_t)(3 ^ b)) << shift);
      if (++run >= k) {
        hist[fwd < rc ? fwd : rc] += 1;
        ++num;
      }
    } else {
      run = 0;
      fwd = rc = 0;
    }
  }
  return num;
}

void sig_kmer_mask(const uint8_t* codes, int64_t n, int32_t k,
                   const int64_t* hist, int64_t num_kmers, float frequency,
                   uint8_t* out_mask /* [n-k+1] */) {
  uint64_t mask = (((uint64_t)1) << (2 * k)) - 1;
  uint64_t shift = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int32_t run = 0;
  float fnum = (float)num_kmers;
  for (int64_t i = 0; i + k <= n; ++i) out_mask[i] = 0;
  for (int64_t p = 0; p < n; ++p) {
    uint8_t b = codes[p];
    if (b < 4) {
      fwd = ((fwd << 2) | b) & mask;
      rc = (rc >> 2) | (((uint64_t)(3 ^ b)) << shift);
      if (++run >= k) {
        uint64_t canon = fwd < rc ? fwd : rc;
        // float compare exactly like sigmap.cc:114
        out_mask[p + 1 - k] = ((float)hist[canon] / fnum) > frequency;
      }
    } else {
      run = 0;
      fwd = rc = 0;
      if (p >= k - 1) out_mask[p + 1 - k] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Event detection -> compressed feature signal for one chunk.
// Same algorithm as signal/events_ref.py accurate mode: two-window Welch
// t-stats with *centered* variance (stable twin of event.h:70-115), the
// dual-detector peak state machine (event.h:117-182), CreateEvents
// boundaries [0, p_0..p_{n-2}, L] (event.h:200-224), float64 z-score
// (sigmap.cc:1131-1155), delta run-collapse (sigmap.cc:1072-1079).
// ---------------------------------------------------------------------------

struct EdParams {
  int32_t w1, w2;
  float thresh1, thresh2, peak_height;
};

static void tstat_centered(const float* x, int64_t n, int32_t w, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = 0.0f;
  if (n < 2 * w || w < 2) return;
  for (int64_t i = w; i <= n - w; ++i) {
    float s1 = 0, s2 = 0;
    for (int32_t k = 0; k < w; ++k) {
      s1 += x[i - w + k];
      s2 += x[i + k];
    }
    float m1 = s1 / w, m2 = s2 / w;
    float v = 0;
    for (int32_t k = 0; k < w; ++k) {
      float d1 = x[i - w + k] - m1, d2 = x[i + k] - m2;
      v += d1 * d1 + d2 * d2;
    }
    v /= w;
    if (v < 1.17549435e-38f) v = 1.17549435e-38f;
    if (i < n) out[i] = std::fabs(m2 - m1) / std::sqrt(v / w);
  }
}

struct Det {
  float threshold;
  int32_t wl;
  int64_t masked_to = 0;
  int64_t peak_pos = -1;
  float peak_value = 3.4028235e38f;
  bool valid = false;
};

static int64_t detect_peaks(const float* t1, const float* t2, int64_t n,
                            const EdParams& p, int64_t* peaks) {
  Det dets[2] = {{p.thresh1, p.w1}, {p.thresh2, p.w2}};
  const float* ts[2] = {t1, t2};
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 2; ++k) {
      Det& d = dets[k];
      if (d.masked_to >= i) continue;
      float v = ts[k][i];
      if (d.peak_pos == -1) {
        if (v < d.peak_value) {
          d.peak_value = v;
        } else if (v - d.peak_value > p.peak_height) {
          d.peak_value = v;
          d.peak_pos = i;
        }
      } else {
        if (v > d.peak_value) {
          d.peak_value = v;
          d.peak_pos = i;
        }
        if (k == 0 && d.peak_value > d.threshold) {
          dets[1].masked_to = d.peak_pos + d.wl;
          dets[1].peak_pos = -1;
          dets[1].peak_value = 3.4028235e38f;
          dets[1].valid = false;
        }
        if (d.peak_value - v > p.peak_height && d.peak_value > d.threshold) {
          d.valid = true;
        }
        if (d.valid && (i - d.peak_pos) > d.wl / 2) {
          peaks[m++] = d.peak_pos;
          d.peak_pos = -1;
          d.peak_value = v;
          d.valid = false;
        }
      }
    }
  }
  return m;
}

int64_t sig_features(const float* sig, int64_t n, int32_t w1, int32_t w2,
                     float thresh1, float thresh2, float peak_height,
                     float compress_delta, float* out_feats, float* out_stdvs,
                     int64_t cap) {
  if (n <= 0) return 0;
  EdParams p{w1, w2, thresh1, thresh2, peak_height};
  std::vector<float> t1(n), t2(n);
  tstat_centered(sig, n, w1, t1.data());
  tstat_centered(sig, n, w2, t2.data());
  std::vector<int64_t> peaks(n);
  int64_t np = detect_peaks(t1.data(), t2.data(), n, p, peaks.data());
  // boundaries [0, p_0..p_{n-2}, L]; degenerate cases as events_ref.py
  std::vector<int64_t> bounds;
  bounds.push_back(0);
  if (np == 1) bounds.push_back(peaks[0]);
  for (int64_t i = 0; i + 1 < np; ++i) bounds.push_back(peaks[i]);
  bounds.push_back(n);
  int64_t ne = (int64_t)bounds.size() - 1;
  std::vector<float> means(ne), stdvs(ne);
  for (int64_t e = 0; e < ne; ++e) {
    int64_t a = bounds[e], b = bounds[e + 1];
    float s = 0, sq = 0;
    for (int64_t i = a; i < b; ++i) {
      s += sig[i];
      sq += sig[i] * sig[i];
    }
    float len = (float)(b - a);
    means[e] = s / len;
    float var = sq / len - means[e] * means[e];
    stdvs[e] = std::sqrt(var > 0 ? var : 0.0f);
  }
  // float64 z-score (population mean, n-1 variance)
  double mean = 0;
  for (int64_t e = 0; e < ne; ++e) mean += means[e];
  mean /= ne;
  double sd = 0;
  for (int64_t e = 0; e < ne; ++e) {
    sd += (means[e] - mean) * (means[e] - mean);
  }
  sd = std::sqrt(sd / (ne > 1 ? ne - 1 : 1));
  // delta run-collapse
  int64_t m = 0;
  float last = 0;
  for (int64_t e = 0; e < ne && m < cap; ++e) {
    float z = (float)((means[e] - mean) / sd);
    if (e == 0 || std::fabs(z - last) > compress_delta) {
      out_feats[m] = z;
      out_stdvs[m] = stdvs[e];
      last = z;
      ++m;
    }
  }
  return m;
}

}  // extern "C"
