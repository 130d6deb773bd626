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
//   sig_kd_build/free    - exact k-d tree over overlapping signal windows
//   sig_kd_radius        - strict squared-L2 radius search (nanoflann parity)
//   sig_chain            - anchor chaining DP with exact skip/gap semantics
//                          (spatial_index.cc:418-550)
//
// Build: sigmap_tpu_torch/_build.py:native_library (g++, at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
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

  int32_t build(int32_t begin, int32_t end) {
    int32_t ni = (int32_t)nodes.size();
    nodes.emplace_back();
    {
      KdNode& n = nodes[ni];
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
      KdNode& n = nodes[ni];
      n.begin = begin;
      n.end = end;
      return ni;
    }
    // split widest dim at midpoint of the bbox (sliding-midpoint-free,
    // median fallback when degenerate)
    int sd = 0;
    float width = -1.0f;
    for (int d = 0; d < dim; ++d) {
      float w = nodes[ni].bbox_max[d] - nodes[ni].bbox_min[d];
      if (w > width) {
        width = w;
        sd = d;
      }
    }
    float sv = 0.5f * (nodes[ni].bbox_min[sd] + nodes[ni].bbox_max[sd]);
    int32_t* base = idx.data();
    int32_t* mid = std::partition(base + begin, base + end, [&](int32_t p) {
      return coord(p, sd) < sv;
    });
    int32_t m = (int32_t)(mid - base);
    if (m == begin || m == end) {  // degenerate: median split
      m = begin + (end - begin) / 2;
      std::nth_element(base + begin, base + m, base + end,
                       [&](int32_t a, int32_t b) {
                         return coord(a, sd) < coord(b, sd);
                       });
      sv = coord(base[m], sd);
    }
    int32_t li = build(begin, m);
    int32_t ri = build(m, end);
    KdNode& n = nodes[ni];
    n.split_dim = sd;
    n.split_val = sv;
    n.left = li;
    n.right = ri;
    return ni;
  }
};

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
  if (t->n_points > 0) t->build(0, (int32_t)t->n_points);
  return t;
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
