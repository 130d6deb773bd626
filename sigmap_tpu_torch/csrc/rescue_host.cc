// Host side of the rescue's radius search on the card (mapping/rescue.py):
// the seeds' block table before the kernel (csrc/rescue_search.cu) and the
// exact check of its candidates after it.  Each is one call, which ctypes
// makes without the interpreter lock: the rescue threads share that lock
// with the mapper's caller and prepare thread, and numpy would give it up and
// wait for it again at each of some fifty array operations a chunk.
//
// Built like csrc/core.cc (_build.native_library: g++ -O3 -ffp-contract=off),
// so every float operation rounds on its own, as numpy's, torch's and
// kd_radius_rec's do.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr int64_t kBig = 2147483647;  // sweep_search.BIG: a dead offset

// floor(v / w) clipped to [0, radix-1], as sweep_search._cells
inline int64_t cell(float v, float w, int64_t radix) {
  float c = std::floor(v / w);
  c = std::min(std::max(c, 0.0f), (float)(radix - 1));
  return (int64_t)c;
}

}  // namespace

extern "C" {

// sweep_search.prepare_round for blocks of one seed.  queries [nq, dim] f32
// (raw) -> `in` (i32 words): the rotated seeds [nq, 8] f32, rows sorted
// (stably) by lo-corner cell key, then blockmeta [2*NO+1, nq] i32, NO =
// span^(bd-1) the probe offsets of a seed; rows[i] is the query of sorted
// row i.  radius and cell_width are rounded to f32 as prepare_round rounds
// them.  `in` holds nq * (8 + 2*NO + 1) words, which it returns.
int64_t sig_rescue_table(const float* queries, int32_t nq, int32_t dim,
                         const float* rot, const float* mu,
                         const float* origin, const int64_t* radixes,
                         int32_t bd, double cell_width, double radius,
                         int32_t span, int64_t NO, const int32_t* cum,
                         int64_t n_cum, int64_t ntiles, int32_t tile,
                         int32_t* in, int32_t* rows) {
  const int64_t words = (int64_t)nq * 8 + (2 * NO + 1) * nq;
  const float w = (float)cell_width;
  const float delta = (float)std::sqrt(radius);
  // (seeds - mu) @ rot, summed in dim order
  std::vector<float> qr((size_t)nq * 8, 0.0f);
  for (int i = 0; i < nq; ++i) {
    float x[8];
    for (int d = 0; d < dim; ++d) x[d] = queries[i * dim + d] - mu[d];
    for (int j = 0; j < dim; ++j) {
      float acc = x[0] * rot[j];
      for (int d = 1; d < dim; ++d) acc = acc + x[d] * rot[d * dim + j];
      qr[i * 8 + j] = acc;
    }
  }
  std::vector<int64_t> lo((size_t)nq * bd), hi((size_t)nq * bd),
      skey(nq);
  for (int i = 0; i < nq; ++i) {
    int64_t k = 0;
    for (int d = 0; d < bd; ++d) {
      const float q = qr[i * 8 + d];
      lo[i * bd + d] = cell((q - delta) - origin[d], w, radixes[d]);
      hi[i * bd + d] = cell((q + delta) - origin[d], w, radixes[d]);
      k = k * radixes[d] + lo[i * bd + d];
    }
    skey[i] = k;
  }
  std::iota(rows, rows + nq, 0);
  std::stable_sort(rows, rows + nq,
                   [&](int32_t a, int32_t b) { return skey[a] < skey[b]; });
  float* seeds = reinterpret_cast<float*>(in);
  int32_t* bm = in + (int64_t)nq * 8;
  // key steps of the leading dims: the product of the later radixes
  std::vector<int64_t> stride(bd, 1);
  for (int d = bd - 2; d >= 0; --d) stride[d] = stride[d + 1] * radixes[d + 1];
  const int64_t CS = n_cum - 1;
  std::vector<int64_t> t0(NO), t1(NO), ord(NO);
  for (int g = 0; g < nq; ++g) {
    const int32_t r = rows[g];
    std::memcpy(seeds + g * 8, &qr[r * 8], 8 * sizeof(float));
    const int64_t* l = &lo[r * bd];
    const int64_t* h = &hi[r * bd];
    for (int64_t o = 0; o < NO; ++o) {
      // offset o's digits, the last leading dim fastest
      // (itertools.product order)
      bool ok = true;
      int64_t key = l[bd - 1];
      int64_t rest = o;
      for (int d = bd - 2; d >= 0; --d) {
        const int64_t off = rest % span;
        rest /= span;
        ok = ok && l[d] + off <= h[d];
        key += (l[d] + off) * stride[d];
      }
      const int64_t bmin = ok ? key : kBig;
      const int64_t bmax = ok ? key + (h[bd - 1] - l[bd - 1]) : -1;
      const int64_t start = cum[std::min(std::max(bmin, (int64_t)0), CS)];
      const int64_t end = cum[std::min(std::max(bmax + 1, (int64_t)0), CS)];
      const bool empty = bmax < bmin || end <= start;
      t0[o] = empty ? ntiles : start / tile;
      t1[o] = empty ? ntiles : (end + tile - 1) / tile;
    }
    // the offsets' unions overlap at tile granularity: disjoint intervals
    std::iota(ord.begin(), ord.end(), 0);
    std::stable_sort(ord.begin(), ord.end(),
                     [&](int64_t a, int64_t b) { return t0[a] < t0[b]; });
    int64_t emax = 0, cums = 0;
    for (int64_t k = 0; k < NO; ++k) {
      const int64_t a = t0[ord[k]], b = t1[ord[k]];
      int64_t m = k == 0 ? a : std::max(a, emax);
      emax = k == 0 ? b : std::max(emax, b);
      const int64_t cnt = std::max(b - m, (int64_t)0);
      m = std::min(std::max(m, (int64_t)0), std::max(ntiles - 1, (int64_t)0));
      bm[k * nq + g] = (int32_t)m;
      bm[(NO + k) * nq + g] = (int32_t)cums;
      cums += cnt;
    }
    bm[2 * NO * nq + g] = (int32_t)cums;
  }
  return words;
}

// The kernel's output `out` [1 + nq + 3*cap] (the candidates' total, each
// sorted row's count, then (tile slot, row, bits of d^2) rows) -> the k-d
// tree's answer (native.KdTree.radius_batch): each candidate's d^2 to its
// query recomputed from `values` as kd_radius_rec does (f32, dims in order),
// the strict d^2 < radius_sq kept, as fi (window) and fd, grouped by query in
// query order and by window within one, fc[nq] the counts.  fi and fd hold
// at least the total.  Returns the matches, -1 where the candidates passed
// cap, -2 where a query has more than per_cap matches.
int64_t sig_rescue_exact(const int32_t* out, int32_t nq, int64_t cap,
                         const int32_t* rows, const int32_t* perm,
                         const float* values, const float* queries,
                         int32_t dim, float radius_sq, int32_t per_cap,
                         int32_t* fi, float* fd, int32_t* fc) {
  const int64_t total = out[0];
  if (total > cap) return -1;
  const int32_t* cand = out + 1 + nq;
  // the candidates of each query together: a counting sort by query
  std::vector<int64_t> begin(nq + 1, 0);
  for (int r = 0; r < nq; ++r) begin[rows[r] + 1] = out[1 + r];
  for (int q = 0; q < nq; ++q) begin[q + 1] += begin[q];
  std::vector<int64_t> fill(begin.begin(), begin.end() - 1);
  std::vector<std::pair<int32_t, float>> by_q(total);
  for (int64_t c = 0; c < total; ++c) {
    float d2;
    std::memcpy(&d2, &cand[3 * c + 2], sizeof(float));
    by_q[fill[rows[cand[3 * c + 1]]]++] = {perm[cand[3 * c]], d2};
  }
  int64_t m = 0;
  for (int q = 0; q < nq; ++q) {
    std::sort(by_q.begin() + begin[q], by_q.begin() + begin[q + 1]);
    const float* qv = queries + (int64_t)q * dim;
    int32_t n = 0;
    for (int64_t c = begin[q]; c < begin[q + 1]; ++c) {
      const float* v = values + by_q[c].first;
      float acc = 0.0f;
      for (int d = 0; d < dim; ++d) {
        const float diff = qv[d] - v[d];
        acc += diff * diff;
      }
      if (acc < radius_sq) {
        fi[m] = by_q[c].first;
        fd[m] = acc;
        ++m;
        ++n;
      }
    }
    if (n > per_cap) return -2;
    fc[q] = n;
  }
  return m;
}

}  // extern "C"
