// Fused ring-band chaining + chain selection + carry-out, kernel B4, for
// Hopper.
//
// Replaces sigmap_tpu/ops/chain_fused.py:_kernel (called by chain_fused).
// One warp owns one read.  The DP is serial over the read's anchor rows
// (qpos-major, KB rows per step), but each row's predecessor search over the
// RING-slot band is split across the 32 lanes with a warp argmax, so the
// serial depth per row is RING/32 slot tests plus a 5-step reduction.
//
//   * carried rows 0..CARRY-1 only seed the ring and the best-so-far state;
//   * every KB-row block reads the ring as it stood at the block's start;
//     pushes follow in row order (the chain_fused.py dp_block contract);
//   * argmax ties go to the lowest physical ring slot; the best-so-far
//     update is strict '>' so the first row in row order wins;
//   * chain 2 is the first row achieving s2 outside chain 1's interval,
//     chain 3 the best outside both.
//
// The ring's score/t/q/g fields, read by every row, live in shared memory
// (16 B x RING per read); start_t/start_q/n/sumd, read once per row at the
// argmax slot, live directly in the carry-out arrays in device memory.  Each
// row's score and start_t go to [A, B] scratch for the selection passes.
// Bound: per row, RING slot tests of ~25 integer/f32 ops each; arithmetic is
// the reference's op by op (no FMA, IEEE division).

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxKB = 32;

struct Row {
  float s;
  int g, t, q, stt, stq, n;
  float sd;
};

struct Best {
  float s;
  int g, te, qe, stt, stq, n;
  float sd;
};

__device__ __forceinline__ void best_update(Best& b, const Row& r) {
  if (r.s > b.s) {
    b.s = r.s;
    b.g = r.g;
    b.te = r.t;
    b.qe = r.q;
    b.stt = r.stt;
    b.stq = r.stq;
    b.n = r.n;
    b.sd = r.sd;
  }
}

__global__ void chain_fused_kernel(
    const int* __restrict__ a_t, const int* __restrict__ a_q,
    const float* __restrict__ a_d, const int* __restrict__ a_g,
    const float* __restrict__ c_score, const int* __restrict__ c_stt,
    const int* __restrict__ c_stq, const int* __restrict__ c_n,
    const float* __restrict__ c_sumd, int A, int B, int CARRY, int RING,
    int KB, float radius, int dim, int max_gap, int max_tgap,
    float max_gap_scale, float min_gap_scale, float* __restrict__ sum_f,
    int* __restrict__ sum_i, int* __restrict__ o_t, int* __restrict__ o_q,
    int* __restrict__ o_g, float* __restrict__ o_score,
    int* __restrict__ o_stt, int* __restrict__ o_stq, int* __restrict__ o_n,
    float* __restrict__ o_sumd, float* __restrict__ scores,
    int* __restrict__ stt_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps exit together

  unsigned char* base = smem_raw + (size_t)warp * (16 * RING + sizeof(Row) * kMaxKB);
  float* r_s = reinterpret_cast<float*>(base);
  int* r_t = reinterpret_cast<int*>(base + 4 * RING);
  int* r_q = reinterpret_cast<int*>(base + 8 * RING);
  int* r_g = reinterpret_cast<int*>(base + 12 * RING);
  Row* rows = reinterpret_cast<Row*>(base + 16 * RING);

  for (int j = lane; j < RING; j += 32) {
    r_s[j] = kNeg;
    r_t[j] = -(1 << 30);
    r_q[j] = 0;
    r_g[j] = -2;
    const size_t o = (size_t)j * B + b;
    o_stt[o] = 0;
    o_stq[o] = 0;
    o_n[o] = 0;
    o_sumd[o] = 0.0f;
  }
  Best best{kNeg, -1, 0, 0, 0, 0, 0, 0.0f};
  int cur = 0;

  // lane 0 pushes one row state into the ring (ring slot = cur % RING)
  auto push = [&](const Row& r) {
    const int slot = cur % RING;
    r_s[slot] = r.s;
    r_t[slot] = r.t;
    r_q[slot] = r.q;
    r_g[slot] = r.g;
    const size_t o = (size_t)slot * B + b;
    o_stt[o] = r.stt;
    o_stq[o] = r.stq;
    o_n[o] = r.n;
    o_sumd[o] = r.sd;
    ++cur;
  };

  __syncwarp();
  // ---- carried rows: seed the ring and the best-so-far state ------------
  if (lane == 0) {
    for (int i = 0; i < CARRY; ++i) {
      const size_t o = (size_t)i * B + b;
      Row r;
      r.g = a_g[o];
      r.t = a_t[o];
      r.q = a_q[o];
      const bool v = r.g >= 0;
      r.s = v ? c_score[o] : kNeg;
      r.stt = c_stt[o];
      r.stq = c_stq[o];
      r.n = c_n[o];
      r.sd = c_sumd[o];
      scores[o] = r.s;
      stt_s[o] = r.stt;
      best_update(best, r);
      if (v) push(r);
    }
  }
  __threadfence_block();
  __syncwarp();

  // ---- DP over KB-row blocks --------------------------------------------
  const int nblk = (A - CARRY) / KB;
  for (int blk = 0; blk < nblk; ++blk) {
    const int i0 = CARRY + blk * KB;
    for (int k = 0; k < KB; ++k) {
      const size_t o = (size_t)(i0 + k) * B + b;
      const int t = a_t[o];
      const int q = a_q[o];
      const float d = a_d[o];
      const int g = a_g[o];
      const bool v = g >= 0;
      float bestc = kNeg;
      int bi = 0;
      float init = 0.0f;
      if (v) {
        // coef = 1 - 0.2*d/radius, evaluated as 1 - ((0.2*d)/radius)
        const float coef =
            __fsub_rn(1.0f, __fdiv_rn(__fmul_rn(0.2f, d), radius));
        init = __fmul_rn(coef, (float)dim);
        float bv = -3.0e38f;  // below kNeg: the first slot always registers
        int bj = RING;
        for (int j = lane; j < RING; j += 32) {
          const int rt = r_t[j];
          const int rq = r_q[j];
          const int tdiff = t - rt;
          const int qdiff = q - rq;
          bool ok = (r_g[j] == g) && (tdiff > 0) && (qdiff > 0) &&
                    (rt + max_tgap >= t);
          const int gap = abs(tdiff - qdiff);
          const float gs =
              tdiff > 0 ? __fdiv_rn((float)qdiff, (float)tdiff) : 1.0f;
          ok = ok && (gap < max_gap) && (gs < max_gap_scale) &&
               (gs > min_gap_scale);
          const int mn = min(min(tdiff, qdiff), dim);
          const float md = __fmul_rn((float)mn, coef);
          const float cand = ok ? __fadd_rn(r_s[j], md) : kNeg;
          if (cand > bv) {  // ascending j: lowest slot on ties
            bv = cand;
            bj = j;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
          if (ov > bv || (ov == bv && oj < bj)) {
            bv = ov;
            bj = oj;
          }
        }
        bestc = bv;
        bi = bj;
      }
      if (lane == 0) {
        Row r;
        r.g = g;
        r.t = t;
        r.q = q;
        const bool chained = v && (bestc > init);
        r.s = v ? (chained ? bestc : init) : kNeg;
        if (chained) {
          const size_t ob = (size_t)bi * B + b;
          r.stt = o_stt[ob];
          r.stq = o_stq[ob];
          r.n = o_n[ob] + 1;
          r.sd = __fadd_rn(o_sumd[ob], d);
        } else {
          r.stt = t;
          r.stq = q;
          r.n = 1;
          r.sd = d;
        }
        rows[k] = r;
        scores[o] = r.s;
        stt_s[o] = r.stt;
      }
    }
    // pushes after the whole block: every row above read the block-start
    // ring
    if (lane == 0) {
      for (int k = 0; k < KB; ++k) {
        const Row r = rows[k];
        best_update(best, r);
        if (r.g >= 0) push(r);
      }
    }
    __threadfence_block();
    __syncwarp();
  }

  // ---- chain selection passes over all A rows ----------------------------
  const int g1 = __shfl_sync(0xffffffffu, best.g, 0);
  const int stt1 = __shfl_sync(0xffffffffu, best.stt, 0);
  const int te1 = __shfl_sync(0xffffffffu, best.te, 0);

  float s2 = kNeg;
  for (int i = lane; i < A; i += 32) {
    const size_t o = (size_t)i * B + b;
    const int g = a_g[o];
    const bool excl = ((g >> 1) == (g1 >> 1)) &&
                      (max(stt_s[o], stt1) <= min(a_t[o], te1));
    s2 = fmaxf(s2, excl ? kNeg : scores[o]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s2 = fmaxf(s2, __shfl_xor_sync(0xffffffffu, s2, off));

  int first = A;
  for (int i = lane; i < A; i += 32) {
    const size_t o = (size_t)i * B + b;
    const int g = a_g[o];
    const float sc = scores[o];
    const bool excl = ((g >> 1) == (g1 >> 1)) &&
                      (max(stt_s[o], stt1) <= min(a_t[o], te1));
    if (!excl && sc == s2 && sc > kNeg * 0.5f) {
      first = i;
      break;  // rows ascend per lane
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
  const bool found2 = first < A;
  int g2 = -1, stt2 = 0, te2 = 0;
  if (found2) {
    const size_t o = (size_t)first * B + b;
    g2 = a_g[o];
    stt2 = stt_s[o];
    te2 = a_t[o];
  }

  float s3 = kNeg;
  for (int i = lane; i < A; i += 32) {
    const size_t o = (size_t)i * B + b;
    const int g = a_g[o];
    const int st = stt_s[o];
    const int t = a_t[o];
    const bool excl1 =
        ((g >> 1) == (g1 >> 1)) && (max(st, stt1) <= min(t, te1));
    const bool excl2 = found2 && ((g >> 1) == (g2 >> 1)) &&
                       (max(st, stt2) <= min(t, te2));
    s3 = fmaxf(s3, (excl1 || excl2) ? kNeg : scores[o]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s3 = fmaxf(s3, __shfl_xor_sync(0xffffffffu, s3, off));

  if (lane == 0) {
    sum_f[0 * B + b] = best.s;
    sum_f[1 * B + b] = s2;
    sum_f[2 * B + b] = best.sd;
    sum_f[3 * B + b] = s3;
    for (int r = 4; r < 8; ++r) sum_f[(size_t)r * B + b] = 0.0f;
    sum_i[0 * B + b] = best.g;
    sum_i[1 * B + b] = best.stt;
    sum_i[2 * B + b] = best.te;
    sum_i[3 * B + b] = best.stq;
    sum_i[4 * B + b] = best.qe;
    sum_i[5 * B + b] = best.n;
    sum_i[6 * B + b] = 0;
    sum_i[7 * B + b] = 0;
  }
  for (int j = lane; j < RING; j += 32) {
    const size_t o = (size_t)j * B + b;
    o_score[o] = r_s[j];
    o_t[o] = r_t[j];
    o_q[o] = r_q[j];
    o_g[o] = r_g[j];
  }
}

}  // namespace

extern "C" int sig_chain_fused_launch(
    const int* a_t, const int* a_q, const float* a_d, const int* a_g,
    const float* c_score, const int* c_stt, const int* c_stq, const int* c_n,
    const float* c_sumd, int A, int B, int CARRY, int RING, int KB,
    float radius, int dim, int max_gap, int max_tgap, float max_gap_scale,
    float min_gap_scale, float* sum_f, int* sum_i, int* o_t, int* o_q,
    int* o_g, float* o_score, int* o_stt, int* o_stq, int* o_n,
    float* o_sumd, float* scores, int* stt_s, void* stream) {
  if (B <= 0) return 0;
  if (KB < 1 || KB > kMaxKB || (A - CARRY) % KB != 0 || RING < 1) return 1;
  const size_t smem =
      (size_t)kWarpsPerBlock * (16 * RING + sizeof(Row) * kMaxKB);
  cudaError_t e = cudaFuncSetAttribute(
      chain_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chain_fused_kernel<<<blocks, 32 * kWarpsPerBlock, smem,
                       (cudaStream_t)stream>>>(
      a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd, A, B, CARRY,
      RING, KB, radius, dim, max_gap, max_tgap, max_gap_scale, min_gap_scale,
      sum_f, sum_i, o_t, o_q, o_g, o_score, o_stt, o_stq, o_n, o_sumd, scores,
      stt_s);
  return (int)cudaGetLastError();
}
