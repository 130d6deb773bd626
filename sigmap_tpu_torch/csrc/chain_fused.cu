// Fused ring-band chaining + chain selection + carry-out, kernel B4, for
// Hopper.
//
// Replaces sigmap_tpu/ops/chain_fused.py:_kernel (called by chain_fused).
// One block of kWarps warps owns one read and keeps what the read touches in
// shared memory: all eight fields of the RING-slot ring, and its anchor rows
// (staged with cp.async, a thread a row, so no row of the DP waits for device
// memory).  A read comes in one of two ways:
//
//   * whole (every read that fits a block's 227 KB with its ring, the
//     operating point among them): all A rows at once, and each row's score
//     and chain start kept beside them for the selection passes (they take
//     the place of the staged a_d and a_q, which a finished row no longer
//     needs).  Nothing of the read goes to device memory until the carry-out
//     is written once at the end;
//   * in windows of W new rows (W a multiple of KB, so that no KB-row block
//     spans two windows), double-buffered: window w + 1 arrives by cp.async
//     while the DP runs on window w, so only the ring and two windows must
//     fit, whatever A.  The carried rows are read from device memory as they
//     seed the ring.  Each valid row's selection fields (t, g, chain start,
//     score) go to a per-read scratch [B, A] int4 at the row's rank among the
//     read's valid rows (the push count, so a block writes consecutive
//     addresses), and the selection passes stream the read's valid rows back
//     from it: 16 B a valid row written once and read twice or three times.
//     An invalid row's score is kNeg, so leaving it out changes no maximum
//     and no first row.
//
// The DP is serial over the read's KB-row blocks (qpos-major), and the KB
// rows of a block are independent: every row reads the ring as it stood at
// the block's start.  So the block's rows are evaluated together against one
// read of the ring, and the serial depth is (A - CARRY) / KB steps, not
// A - CARRY: the 256 threads split the ring's slots, a thread loads a slot's
// (score, t, q, g) with one 16-byte load and tests it against every valid
// row of the block.  Nearly every (slot, row) pair is refused by two
// compares on registers: the slot's g against the row's, and the slot's
// target bucket (t >> tshift, buckets no narrower than the target gap)
// against the bucket of the row's t - 1 and the one before, outside which
// no slot can be in the row's target window.  The integer gates proper (0 <
// tdiff <= target gap, qdiff > 0, |tdiff - qdiff|) follow as two unsigned
// range compares and a plain one; the IEEE division, the gap-scale test and
// the score run only for the few slots that pass them.  A refused slot
// contributes kNeg whatever its quotient, so the result is the reference's
// bit for bit.  Only the filled part of the ring is scanned (slots 0 ..
// min(cur, RING) - 1; an unfilled slot holds g = -2 and can never pass), and
// a block without a valid row is skipped at once (one bit mask a block,
// built as the rows arrive).
// Warp 0 joins the warps' partial maxima, a lane a row: the rows are built,
// pushed and compared with the best so far by the lanes that own them.
//
//   * carried rows 0..CARRY-1 only seed the ring and the best-so-far state;
//   * pushes follow in row order after the whole block: each row's slot is
//     cur + (valid rows before it in the block), a later push that lands on
//     the same slot wins (only the last RING valid rows of a block push);
//   * argmax ties go to the lowest physical ring slot; the best-so-far
//     update is strict '>' so the first row in row order wins;
//   * chain 2 is the first row achieving s2 outside chain 1's interval,
//     chain 3 the best outside both.
//
// Bound: per valid row, min(cur, RING) slot tests: ~3 integer ops to refuse
// a slot by its g or target gap, ~25 integer/f32 ops for one that passes
// both (operations; the bytes are each input and output once).  Arithmetic
// is the reference's op by op (no FMA, IEEE division).  A valid anchor's
// distance is below the search radius, so its stand-alone score coef * dim is
// far above kNeg: a row whose every slot is refused never chains.
//
// Shared memory (sig_chain_fused_smem gives it): 32 B x RING + 16 B x A +
// 4 B x blocks for a whole read (72,356 B at RING 768, A 2816, KB 8: three
// blocks of 8 warps an SM); 32 B x RING + 32 B x W + 4 B x (W / KB) in
// windows, whatever A.  What stays refused is a ring that does not fit
// beside a window of KB rows (some 7,200 slots).

#include <cuda_runtime.h>
#include <climits>

#include "cp_async.cuh"

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxKB = 32;
constexpr int kRowsPerPass = 8;  // rows of a block a warp holds in registers
constexpr unsigned kFull = 0xffffffffu;

// one row's state; two 16-byte halves, the layout of the ring's two arrays
struct __align__(16) Row {
  float s;
  int t, q, g;
  int stt, stq, n;
  float sd;
};

__device__ __forceinline__ int4 row_a(const Row& r) {
  return make_int4(__float_as_int(r.s), r.t, r.q, r.g);
}

__device__ __forceinline__ int4 row_b(const Row& r) {
  return make_int4(r.stt, r.stq, r.n, __float_as_int(r.sd));
}

// an int that orders as the float does (-0 counts as +0), for redux.sync
__device__ __forceinline__ int float_key(float f) {
  const int b = __float_as_int(__fadd_rn(f, 0.0f));
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// warp argmax of (v, lowest j on ties); every lane gets the result
__device__ __forceinline__ void warp_argmax(float& v, int& j) {
  const int key = float_key(v);
  const int m = __reduce_max_sync(kFull, key);
  j = __reduce_min_sync(kFull, key == m ? j : INT_MAX);
  v = key_float(m);
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_min(int v, int* red) {
  v = __reduce_min_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v = min(v, red[w]);
  __syncthreads();
  return v;
}

// dynamic shared memory of a block: the ring, the row, candidate and
// reduction buffers, and either the whole read (W == 0) or two windows of W
// rows with the masks of one
__host__ __device__ inline size_t smem_bytes(int A, int CARRY, int RING,
                                             int KB, int W) {
  const size_t fixed = (size_t)(2 * 16 + 8) * kMaxKB +
                       sizeof(Row) * (kWarps + 1) + 4 * 2 * kWarps + 64;
  if (W == 0)
    return (size_t)32 * RING + (size_t)16 * A +
           (size_t)4 * ((A - CARRY) / KB + 1) + fixed;
  return (size_t)32 * RING + (size_t)32 * W + (size_t)4 * (W / KB + 1) +
         fixed;
}

template <bool kWin>
__global__ void __launch_bounds__(kThreads, 3) chain_fused_kernel(
    const int* __restrict__ a_t, const int* __restrict__ a_q,
    const float* __restrict__ a_d, const int* __restrict__ a_g,
    const float* __restrict__ c_score, const int* __restrict__ c_stt,
    const int* __restrict__ c_stq, const int* __restrict__ c_n,
    const float* __restrict__ c_sumd, int A, int B, int CARRY, int RING,
    int KB, int W, float radius, int dim, int max_gap, int max_tgap,
    float max_gap_scale, float min_gap_scale, int4* __restrict__ scratch,
    float* __restrict__ sum_f, int* __restrict__ sum_i, int* __restrict__ o_t,
    int* __restrict__ o_q, int* __restrict__ o_g, float* __restrict__ o_score,
    int* __restrict__ o_stt, int* __restrict__ o_stq, int* __restrict__ o_n,
    float* __restrict__ o_sumd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  const int NEW = A - CARRY;
  // rows an anchor-field array holds: the whole read, or one window
  const int NR = kWin ? W : A;

  int4* ring_a = reinterpret_cast<int4*>(smem_raw);  // score, t, q, g
  int4* ring_b = ring_a + RING;                      // stt, stq, n, sumd
  // (t, q, g, coef) of a block's KB rows, this block's and the next one's
  int4* rowp = ring_b + RING;
  // a row's best candidate of the block: (score key, INT_MAX - slot), 0 none
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(rowp + 2 * kMaxKB);
  // a best carried row a warp, then [kWarps] the read's best row
  Row* wbest = reinterpret_cast<Row*>(cand + kMaxKB);
  // whole: t, q (then each row's stt), d (then each row's score), g of the
  // A rows; windowed: the same four arrays of W rows, twice
  int* s_t = reinterpret_cast<int*>(wbest + kWarps + 1);
  int* s_q = s_t + NR;
  float* s_d = reinterpret_cast<float*>(s_q + NR);
  int* s_g = reinterpret_cast<int*>(s_d + NR);
  unsigned* blkmask = reinterpret_cast<unsigned*>(s_g + NR + (kWin ? 4 * W : 0));
  int* red = reinterpret_cast<int*>(blkmask + (kWin ? W : NEW) / KB + 1);
  // the read's selection fields (t, g, stt, score) by valid-row rank
  int4* sel_rows = kWin ? scratch + (size_t)b * A : nullptr;

  // ---- stage the anchors: a thread a row, all loads in flight ------------
  // (windowed: window w's rows, into buffer w & 1)
  auto stage = [&](int* dst, int r0, int n) {
    for (int l = tid; l < n; l += kThreads) {
      const size_t o = (size_t)(r0 + l) * B + b;
      cp_async4(dst + l, a_t + o);
      cp_async4(dst + NR + l, a_q + o);
      cp_async4(dst + 2 * NR + l, a_d + o);
      cp_async4(dst + 3 * NR + l, a_g + o);
    }
    cp_async_commit();
  };
  const int nwin = kWin ? (NEW + W - 1) / W : 1;
  auto window = [&](int w) { return s_t + (kWin ? (w & 1) * 4 * W : CARRY); };
  auto window_rows = [&](int w) { return kWin ? min(W, NEW - w * W) : NEW; };
  if (kWin) {
    if (nwin > 0) stage(window(0), CARRY, window_rows(0));
  } else {
    stage(s_t, 0, A);
    cp_async_wait<0>();
    __syncthreads();
  }

  // valid rows of each KB-row block of a window (t, q, d, g at `win`), one
  // bit a row; an invalid row's score is kNeg from here on
  auto build_masks = [&](int* win, int nblk) {
    for (int blk = tid; blk < nblk; blk += kThreads) {
      unsigned m = 0;
      for (int k = 0; k < KB; ++k) {
        const int l = blk * KB + k;
        if (win[3 * NR + l] >= 0)
          m |= 1u << k;
        else
          reinterpret_cast<float*>(win)[2 * NR + l] = kNeg;
      }
      blkmask[blk] = m;
    }
  };
  if (!kWin) build_masks(window(0), NEW / KB);

  // ---- carried rows: seed the ring and the best-so-far state --------------
  int cur = 0;  // valid rows pushed so far; the same in every thread
  Row mine{kNeg, 0, 0, -1, 0, 0, 0, 0.0f};  // this thread's best carried row
  int mine_i = INT_MAX;
  for (int base = 0; base < CARRY; base += kThreads) {
    const int i = base + tid;
    Row r{kNeg, 0, 0, -1, 0, 0, 0, 0.0f};
    bool v = false;
    if (i < CARRY) {
      const size_t o = (size_t)i * B + b;
      r.g = kWin ? a_g[o] : s_g[i];
      r.t = kWin ? a_t[o] : s_t[i];
      r.q = kWin ? a_q[o] : s_q[i];
      v = r.g >= 0;
      r.s = v ? c_score[o] : kNeg;
      r.stt = c_stt[o];
      r.stq = c_stq[o];
      r.n = c_n[o];
      r.sd = c_sumd[o];
      if (!kWin) {
        s_d[i] = r.s;
        s_q[i] = r.stt;
      }
      if (r.s > mine.s) {  // ascending rows: the first of equals stays
        mine = r;
        mine_i = i;
      }
    }
    const unsigned bal = __ballot_sync(kFull, v);
    if (lane == 0) red[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = red[w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int rank = cur + before + __popc(bal & ((1u << lane) - 1u));
    if (kWin && v)
      __stcg(sel_rows + rank, make_int4(r.t, r.g, r.stt, __float_as_int(r.s)));
    // of the rows that land on one slot the last wins: the earlier ones of
    // this pass stay out, a later pass overwrites after the barrier
    if (v && cur + total - rank <= RING) {
      const int slot = rank % RING;
      ring_a[slot] = row_a(r);
      ring_b[slot] = row_b(r);
    }
    cur += total;
    __syncthreads();
  }
  // the read's best carried row: the highest score, the lowest row on ties
  {
    float v = mine.s;
    int j = mine_i;
    warp_argmax(v, j);
    if (j == mine_i && (j != INT_MAX || lane == 0)) {
      wbest[warp] = mine;
      red[warp] = j;
    }
  }
  // (joined with the best new row after the DP; the barriers below order it)

  // ---- DP over KB-row blocks ----------------------------------------------
  // The 256 threads split the filled slots (j = tid, tid + 256, ...): a
  // thread holds its slot in registers and tests it against every valid row
  // of the block, kRowsPerPass rows at a time.  A row's best candidate goes
  // to shared memory as one atomic max of (score, lowest slot) a warp that
  // has any.  Then warp 0 finishes the block, a lane a row: the lanes build
  // their rows and push them, while warp 1 prepares the next block's rows.
  // What every block waits for is this chain of steps, so it is kept short:
  // no modulo lies on it, and a division or a warp reduction only for a slot
  // that passed the integer gates.
  const unsigned utgap = (unsigned)max(max_tgap, 0);
  const unsigned ugap = max_gap > 0 ? 2u * (unsigned)max_gap - 1u : 0u;
  // target buckets of 2^tshift >= max_tgap positions: a window of max_tgap
  // positions touches at most two
  const int tshift = utgap <= 1u ? 0 : 32 - __clz((int)utgap - 1);

  Row mb{kNeg, 0, 0, -1, 0, 0, 0, 0.0f};  // warp 0: this lane's best new row
  int mb_i = INT_MAX;
  int head = cur % RING;  // the slot the next push takes

  // the DP over one window: its rows' t, q, d, g at `win`, `nblk` blocks,
  // its row 0 is the read's row i0w
  auto run_dp = [&](int* win, int nblk, int i0w) {
    const int* w_t = win;
    int* w_q = win + NR;
    float* w_d = reinterpret_cast<float*>(win + 2 * NR);
    const int* w_g = win + 3 * NR;
    // (t, q, g, coef) of a block's valid rows into rowp[par], by warp 1, a
    // lane a row; coef = 1 - 0.2*d/radius, evaluated as 1 - ((0.2*d)/radius)
    auto prepare = [&](int blk, int par) {
      if (warp == 1 && lane < KB && blk < nblk &&
          ((blkmask[blk] >> lane) & 1u)) {
        const int l = blk * KB + lane;
        const float coef =
            __fsub_rn(1.0f, __fdiv_rn(__fmul_rn(0.2f, w_d[l]), radius));
        rowp[par * kMaxKB + lane] =
            make_int4(w_t[l], w_q[l], w_g[l], __float_as_int(coef));
      }
    };
    auto next_block = [&](int blk) {  // the first block >= blk with a valid row
      while (blk < nblk && blkmask[blk] == 0u) ++blk;
      return blk;
    };

    int par = 0;
    int blk = next_block(0);
    prepare(blk, par);
    if (tid < kMaxKB) cand[tid] = 0ull;
    __syncthreads();
    while (blk < nblk) {
      const unsigned mask = blkmask[blk];
      const int l0 = blk * KB;
      const int nfill = min(cur, RING);
      const int4* rp = rowp + par * kMaxKB;
      for (int k0 = 0; k0 < KB; k0 += kRowsPerPass) {
        const unsigned m8 = (mask >> k0) & ((1u << kRowsPerPass) - 1u);
        if (m8 == 0u) continue;
        int rb[kRowsPerPass], rg[kRowsPerPass], bj[kRowsPerPass];
        float bv[kRowsPerPass];
#pragma unroll
        for (int u = 0; u < kRowsPerPass; ++u) {
          bv[u] = kNeg;
          bj[u] = INT_MAX;
          if ((m8 >> u) & 1u) {
            const int4 r = rp[k0 + u];
            rb[u] = (r.x - 1) >> tshift;
            rg[u] = r.z;
          }
        }
        unsigned hit = 0u;  // rows this thread found a candidate for
        for (int j = tid; j < nfill; j += kThreads) {
          const int4 a = ring_a[j];  // score, t, q, g
          const int ab = a.y >> tshift;
#pragma unroll
          for (int u = 0; u < kRowsPerPass; ++u) {
            if (((m8 >> u) & 1u) == 0u) continue;
            // a slot in the row's target window (0 < tdiff <= max_tgap) lies
            // in the bucket of t - 1 or the one before, with the row's g:
            // two compares refuse nearly every slot
            if (a.w != rg[u] || (unsigned)(rb[u] - ab) >= 2u) continue;
            const int4 r = rp[k0 + u];  // t, q, g, coef
            // 0 < tdiff <= max_tgap, qdiff > 0, |tdiff - qdiff| < max_gap,
            // the two ranges as one unsigned compare each
            const int tdiff = r.x - a.y;
            const int qdiff = r.y - a.z;
            if (((unsigned)(tdiff - 1) < utgap) && (qdiff > 0) &&
                ((unsigned)(tdiff - qdiff + max_gap - 1) < ugap)) {
              const float gs = __fdiv_rn((float)qdiff, (float)tdiff);
              if ((gs < max_gap_scale) && (gs > min_gap_scale)) {
                const int mn = min(min(tdiff, qdiff), dim);
                const float c =
                    __fadd_rn(__int_as_float(a.x),
                              __fmul_rn((float)mn, __int_as_float(r.w)));
                if (c > bv[u]) {  // ascending j: lowest slot on ties
                  bv[u] = c;
                  bj[u] = j;
                  hit |= 1u << u;
                }
              }
            }
          }
        }
        hit = __reduce_or_sync(kFull, hit);  // mostly none, or the one true row
#pragma unroll
        for (int u = 0; u < kRowsPerPass; ++u) {
          if (((hit >> u) & 1u) == 0u) continue;
          warp_argmax(bv[u], bj[u]);
          if (lane == 0)
            atomicMax(cand + k0 + u,
                      ((unsigned long long)((unsigned)float_key(bv[u]) ^
                                            0x80000000u)
                       << 32) |
                          (unsigned)(INT_MAX - bj[u]));
        }
      }
      __syncthreads();  // every row has met the block-start ring
      const int nval = __popc(mask);
      const int nb = next_block(blk + 1);
      if (warp == 0) {
        const bool v = lane < KB && ((mask >> lane) & 1u);
        const int rank = __popc(mask & ((1u << lane) - 1u));
        Row r{kNeg, 0, 0, -1, 0, 0, 0, 0.0f};
        if (v) {
          const int l = l0 + lane;
          const unsigned long long c = cand[lane];
          cand[lane] = 0ull;
          const int4 row = rp[lane];
          const float d = w_d[l];
          const float coef = __int_as_float(row.w);
          const float init = __fmul_rn(coef, (float)dim);
          // float_key orders as a signed int, the packed word as unsigned:
          // its sign bit is flipped going in and coming out
          const float bvk =
              c ? key_float((int)((unsigned)(c >> 32) ^ 0x80000000u)) : kNeg;
          r.t = row.x;
          r.q = row.y;
          r.g = row.z;
          if (bvk > init) {
            const int4 pr = ring_b[INT_MAX - (int)(unsigned)c];  // stt stq n sumd
            r.s = bvk;
            r.stt = pr.x;
            r.stq = pr.y;
            r.n = pr.z + 1;
            r.sd = __fadd_rn(__int_as_float(pr.w), d);
          } else {
            r.s = init;
            r.stt = r.t;
            r.stq = r.q;
            r.n = 1;
            r.sd = d;
          }
          if (kWin) {
            __stcg(sel_rows + cur + rank,
                   make_int4(r.t, r.g, r.stt, __float_as_int(r.s)));
          } else {
            w_d[l] = r.s;
            w_q[l] = r.stt;
          }
          if (r.s > mb.s) {  // this lane's rows ascend: the first of equals
            mb = r;
            mb_i = i0w + l;
          }
        }
        __syncwarp();  // every row is built before a push overwrites a slot
        if (v && nval - rank <= RING) {
          int slot = head + rank;
          while (slot >= RING) slot -= RING;
          ring_a[slot] = row_a(r);
          ring_b[slot] = row_b(r);
        }
      }
      par ^= 1;
      prepare(nb, par);
      cur += nval;
      head += nval;
      while (head >= RING) head -= RING;
      blk = nb;
      __syncthreads();  // pushes and the next rows land before the next scan
    }
  };

  if (!kWin) {
    run_dp(window(0), NEW / KB, CARRY);
  } else {
    for (int w = 0; w < nwin; ++w) {
      cp_async_wait<0>();
      // window w is in, for every thread; window w - 1, whose buffer the
      // next copies overwrite, is done (run_dp ends on a barrier)
      __syncthreads();
      if (w + 1 < nwin) stage(window(w + 1), CARRY + (w + 1) * W,
                              window_rows(w + 1));
      build_masks(window(w), window_rows(w) / KB);
      __syncthreads();
      run_dp(window(w), window_rows(w) / KB, CARRY + w * W);
    }
    __syncthreads();  // the best carried rows are in, even with no window
  }

  // ---- the read's best row: the highest score, the lowest row on ties -----
  // (strict '>' in row order keeps the first row that reaches the maximum)
  Row* best_s = wbest + kWarps;
  if (warp == 0) {
    if (lane < kWarps) {
      const Row c = wbest[lane];
      const int ci = red[lane];
      if (c.s > mb.s || (c.s == mb.s && ci < mb_i)) {
        mb = c;
        mb_i = ci;
      }
    }
    float v = mb.s;
    int j = mb_i;
    warp_argmax(v, j);
    if (j == mb_i && (j != INT_MAX || lane == 0)) *best_s = mb;
  }
  __syncthreads();
  const int g1 = best_s->g;
  const int stt1 = best_s->stt;
  const int te1 = best_s->t;
  float* fred = reinterpret_cast<float*>(red + kWarps);

  // ---- chains 2 and 3 over the selection fields of the rows ----------------
  // whole: every row from shared memory; windowed: the valid rows, in row
  // order, from the scratch (visible to the block after the barriers above)
  const int nsel = kWin ? cur : A;
  auto sel = [&](int i) {  // t, g, chain start, score of row i
    if (kWin) return __ldcg(sel_rows + i);
    return make_int4(s_t[i], s_g[i], s_q[i], __float_as_int(s_d[i]));
  };

  float s2 = kNeg;
  for (int i = tid; i < nsel; i += kThreads) {
    const int4 f = sel(i);
    const bool excl = ((f.y >> 1) == (g1 >> 1)) &&
                      (max(f.z, stt1) <= min(f.x, te1));
    s2 = fmaxf(s2, excl ? kNeg : __int_as_float(f.w));
  }
  s2 = block_max(s2, fred);

  int first = nsel;
  for (int i = tid; i < nsel; i += kThreads) {
    const int4 f = sel(i);
    const float sc = __int_as_float(f.w);
    const bool excl = ((f.y >> 1) == (g1 >> 1)) &&
                      (max(f.z, stt1) <= min(f.x, te1));
    if (!excl && sc == s2 && sc > kNeg * 0.5f) {
      first = i;
      break;  // rows ascend per thread
    }
  }
  first = block_min(first, red);
  const bool found2 = first < nsel;
  int g2 = -1, stt2 = 0, te2 = 0;
  if (found2) {
    const int4 f = sel(first);
    g2 = f.y;
    stt2 = f.z;
    te2 = f.x;
  }

  float s3 = kNeg;
  for (int i = tid; i < nsel; i += kThreads) {
    const int4 f = sel(i);
    const bool excl1 =
        ((f.y >> 1) == (g1 >> 1)) && (max(f.z, stt1) <= min(f.x, te1));
    const bool excl2 = found2 && ((f.y >> 1) == (g2 >> 1)) &&
                       (max(f.z, stt2) <= min(f.x, te2));
    s3 = fmaxf(s3, (excl1 || excl2) ? kNeg : __int_as_float(f.w));
  }
  s3 = block_max(s3, fred);

  // ---- summaries and the carry-out ring, written once ----------------------
  if (tid == 0) {
    const Row w = *best_s;
    sum_f[0 * B + b] = w.s;
    sum_f[1 * B + b] = s2;
    sum_f[2 * B + b] = w.sd;
    sum_f[3 * B + b] = s3;
    for (int r = 4; r < 8; ++r) sum_f[(size_t)r * B + b] = 0.0f;
    sum_i[0 * B + b] = w.g;
    sum_i[1 * B + b] = w.stt;
    sum_i[2 * B + b] = w.t;
    sum_i[3 * B + b] = w.stq;
    sum_i[4 * B + b] = w.q;
    sum_i[5 * B + b] = w.n;
    sum_i[6 * B + b] = 0;
    sum_i[7 * B + b] = 0;
  }
  const int nfill = min(cur, RING);
  for (int j = tid; j < RING; j += kThreads) {
    // an unfilled slot: no score, a target no gap reaches, group -2
    int4 a = make_int4(__float_as_int(kNeg), -(1 << 30), 0, -2);
    int4 p = make_int4(0, 0, 0, __float_as_int(0.0f));
    if (j < nfill) {
      a = ring_a[j];
      p = ring_b[j];
    }
    const size_t o = (size_t)j * B + b;
    o_score[o] = __int_as_float(a.x);
    o_t[o] = a.y;
    o_q[o] = a.z;
    o_g[o] = a.w;
    o_stt[o] = p.x;
    o_stq[o] = p.y;
    o_n[o] = p.z;
    o_sumd[o] = __int_as_float(p.w);
  }
}

template <bool kWin>
int launch(const int* a_t, const int* a_q, const float* a_d, const int* a_g,
           const float* c_score, const int* c_stt, const int* c_stq,
           const int* c_n, const float* c_sumd, int A, int B, int CARRY,
           int RING, int KB, int W, float radius, int dim, int max_gap,
           int max_tgap, float max_gap_scale, float min_gap_scale,
           int4* scratch, float* sum_f, int* sum_i, int* o_t, int* o_q,
           int* o_g, float* o_score, int* o_stt, int* o_stq, int* o_n,
           float* o_sumd, cudaStream_t stream) {
  const size_t smem = smem_bytes(A, CARRY, RING, KB, W);
  cudaError_t e = cudaFuncSetAttribute(
      chain_fused_kernel<kWin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  chain_fused_kernel<kWin><<<B, kThreads, smem, stream>>>(
      a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd, A, B, CARRY,
      RING, KB, W, radius, dim, max_gap, max_tgap, max_gap_scale,
      min_gap_scale, scratch, sum_f, sum_i, o_t, o_q, o_g, o_score, o_stt,
      o_stq, o_n, o_sumd);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory a block needs at these sizes, in bytes (W = 0: the
// whole read at once; W > 0: windows of W new rows)
extern "C" long long sig_chain_fused_smem(int A, int CARRY, int RING, int KB,
                                          int W) {
  return (long long)smem_bytes(A, CARRY, RING, KB, W);
}

// W = 0 stages the whole read; W > 0 (a multiple of KB) streams it in
// windows of W new rows and needs `scratch`, [B, A] int4
extern "C" int sig_chain_fused_launch(
    const int* a_t, const int* a_q, const float* a_d, const int* a_g,
    const float* c_score, const int* c_stt, const int* c_stq, const int* c_n,
    const float* c_sumd, int A, int B, int CARRY, int RING, int KB, int W,
    float radius, int dim, int max_gap, int max_tgap, float max_gap_scale,
    float min_gap_scale, void* scratch, float* sum_f, int* sum_i, int* o_t,
    int* o_q, int* o_g, float* o_score, int* o_stt, int* o_stq, int* o_n,
    float* o_sumd, void* stream) {
  if (B <= 0) return 0;
  if (KB < 1 || KB > kMaxKB || (A - CARRY) % KB != 0 || RING < 1 || W < 0 ||
      W % KB != 0 || (W > 0 && scratch == nullptr))
    return 1;
  auto* go = W > 0 ? launch<true> : launch<false>;
  return go(a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd, A, B,
            CARRY, RING, KB, W, radius, dim, max_gap, max_tgap, max_gap_scale,
            min_gap_scale, static_cast<int4*>(scratch), sum_f, sum_i, o_t, o_q,
            o_g, o_score, o_stt, o_stq, o_n, o_sumd, (cudaStream_t)stream);
}
