// Sweep radius search, kernel B3, for Hopper.
//
// Replaces sigmap_tpu/ops/sweep_kernel.py:_kernel (called by sweep_search):
// the streaming merge-join between blocks of cell-key-sorted seeds and the
// cell-sorted, pre-tiled window store.  One CTA owns one seed block and walks
// the block's union of tile ranges in ascending tile order (decoded from the
// [2*NO+1, G] block table built by mapping/sweep_search.py).  Per seed and
// tile, exactly as the reference:
//
//   * exact f32 d^2 = sum_d (w_d - q_d)^2, dims in order, no FMA;
//   * strict d^2 < radius counts every match (each window once per block);
//   * candidates are lanes with d^2 < radius and d^2 < tau, tau taken at the
//     tile's start (radius until K slots are filled, then the worst kept);
//   * the closest-K drain: each wave takes the minimum of each of the 8 row
//     groups of TILE/8 contiguous lanes (lowest lane on ties) and inserts
//     them in group order, appending while slots are open and otherwise
//     replacing the current worst (lowest slot on ties) only if strictly
//     smaller; the extracted lanes are retired and waves repeat while a
//     remaining candidate is below the current tau.
//
// Bound: ~3*dim f32 operations per (seed, window) pair, and each block
// streams its tiles from L2/HBM.  The design keeps the FP pipe busy:
//
//   * the kernel is templated on dim, so every d loop unrolls and the
//     distances live in registers.  A warp owns 4 seeds and each lane
//     4 windows x 4 seeds at a time: per dim, one float4 load of the staged
//     tile and one broadcast float4 of the seeds (kept dim-major in shared
//     memory) feed 16 pairs, 2*dim/16 shared loads per pair.  Three blocks
//     of 256 threads fit an SM (80 registers a thread, ~70 KB of shared
//     memory at dim 6); ptxas spills nothing at dims 1-7 and one value per
//     tile step, outside the distance loop, at dim 8;
//   * candidates are sparse once slots fill: each one is appended as a
//     (d^2, lane) key to its seed's list in shared memory (shared atomic
//     cursor), and match counts stay in registers.  The drain works on the
//     list; the lexicographic (value, lane) minimum of a row group equals
//     the dense scan's whatever the list order.  A seed whose list
//     overflows in a tile is drained by the exact dense scan, recomputed
//     from the staged tile, and counted in `overflow`;
//   * the drain is warp-parallel: a warp owns the seed, its K slots sit in
//     lanes 0..K-1 (K <= 32), and every minimum, worst slot and tau is one
//     or two redux.sync reductions; values are compared as the bits of
//     non-negative floats, whose order is the floats' order;
//   * tiles are double-buffered with cp.async: tile s+1 loads while tile s
//     is computed.
//
// A seed's slots depend only on its own candidates in ascending tile order,
// so the block composition, the union's slop and the order of the blocks
// (mapping/sweep_search.py:longest_first) change nothing; the slot order
// feeds chaining's tie-breaks and is kept exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1.0e30f;  // empty-slot marker (the replacement bound)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSeedsPerWarp = 4;
constexpr int kCap = 64;            // sparse candidate list per seed per tile
constexpr unsigned kNone = ~0u;     // no candidate (bits of no float value)
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  float* buf;               // [2][dim][TILE] staged tile coordinate rows
  float* seeds;             // [8][block] seed coordinates, dim-major
  unsigned long long* lst;  // [block][kCap] (bits(d^2) << 32 | lane) keys
  float* slot_d;            // [block][K]
  int* slot_m;              // [block][K]
  float* tau;               // [block] bound at the current tile's start
  int* wrote;               // [block]
  int* cnt;                 // [block]
  int* cur;                 // [block] list cursor of the current tile
  unsigned* retired;        // [kWarps][TILE/32] dense-drain retired lanes
  int* stile;               // [2] global tile staged in each buffer
  int* bm;                  // [2*NO+1] this block's table column
};

// flat step -> global tile: the last offset oo whose tile cumsum is <= step
// (steps ascend, so oo only moves forward)
__device__ __forceinline__ int tile_of(const int* bm, int NO, int step,
                                       int& oo) {
  while (oo + 1 < NO && bm[NO + oo + 1] <= step) ++oo;
  return bm[oo] + (step - bm[NO + oo]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d^2 of one staged window against one seed, the distance pass's arithmetic
// op for op (the first term is the product itself: 0 + x == x exactly)
template <int DIM>
__device__ __forceinline__ float dist2(const float* tb, int TILE, int w,
                                       const float* q) {
  float diff = __fsub_rn(tb[w], q[0]);
  float acc = __fmul_rn(diff, diff);
#pragma unroll
  for (int d = 1; d < DIM; ++d) {
    diff = __fsub_rn(tb[d * TILE + w], q[d]);
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

// The seed's K slots, lane k holding slot k (lanes >= K hold nothing).
struct Slots {
  unsigned d;  // bits of the slot's d^2 (kInf while empty); 0 on lanes >= K
  int m;
  int wrote;   // warp-uniform
};

// tau = K-th smallest bound: radius until K slots are real, then
// min(worst kept, radius)
__device__ __forceinline__ float slots_tau(const Slots& sl, int K,
                                           float radius) {
  if (sl.wrote < K) return radius;
  return fminf(__uint_as_float(__reduce_max_sync(kFull, sl.d)), radius);
}

// One wave's insert of group r's minimum (value bits v, lane w; v == kNone
// when the group has no candidate left): append while slots are open,
// else replace the current worst (lowest slot on ties) if strictly smaller.
__device__ __forceinline__ void insert(Slots& sl, int& n_put, unsigned v,
                                       unsigned w, int K, int lane,
                                       const int* tmeta) {
  const unsigned worst = __reduce_max_sync(kFull, sl.d);
  const int wi = (int)__reduce_min_sync(
      kFull, (lane < K && sl.d == worst) ? (unsigned)lane : 32u);
  const bool notfull = sl.wrote + n_put < K;
  const int slot = notfull ? sl.wrote + n_put : wi;
  const bool put = v != kNone && (notfull || v < worst);
  if (put && lane == slot) {
    sl.d = v;
    sl.m = tmeta[w];
  }
  if (put && notfull) ++n_put;
}

// The closest-K drain of seed q in this tile, one warp.  Sparse: the
// candidates are the n <= kCap keys of the seed's list, two per lane.
// Dense (the list overflowed): the candidates are recomputed from the staged
// tile `tb` against the tile-start bound; extracted lanes are marked in
// `ret`.  Waves run while a remaining candidate is below the current tau
// (the first always does: every candidate is below the tile-start tau).
template <int DIM>
__device__ void drain(const Smem& s, int q, int n, int K, int TILE, int block,
                      float radius, const float* tb, const int* tmeta,
                      unsigned* ret, int lane) {
  const int rowsz = TILE / 8;
  const bool dense = n > kCap;
  Slots sl;
  sl.d = lane < K ? __float_as_uint(s.slot_d[q * K + lane]) : 0u;
  sl.m = lane < K ? s.slot_m[q * K + lane] : 0;
  sl.wrote = s.wrote[q];
  unsigned v0 = kNone, w0 = 0, v1 = kNone, w1 = 0;
  float qv[DIM];
  float tau0 = 0.0f;
  if (dense) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) qv[d] = s.seeds[d * block + q];
    tau0 = s.tau[q];
    for (int i = lane; i < TILE / 32; i += 32) ret[i] = 0u;
    __syncwarp();
  } else {
    const unsigned long long* lst = s.lst + q * kCap;
    if (lane < n) {
      v0 = (unsigned)(lst[lane] >> 32);
      w0 = (unsigned)lst[lane];
    }
    if (lane + 32 < n) {
      v1 = (unsigned)(lst[lane + 32] >> 32);
      w1 = (unsigned)lst[lane + 32];
    }
  }
  // this lane's smallest remaining candidate in windows [lo, hi) (lowest
  // window on ties), as (value bits, window)
  auto lane_min = [&](int lo, int hi, unsigned& v, unsigned& w) {
    v = kNone;
    w = kNone;
    if (dense) {
      for (int x = lo + lane; x < hi; x += 32) {
        if ((ret[x >> 5] >> (x & 31)) & 1u) continue;
        const float a = dist2<DIM>(tb, TILE, x, qv);
        if (a < radius && a < tau0 && __float_as_uint(a) < v) {
          v = __float_as_uint(a);
          w = (unsigned)x;
        }
      }
    } else {
      if (v0 != kNone && (int)w0 >= lo && (int)w0 < hi) {
        v = v0;
        w = w0;
      }
      if (v1 != kNone && (int)w1 >= lo && (int)w1 < hi &&
          (v1 < v || (v1 == v && w1 < w))) {
        v = v1;
        w = w1;
      }
    }
  };
  while (true) {
    unsigned v, w;
    lane_min(0, TILE, v, w);
    const unsigned mn = __reduce_min_sync(kFull, v);
    if (mn == kNone || !(__uint_as_float(mn) < slots_tau(sl, K, radius)))
      break;
    // row groups that still hold a candidate (an empty group's insert is
    // a no-op): all of them on the dense path
    unsigned groups = 0xffu;
    if (!dense) {
      unsigned mine = 0u;
      if (v0 != kNone) mine |= 1u << (w0 / rowsz);
      if (v1 != kNone) mine |= 1u << (w1 / rowsz);
      groups = __reduce_or_sync(kFull, mine);
    }
    int n_put = 0;
    for (int r = 0; r < 8; ++r) {
      if (!((groups >> r) & 1u)) continue;
      lane_min(r * rowsz, (r + 1) * rowsz, v, w);
      const unsigned gv = __reduce_min_sync(kFull, v);
      const unsigned gw = __reduce_min_sync(kFull, v == gv ? w : kNone);
      insert(sl, n_put, gv, gw, K, lane, tmeta);
      if (gv == kNone) continue;
      // retire the extracted candidate
      if (dense) {
        if (lane == (int)(gw & 31))
          atomicOr(ret + (gw >> 5), 1u << (gw & 31));
        __syncwarp();
      } else {
        if (v0 != kNone && w0 == gw) v0 = kNone;
        if (v1 != kNone && w1 == gw) v1 = kNone;
      }
    }
    sl.wrote += n_put;
  }
  if (lane < K) {
    s.slot_d[q * K + lane] = __uint_as_float(sl.d);
    s.slot_m[q * K + lane] = sl.m;
  }
  const float tau = slots_tau(sl, K, radius);
  if (lane == 0) {
    s.wrote[q] = sl.wrote;
    s.tau[q] = tau;
  }
}

// three resident blocks per SM: 80 registers a thread
template <int DIM>
__global__ void __launch_bounds__(kThreads, 3)
    sweep_kernel(const float* __restrict__ seeds,
                 const int* __restrict__ blockmeta, int G, int NO,
                 const float* __restrict__ tiles,
                 const int* __restrict__ meta, int TILE, float radius, int K,
                 int block, int* __restrict__ out_meta,
                 float* __restrict__ out_d2, int* __restrict__ out_cnt,
                 int* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tsz = DIM * TILE;  // floats of one staged tile

  Smem s;
  {
    unsigned char* p = smem_raw;
    s.buf = reinterpret_cast<float*>(p);
    p += sizeof(float) * 2 * tsz;
    s.seeds = reinterpret_cast<float*>(p);
    p += sizeof(float) * 8 * block;
    s.lst = reinterpret_cast<unsigned long long*>(p);
    p += sizeof(unsigned long long) * block * kCap;
    s.slot_d = reinterpret_cast<float*>(p);
    p += sizeof(float) * block * K;
    s.slot_m = reinterpret_cast<int*>(p);
    p += sizeof(int) * block * K;
    s.tau = reinterpret_cast<float*>(p);
    p += sizeof(float) * block;
    s.wrote = reinterpret_cast<int*>(p);
    p += sizeof(int) * block;
    s.cnt = reinterpret_cast<int*>(p);
    p += sizeof(int) * block;
    s.cur = reinterpret_cast<int*>(p);
    p += sizeof(int) * block;
    s.retired = reinterpret_cast<unsigned*>(p);
    p += sizeof(unsigned) * kWarps * (TILE / 32);
    s.stile = reinterpret_cast<int*>(p);
    p += sizeof(int) * 2;
    s.bm = reinterpret_cast<int*>(p);
  }

  for (int i = tid; i < block * K; i += kThreads) {
    s.slot_d[i] = kInf;
    s.slot_m[i] = 0;
  }
  for (int i = tid; i < block; i += kThreads) {
    s.tau[i] = radius;
    s.wrote[i] = 0;
    s.cnt[i] = 0;
    s.cur[i] = 0;
  }
  {
    const int g = blockIdx.x;
    for (int i = tid; i < block * 8; i += kThreads)
      s.seeds[(i & 7) * block + (i >> 3)] = seeds[(size_t)g * block * 8 + i];
    for (int i = tid; i < 2 * NO + 1; i += kThreads)
      s.bm[i] = blockmeta[(size_t)i * G + g];
  }
  __syncthreads();

  const int total = s.bm[2 * NO];
  // rows 0..dim-1 of a [8, TILE] tile are contiguous: dim*TILE/4 16-byte
  // copies, spread over the block
  auto stage = [&](int t, int b) {
    if (tid == 0) s.stile[b] = t;
    const float* src = tiles + (size_t)t * 8 * TILE;
    float* dst = s.buf + b * tsz;
    for (int i = tid; i < tsz / 4; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
  };
  int oo = 0;
  if (total > 0) stage(tile_of(s.bm, NO, 0, oo), 0);
  cp_async_commit();

  const int ngroups = block / kSeedsPerWarp;
  for (int step = 0; step < total; ++step) {
    // tile `step` has landed and the previous drain is complete
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < total) {
      stage(tile_of(s.bm, NO, step + 1, oo), (step + 1) & 1);
    }
    cp_async_commit();
    const float* tb = s.buf + (step & 1) * tsz;

    // distance pass: warp = 4 seeds, lane = 4 windows of each 128; one
    // float4 of the tile and one (broadcast) of the seeds feed 16 pairs
    for (int grp = warp; grp < ngroups; grp += kWarps) {
      const int q0 = grp * kSeedsPerWarp;
      int nm[kSeedsPerWarp] = {0, 0, 0, 0};
      for (int c = 0; c < TILE; c += 128) {
        const int w0 = c + 4 * lane;
        float acc[kSeedsPerWarp][4];
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const float4 wv =
              *reinterpret_cast<const float4*>(tb + d * TILE + w0);
          const float4 qd =
              *reinterpret_cast<const float4*>(s.seeds + d * block + q0);
          const float wx[4] = {wv.x, wv.y, wv.z, wv.w};
          const float qx[4] = {qd.x, qd.y, qd.z, qd.w};
#pragma unroll
          for (int j = 0; j < kSeedsPerWarp; ++j) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float diff = __fsub_rn(wx[k], qx[j]);
              const float sq = __fmul_rn(diff, diff);
              acc[j][k] = d == 0 ? sq : __fadd_rn(acc[j][k], sq);
            }
          }
        }
        float m = acc[0][0];
#pragma unroll
        for (int j = 0; j < kSeedsPerWarp; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) m = fminf(m, acc[j][k]);
        if (m < radius) {  // rare: some pair of this lane matches
#pragma unroll
          for (int j = 0; j < kSeedsPerWarp; ++j) {
            const float tau0 = s.tau[q0 + j];  // set before this tile
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float a = acc[j][k];
              if (a < radius) {
                ++nm[j];
                if (a < tau0) {
                  const int pos = atomicAdd(s.cur + q0 + j, 1);
                  if (pos < kCap)
                    s.lst[(q0 + j) * kCap + pos] =
                        ((unsigned long long)__float_as_uint(a) << 32) |
                        (unsigned)(w0 + k);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSeedsPerWarp; ++j) {
        const int v = (int)__reduce_add_sync(kFull, (unsigned)nm[j]);
        if (lane == 0) s.cnt[q0 + j] += v;
      }
    }
    __syncthreads();

    // closest-K drain of the seeds that have candidates, a warp per seed
    const int* tmeta = meta + (size_t)s.stile[step & 1] * TILE;
    for (int q = warp; q < block; q += kWarps) {
      const int n = s.cur[q];
      if (n == 0) continue;
      drain<DIM>(s, q, n, K, TILE, block, radius, tb, tmeta,
                 s.retired + warp * (TILE / 32), lane);
      if (lane == 0) {
        if (n > kCap && overflow != nullptr) atomicAdd(overflow, 1);
        s.cur[q] = 0;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // empty slots held INF (the replacement bound); they return 0
  const int g = blockIdx.x;
  for (int i = tid; i < block * K; i += kThreads) {
    const int q = i / K;
    const int k = i - q * K;
    const size_t o = ((size_t)g * block + q) * K + k;
    out_meta[o] = s.slot_m[i];
    out_d2[o] = k < s.wrote[q] ? s.slot_d[i] : 0.0f;
  }
  for (int q = tid; q < block; q += kThreads) {
    const size_t o = ((size_t)g * block + q) * 2;
    out_cnt[o] = s.cnt[q];
    out_cnt[o + 1] = s.wrote[q];
  }
}

template <int DIM>
int launch(const float* seeds, const int* blockmeta, int G, int NO,
           const float* tiles, const int* meta, int TILE, float radius,
           int K, int block, int* out_meta, float* out_d2, int* out_cnt,
           int* overflow, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * 2 * DIM * TILE + sizeof(float) * 8 * block +
      sizeof(unsigned long long) * block * kCap +
      (sizeof(float) + sizeof(int)) * block * K + 4 * sizeof(int) * block +
      sizeof(unsigned) * kWarps * (TILE / 32) + sizeof(int) * (2 * NO + 3);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel<DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<DIM><<<G, kThreads, smem, stream>>>(
      seeds, blockmeta, G, NO, tiles, meta, TILE, radius, K, block,
      out_meta, out_d2, out_cnt, overflow);
  return (int)cudaGetLastError();
}

}  // namespace

// overflow: one i32 on the device that counts (seed, tile) drains that took
// the dense path, or null.
extern "C" int sig_sweep_launch(const float* seeds, const int* blockmeta,
                                int G, int NO,
                                const float* tiles, const int* meta, int TILE,
                                float radius, int K, int dim, int block,
                                int* out_meta, float* out_d2, int* out_cnt,
                                int* overflow, void* stream) {
  if (G <= 0) return 0;
  if (TILE % 256 != 0 || K < 1 || K > 32 || block % kSeedsPerWarp != 0)
    return 1;
  cudaStream_t st = (cudaStream_t)stream;
#define SIG_SWEEP_DIM(D)                                                     \
  case D:                                                                    \
    return launch<D>(seeds, blockmeta, G, NO, tiles, meta, TILE, radius, K, \
                     block, out_meta, out_d2, out_cnt, overflow, st);
  switch (dim) {
    SIG_SWEEP_DIM(1)
    SIG_SWEEP_DIM(2)
    SIG_SWEEP_DIM(3)
    SIG_SWEEP_DIM(4)
    SIG_SWEEP_DIM(5)
    SIG_SWEEP_DIM(6)
    SIG_SWEEP_DIM(7)
    SIG_SWEEP_DIM(8)
    default:
      return 1;
  }
#undef SIG_SWEEP_DIM
}
