// Sweep radius search, kernel B3, for Hopper.
//
// Replaces sigmap_tpu/ops/sweep_kernel.py:_kernel (called by sweep_search):
// the streaming merge-join between blocks of cell-key-sorted seeds and the
// cell-sorted, pre-tiled window store.  One CTA owns one seed block and walks
// the block's union of tile ranges in ascending tile order (decoded from the
// [2*NO+1, G] block table built by mapping/sweep_search.py).  Each tile's
// dim coordinate rows and its packed meta are staged in shared memory; each
// warp then owns one seed at a time:
//
//   * exact f32 d^2 = sum_d (w_d - q_d)^2, dims in order, no FMA;
//   * strict d^2 < radius counts every match (each window once per block);
//   * candidates are lanes with d^2 < radius and d^2 < tau, tau taken at the
//     tile's start (radius until K slots are filled, then the worst kept);
//   * the closest-K drain is reproduced literally: each wave takes the
//     minimum of each of the 8 row groups of TILE/8 contiguous lanes (lowest
//     lane on ties) and inserts them in group order, appending while slots
//     are open and otherwise replacing the current worst (lowest slot on
//     ties) only if strictly smaller; the extracted lanes are retired and
//     waves repeat while a remaining candidate is below the current tau.
//
// A seed's slots depend only on its own candidates in ascending tile order,
// so the block composition and the union's slop change nothing; the slot
// order feeds chaining's tie-breaks and is kept exactly.
//
// Bound: the distance pass reads every staged tile once per seed from shared
// memory (dim x TILE floats per seed per tile) and does ~3*dim f32 ops per
// pair; device memory traffic is one tile per (block, step), mostly served
// from L2 because neighbouring blocks walk overlapping tile ranges.  This
// first version stages synchronously; cp.async/TMA double buffering is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1.0e30f;  // empty-slot / retired marker (INF)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Smem {
  float* tile;    // [dim][TILE]
  int* tmeta;     // [TILE]
  float* dbuf;    // [kWarps][TILE] masked candidate distances
  float* slot_d;  // [block][K]
  int* slot_m;    // [block][K]
  int* wrote;     // [block]
  int* cnt;       // [block]
  float* seeds;   // [block][8]
  int* bm;        // [2*NO+1] this block's table column
  int* tile_idx;  // [1]
};

__device__ __forceinline__ void min_pair(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// tau = K-th smallest bound: radius until K slots are real, then
// min(worst kept, radius)
__device__ __forceinline__ float seed_tau(const float* sd, int wrote, int K,
                                          float radius) {
  if (wrote < K) return radius;
  float worst = sd[0];
  for (int k = 1; k < K; ++k) worst = fmaxf(worst, sd[k]);
  return fminf(worst, radius);
}

__global__ void sweep_kernel(const float* __restrict__ seeds,
                             const int* __restrict__ blockmeta, int G, int NO,
                             const float* __restrict__ tiles,
                             const int* __restrict__ meta, int TILE,
                             float radius, int K, int dim, int block,
                             int* __restrict__ out_meta,
                             float* __restrict__ out_d2,
                             int* __restrict__ out_cnt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rowsz = TILE / 8;

  Smem s;
  {
    unsigned char* p = smem_raw;
    s.tile = reinterpret_cast<float*>(p);
    p += sizeof(float) * dim * TILE;
    s.tmeta = reinterpret_cast<int*>(p);
    p += sizeof(int) * TILE;
    s.dbuf = reinterpret_cast<float*>(p);
    p += sizeof(float) * kWarps * TILE;
    s.slot_d = reinterpret_cast<float*>(p);
    p += sizeof(float) * block * K;
    s.slot_m = reinterpret_cast<int*>(p);
    p += sizeof(int) * block * K;
    s.wrote = reinterpret_cast<int*>(p);
    p += sizeof(int) * block;
    s.cnt = reinterpret_cast<int*>(p);
    p += sizeof(int) * block;
    s.seeds = reinterpret_cast<float*>(p);
    p += sizeof(float) * block * 8;
    s.bm = reinterpret_cast<int*>(p);
    p += sizeof(int) * (2 * NO + 1);
    s.tile_idx = reinterpret_cast<int*>(p);
  }

  for (int i = tid; i < block * K; i += kThreads) {
    s.slot_d[i] = kInf;
    s.slot_m[i] = 0;
  }
  for (int i = tid; i < block; i += kThreads) {
    s.wrote[i] = 0;
    s.cnt[i] = 0;
  }
  for (int i = tid; i < block * 8; i += kThreads)
    s.seeds[i] = seeds[(size_t)g * block * 8 + i];
  for (int i = tid; i < 2 * NO + 1; i += kThreads)
    s.bm[i] = blockmeta[(size_t)i * G + g];
  __syncthreads();

  const int total = s.bm[2 * NO];
  float* dbuf = s.dbuf + warp * TILE;

  for (int step = 0; step < total; ++step) {
    if (tid == 0) {
      // flat step -> global tile (offset decoded through the tile cumsum)
      int t = s.bm[0] + step;
      for (int oo = 1; oo < NO; ++oo) {
        const int c = s.bm[NO + oo];
        if (c <= step) t = s.bm[oo] + (step - c);
      }
      s.tile_idx[0] = t;
    }
    __syncthreads();
    const int t = s.tile_idx[0];
    {
      const float4* src =
          reinterpret_cast<const float4*>(tiles + (size_t)t * 8 * TILE);
      float4* dst = reinterpret_cast<float4*>(s.tile);
      for (int i = tid; i < dim * TILE / 4; i += kThreads) dst[i] = src[i];
      const int4* msrc =
          reinterpret_cast<const int4*>(meta + (size_t)t * TILE);
      int4* mdst = reinterpret_cast<int4*>(s.tmeta);
      for (int i = tid; i < TILE / 4; i += kThreads) mdst[i] = msrc[i];
    }
    __syncthreads();

    for (int q = warp; q < block; q += kWarps) {
      float qv[8];
#pragma unroll
      for (int d = 0; d < 8; ++d) qv[d] = s.seeds[q * 8 + d];
      float* sd = s.slot_d + q * K;
      int* sm = s.slot_m + q * K;
      const float tau0 = seed_tau(sd, s.wrote[q], K, radius);
      int nmatch = 0;
      bool any = false;
      for (int w = lane; w < TILE; w += 32) {
        float acc = 0.0f;
        for (int d = 0; d < dim; ++d) {
          const float diff = __fsub_rn(s.tile[d * TILE + w], qv[d]);
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        const bool match = acc < radius;
        const bool cand = match && (acc < tau0);
        nmatch += match ? 1 : 0;
        any |= cand;
        dbuf[w] = cand ? acc : kInf;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        nmatch += __shfl_xor_sync(0xffffffffu, nmatch, o);
      if (lane == 0) s.cnt[q] += nmatch;
      __syncwarp();
      if (!__any_sync(0xffffffffu, any)) continue;

      // closest-K drain: waves while a candidate is below the current tau
      while (true) {
        float mins[8];
        int pcol[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float v = kInf * 2.0f;  // above every stored value
          int ix = rowsz;
          for (int c = lane; c < rowsz; c += 32) {
            const float x = dbuf[r * rowsz + c];
            if (x < v) {  // ascending c: keeps the lowest lane on ties
              v = x;
              ix = c;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, o);
            const int oi = __shfl_xor_sync(0xffffffffu, ix, o);
            min_pair(v, ix, ov, oi);
          }
          mins[r] = v;
          pcol[r] = ix;
        }
        if (lane == 0) {
          const int c_wrote = s.wrote[q];
          int n_put = 0;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const bool has = mins[r] < radius;
            float worst = sd[0];
            int wi = 0;
            for (int k = 1; k < K; ++k) {
              if (sd[k] > worst) {
                worst = sd[k];
                wi = k;
              }
            }
            const bool notfull = (c_wrote + n_put) < K;
            const int slot = notfull ? c_wrote + n_put : wi;
            const bool put = has && (notfull || mins[r] < worst);
            if (put) {
              sm[slot] = s.tmeta[r * rowsz + pcol[r]];
              sd[slot] = mins[r];
            }
            if (put && notfull) ++n_put;
          }
          s.wrote[q] = c_wrote + n_put;
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (mins[r] < radius) dbuf[r * rowsz + pcol[r]] = kInf;
        }
        __syncwarp();
        const float tau = seed_tau(sd, s.wrote[q], K, radius);
        float m = kInf * 2.0f;
        for (int w = lane; w < TILE; w += 32) m = fminf(m, dbuf[w]);
        const bool go = m < tau;
        if (!__any_sync(0xffffffffu, go)) break;
      }
    }
    __syncthreads();
  }

  // empty slots held INF (the replacement bound); they return 0
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

}  // namespace

extern "C" int sig_sweep_launch(const float* seeds, const int* blockmeta,
                                int G, int NO, const float* tiles,
                                const int* meta, int TILE, float radius, int K,
                                int dim, int block, int* out_meta,
                                float* out_d2, int* out_cnt, void* stream) {
  if (G <= 0) return 0;
  if (TILE % 256 != 0 || dim < 1 || dim > 8 || K < 1) return 1;
  const size_t smem = sizeof(float) * dim * TILE + sizeof(int) * TILE +
                      sizeof(float) * kWarps * TILE +
                      (sizeof(float) + sizeof(int)) * block * K +
                      2 * sizeof(int) * block + sizeof(float) * block * 8 +
                      sizeof(int) * (2 * NO + 2);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      seeds, blockmeta, G, NO, tiles, meta, TILE, radius, K, dim, block,
      out_meta, out_d2, out_cnt);
  return (int)cudaGetLastError();
}
