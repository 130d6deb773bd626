// Rescue radius search, for Hopper: every window of the resident tile store
// within a candidate radius of each seed of one rescue chunk.
//
// Replaces no TPU kernel.  The rescue (mapping/turbo.py:_rescue_one, through
// oracle.py:chains_for_chunk) searched each chunk's ~200 seeds with the host
// k-d tree (csrc/core.cc:kd_radius_rec), single-threaded, about 70% of a
// rescued read's time.  This kernel answers the same query over the sweep
// tile store that the rounds already hold on the card (index/sweep.py
// layout: PCA-rotated coordinates, windows sorted by grid cell, [T, 8, TILE]
// tiles).  It returns candidates, not matches: every window whose rotated
// f32 d^2 lies below a candidate radius a little above the search radius,
// as (tile slot, seed, d^2), after each seed's count in one output buffer
// that the host reads back with one copy.  The host (mapping/rescue.py)
// recomputes each candidate's d^2 in the unrotated basis exactly as the k-d
// tree does and keeps the strict matches, so the result is the tree's, bit
// for bit.
//
// One CTA a block of kBlock seeds walks the block's union of tile ranges
// (the [2*NO+1, G] table of mapping/rescue.py:block_table, B3's format),
// tiles double-buffered with cp.async as in B3 (csrc/sweep.cu): tile s+1
// loads while tile s is computed.  Per (seed, window) pair: dims in order,
// no FMA, ~3*dim f32 operations; a candidate takes one shared and one global
// atomic (they are ~1e-3 of the pairs).  Bound: the tile bytes each block
// streams, and 18 operations a pair at dim 6 (B3's count).  kBlock is 1: a
// rescue chunk's seeds lie far apart in cell space, so a block's union grows
// almost linearly with its seeds (mean tiles a block on a 2 M-window index:
// 21 at one seed, 65 at two, 217 at eight); one seed a CTA streams the
// fewest tiles and gives a chunk ~200 CTAs for the 132 SMs.
//
// sig_rescue_search_card runs a chunk's whole search, the host table and
// exact check of rescue_host.cc around the kernel and its copies, as one
// call: its caller gives up the interpreter lock once a chunk.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "cp_async.cuh"
#include "rescue_host.cc"  // sig_rescue_table, sig_rescue_exact

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 1;  // seeds a CTA (ops/rescue_search.py:BLOCK)

// flat step -> global tile: the last offset oo whose tile cumsum is <= step
// (steps ascend, so oo only moves forward)
__device__ __forceinline__ int tile_of(const int* bm, int NO, int step,
                                       int& oo) {
  while (oo + 1 < NO && bm[NO + oo + 1] <= step) ++oo;
  return bm[oo] + (step - bm[NO + oo]);
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
    rescue_search_kernel(const float* __restrict__ seeds,
                         const int* __restrict__ blockmeta, int G, int NO,
                         const float* __restrict__ tiles, int TILE,
                         float radius, int cap, int* __restrict__ head,
                         int* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tsz = DIM * TILE;  // floats of one staged tile
  float* buf = reinterpret_cast<float*>(smem_raw);  // [2][DIM][TILE]
  int* bm = reinterpret_cast<int*>(buf + 2 * tsz);  // [2*NO+1]
  int* cnt = bm + 2 * NO + 1;                       // [kBlock]
  const int tid = threadIdx.x;
  const int g = blockIdx.x;

  for (int i = tid; i < 2 * NO + 1; i += kThreads)
    bm[i] = blockmeta[(size_t)i * G + g];
  if (tid < kBlock) cnt[tid] = 0;
  float q[kBlock][DIM];
#pragma unroll
  for (int j = 0; j < kBlock; ++j)
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      q[j][d] = seeds[((size_t)g * kBlock + j) * 8 + d];
  __syncthreads();

  const int total = bm[2 * NO];
  // rows 0..dim-1 of a [8, TILE] tile are contiguous: dim*TILE/4 16-byte
  // copies, spread over the block
  auto stage = [&](int t, int b) {
    const float* src = tiles + (size_t)t * 8 * TILE;
    float* dst = buf + b * tsz;
    for (int i = tid; i < tsz / 4; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
  };
  int oo_next = 0, oo = 0;
  if (total > 0) stage(tile_of(bm, NO, 0, oo_next), 0);
  cp_async_commit();

  for (int step = 0; step < total; ++step) {
    // tile `step` has landed and every thread is done with tile step-1
    cp_async_wait<0>();
    __syncthreads();
    if (step + 1 < total) stage(tile_of(bm, NO, step + 1, oo_next),
                                (step + 1) & 1);
    cp_async_commit();
    const int t = tile_of(bm, NO, step, oo);
    const float* tb = buf + (step & 1) * tsz;
    for (int w = tid; w < TILE; w += kThreads) {
      float wv[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) wv[d] = tb[d * TILE + w];
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        // the first term is the product itself: 0 + x == x exactly
        float diff = __fsub_rn(wv[0], q[j][0]);
        float acc = __fmul_rn(diff, diff);
#pragma unroll
        for (int d = 1; d < DIM; ++d) {
          diff = __fsub_rn(wv[d], q[j][d]);
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        if (acc < radius) {
          atomicAdd(cnt + j, 1);
          const int pos = atomicAdd(head, 1);
          if (pos < cap) {
            cand[3 * pos] = t * TILE + w;
            cand[3 * pos + 1] = g * kBlock + j;
            cand[3 * pos + 2] = __float_as_int(acc);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < kBlock) head[1 + g * kBlock + tid] = cnt[tid];
}

template <int DIM>
int launch(const float* seeds, const int* blockmeta, int G, int NO,
           const float* tiles, int TILE, float radius, int cap, int* head,
           int* cand, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * DIM * TILE +
                      sizeof(int) * (2 * NO + 1 + kBlock);
  cudaError_t e = cudaFuncSetAttribute(
      rescue_search_kernel<DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  rescue_search_kernel<DIM><<<G, kThreads, smem, stream>>>(
      seeds, blockmeta, G, NO, tiles, TILE, radius, cap, head, cand);
  return (int)cudaGetLastError();
}

}  // namespace

// out: [1 + G*block + 3*cap] i32: the candidates' total, each seed's count
// (both exact), then the first `cap` candidates as (tile slot, seed, bits of
// d^2).  block must be kBlock.
extern "C" int sig_rescue_search_launch(const float* seeds,
                                        const int* blockmeta, int G, int NO,
                                        const float* tiles, int TILE,
                                        float radius, int dim, int block,
                                        int cap, int* out, void* stream) {
  if (TILE % 256 != 0 || block != kBlock || cap < 0) return 1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (G <= 0) return 0;
#define SIG_RESCUE_DIM(D)                                                 \
  case D:                                                                 \
    return launch<D>(seeds, blockmeta, G, NO, tiles, TILE, radius, cap,   \
                     out, out + 1 + G * kBlock, st);
  switch (dim) {
    SIG_RESCUE_DIM(1)
    SIG_RESCUE_DIM(2)
    SIG_RESCUE_DIM(3)
    SIG_RESCUE_DIM(4)
    SIG_RESCUE_DIM(5)
    SIG_RESCUE_DIM(6)
    SIG_RESCUE_DIM(7)
    SIG_RESCUE_DIM(8)
    default:
      return 1;
  }
#undef SIG_RESCUE_DIM
}

// One rescue chunk's whole search, in one call that the caller makes
// without the interpreter lock: the block table (sig_rescue_table, NO probe
// offsets a seed) into the pinned h_in, one copy up to d_in, the kernel on
// `stream` with room for `cap` candidates, one copy of its counts and
// candidates down to the pinned h_out, the wait for `stream`, then the exact
// check (sig_rescue_exact) into rows, fi, fd and fc.  h_in and d_in hold
// nq * (8 + 2*NO + 1) words, h_out and d_out 1 + nq + 3*cap.  The rescue
// threads share the buffers, so one chunk at a time holds the device.
// *launched is set to 1 once the kernel is launched.  Returns the matches,
// or -1 (the candidates passed cap; *total is how many there are), -2 (a
// query passed per_cap), or -(1000 + a CUDA error).
extern "C" int64_t sig_rescue_search_card(
    int32_t device, const float* queries, int32_t nq, int32_t dim,
    const float* rot, const float* mu, const float* origin,
    const int64_t* radixes, int32_t bd, double cell_width, double radius_c,
    int32_t span, int64_t NO, const int32_t* cum, int64_t n_cum,
    const float* tiles, int64_t ntiles, int32_t tile, const int32_t* perm,
    const float* values, float radius_sq, int32_t per_cap, int32_t* h_in,
    int32_t* d_in, int32_t* h_out, int32_t* d_out, int64_t cap,
    void* stream, int32_t* rows, int32_t* fi, float* fd, int32_t* fc,
    int64_t* total, int32_t* launched) {
  static std::mutex device_section;
  std::vector<int32_t> out;
  {
    std::lock_guard<std::mutex> hold(device_section);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return -(1000 + (int64_t)e);
    const int64_t words =
        sig_rescue_table(queries, nq, dim, rot, mu, origin, radixes, bd,
                         cell_width, radius_c, span, NO, cum, n_cum, ntiles,
                         tile, h_in, rows);
    cudaStream_t st = (cudaStream_t)stream;
    e = cudaMemcpyAsync(d_in, h_in, words * sizeof(int32_t),
                        cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return -(1000 + (int64_t)e);
    const int err = sig_rescue_search_launch(
        reinterpret_cast<const float*>(d_in), d_in + (int64_t)nq * 8, nq,
        (int)NO, tiles, tile, (float)radius_c, dim, kBlock, (int)cap, d_out,
        stream);
    if (err != 0) return -(1000 + (int64_t)err);
    *launched = 1;
    e = cudaMemcpyAsync(h_out, d_out, (1 + nq + 3 * cap) * sizeof(int32_t),
                        cudaMemcpyDeviceToHost, st);
    if (e == cudaSuccess) e = cudaStreamSynchronize(st);
    if (e != cudaSuccess) return -(1000 + (int64_t)e);
    *total = h_out[0];
    if (h_out[0] > cap) return -1;
    out.assign(h_out, h_out + 1 + nq + 3 * (int64_t)h_out[0]);
  }
  return sig_rescue_exact(out.data(), nq, cap, rows, perm, values, queries,
                          dim, radius_sq, per_cap, fi, fd, fc);
}
