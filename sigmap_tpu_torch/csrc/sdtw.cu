// Kernel B5: batched subsequence DTW for Hopper.
//
// Replaces sigmap_tpu/ops/sdtw_kernel.py:_kernel (called by sdtw_pallas /
// _sdtw_jit).  Per (target, query) pair: free start and free end on the
// target, cost |t_i - q_j|, moves diagonal / up / left, cell
//   D(i, j) = |t_i - q_j| + min(D(i-1, j), D(i, j-1), D(i-1, j-1)),
// boundary column D(i, -1) = 0 on every target row (free start).  The
// result is the minimum of the last valid query row D(i, q_len-1) over
// target positions, first minimum in target order, end 1-based; best 1e30
// and end -1 when no such cell exists (t_len or q_len 0).
//
// What bounds it on this card: operations.  A cell is 4 instructions
// here: an FADD for the difference, two FMNMX, and an FADD that takes the
// abs as an |operand| modifier.  The work is t_len * q_len cells a pair, so
// the bound is cells * 4 over the card's 33.45e12 lane-ops/s (chip_smoke.py
// reports it beside its yardstick of 5 ops a cell: sub, abs, two mins,
// add); the bytes (each target and query value once) are three orders of
// magnitude less.
// The recurrence is a wavefront: within one query row every cell waits for
// its left neighbour, so the kernel must keep enough independent rows in
// flight on every SM to hide the chain, and must not stop the rows at
// every target position to exchange them.
//
// Design.  A pair's query rows are cut into bands of 32 * R rows, one warp
// a band; lane k of a warp holds R consecutive rows (their query values
// and their column of cells) in registers and takes target position
// i = s - k at its step s, so the warp is a wavefront that needs no
// barrier: lane k gets its upper neighbour's last row at position i by
// __shfl_up_sync from the step before.  R is 2, 4 or 8, so a thread needs
// no more than 64 registers and nothing spills.  The warp's last lane
// writes its band's last row into the band's ring of 4 * 32 floats in
// shared memory; the band below runs 64 steps behind it and reads that
// ring a chunk of 32 positions at a time, at the start of its chunk, so
// every value it reads was written a chunk earlier and the warps of a
// cluster synchronise once a chunk (32 steps), not once a step.  Within a
// step nothing but the shuffle and the R cells is on the chain: the target
// values come from a window of the target that the warp stages in shared
// memory each chunk, the row above the band from a register by a shuffle,
// and the ring write is one shared-memory store (global loads and generic
// stores in the step cost ~40% of the time on the card).  The bands of a
// pair are spread over the CTAs of a thread block cluster (`cluster` CTAs
// of `warps` warps, at most 8 CTAs, the portable maximum), so a batch of
// fewer pairs than SMs still fills the card: the first warp of CTA b reads
// the ring of CTA b - 1's last warp through distributed shared memory, and
// the cluster barrier at the end of every chunk orders it.  No CTA ever
// waits on another cluster.  A query longer than a cluster's bands runs in
// passes; the last row of a pass goes to a per-pair [T] scratch row in
// device memory that the next pass's first warp reads (written a chunk or
// more after it is read, so one row serves every pass).  Only the warp
// that holds row q_len - 1 runs the loop that tracks the end, and in it
// only that lane tests; the other warps run the loop with no end check.
// Chunks whose positions all lie inside [0, t_len) skip the position test.
// The launch shape (R, warps, cluster) comes from ops/sdtw_kernel.py:plan.
//
// Exactness: the cost is one __fsub_rn and fabsf, the cell one __fadd_rn of
// the cost and the minimum of three predecessors, so each cell rounds once,
// as sdtw_np and the TPU kernel do.  The minimum is taken as
// fminf(fminf(up, diag), left): every operand is finite and >= +0 (costs
// are absolute values, sums of them, the free start +0 or 1e30), there is
// no NaN and no -0, so min is exact and commutative and the order gives the
// same bits while only two dependent operations (the outer min and the add)
// stay on the chain from one row to the next.  The end is updated by the
// one lane that owns row q_len - 1, in ascending target order, with a
// strict <: the first minimum in target order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float BIG = 1e30f;   // sdtw_kernel.py:44
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 32;           // steps between two barriers: one warp
constexpr int LAG = CHUNK + 32;     // steps a band runs behind the one above
constexpr int SPAN = 4 * CHUNK;     // a band's output ring, floats
constexpr int MASK = SPAN - 1;
constexpr int WARP_SMEM = SPAN + 2 * CHUNK;   // ring and target window

// One chunk of a warp's wavefront: its steps [s, s + 32).  `tw` holds the
// target window t[s - 31 .. s + 31] and lane l's `bc` the row above the
// band at position s + l (from the ring of the band above, the scratch row
// or the free start), so at step s + k lane 0 takes that row from lane k by
// a shuffle and every lane reads its target value from shared memory, all
// off the chain; every other lane takes its upper neighbour's last row
// from the step before (`hand`).  `diag0` is the lane's row above its
// first row at its previous position.  Lane 31 writes its band's last row
// to the band's own ring `ro`.  EDGE: some lane's position may lie outside
// [0, t_len) in this chunk (its first and last chunks), so each step tests
// it; with END the lane `e_lane` tracks row e_r of its strip.
template <int R, bool END, bool EDGE>
__device__ __forceinline__ void run_chunk(
    int s, int lane, int tl, const float* tw, float bc, const float (&q)[R],
    float (&c)[R], float& hand, float& diag0, float* ro, int e_lane,
    int e_r, float& best, int& end) {
#pragma unroll 4
  for (int k = 0; k < CHUNK; ++k) {
    const int i = s + k - lane;
    float left = __shfl_up_sync(FULL, hand, 1);
    const float b0 = __shfl_sync(FULL, bc, k);
    const float t = tw[k - lane + 31];
    if (lane == 0) left = b0;
    if (EDGE && (i < 0 || i >= tl)) continue;
    float diag = diag0;
    diag0 = left;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float up = c[r];
      const float m = fminf(fminf(up, diag), left);
      const float v = __fadd_rn(fabsf(__fsub_rn(t, q[r])), m);
      diag = up;
      left = v;
      c[r] = v;
    }
    hand = left;
    if (lane == 31) ro[i & MASK] = left;
    if (END && lane == e_lane) {
      float v = c[0];
#pragma unroll
      for (int r = 1; r < R; ++r) v = r == e_r ? c[r] : v;
      if (v < best) {
        best = v;
        end = i + 1;
      }
    }
  }
}

template <int R, bool END>
__device__ __forceinline__ void run_chunk(
    bool edge, int s, int lane, int tl, const float* tw, float bc,
    const float (&q)[R], float (&c)[R], float& hand, float& diag0, float* ro,
    int e_lane, int e_r, float& best, int& end) {
  if (edge)
    run_chunk<R, END, true>(s, lane, tl, tw, bc, q, c, hand, diag0, ro,
                            e_lane, e_r, best, end);
  else
    run_chunk<R, END, false>(s, lane, tl, tw, bc, q, c, hand, diag0, ro,
                             e_lane, e_r, best, end);
}

__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cl,
                                                int csize) {
  if (csize == 1)
    __syncthreads();
  else
    cl.sync();
}

template <int R>
__global__ void __launch_bounds__(1024)
sdtw_kernel(const float* __restrict__ targets, const int* __restrict__ t_len,
            const float* __restrict__ queries, const int* __restrict__ q_len,
            int T, int Q, float* __restrict__ col,
            float* __restrict__ best_out, int* __restrict__ end_out) {
  extern __shared__ float smem[];   // [warps][WARP_SMEM]: ring, target window
  cg::cluster_group cl = cg::this_cluster();
  const int csize = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int64_t pair = blockIdx.x / csize;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = csize * nw, g = rank * nw + warp;   // bands a pass, own band
  const int RW = 32 * R, rows = G * RW;
  const int tl = min(max(t_len[pair], 0), T);
  const int ql = min(max(q_len[pair], 0), Q);
  const float* tg = targets + pair * (int64_t)T;
  const float* qr = queries + pair * (int64_t)Q;
  float* colp = col ? col + pair * (int64_t)T : nullptr;
  const int npass = (tl == 0 || ql == 0) ? 0 : (ql + rows - 1) / rows;
  const int last = ql - 1;
  const int e_pass = npass ? last / rows : -1;
  const int e_g = npass ? (last % rows) / RW : -1;
  const int e_lane = npass ? (last % RW) / R : -1;
  const int e_r = npass ? last % R : 0;
  float* ro = smem + warp * WARP_SMEM;   // this band's last row, mod SPAN
  float* tw = ro + SPAN;                 // target window of the chunk
  // the ring of the band above: the warp before, or the last warp of the
  // CTA before in the cluster (distributed shared memory)
  const float* above = warp > 0 ? ro - WARP_SMEM
                       : rank > 0 ? cl.map_shared_rank(
                                        smem + (nw - 1) * WARP_SMEM, rank - 1)
                                  : nullptr;
  float best = BIG;
  int end = -1;
  if (csize > 1) cl.sync();   // every CTA's ring exists before a remote read

  for (int p = 0; p < npass; ++p) {
    const int geff = min(G, (ql - p * rows + RW - 1) / RW);   // live bands
    const int nrounds = (tl + 31 + (geff - 1) * LAG + CHUNK - 1) / CHUNK;
    const bool live = g < geff;
    const bool first = p == 0 && g == 0;
    const bool track = p == e_pass && g == e_g;
    const float* in = g > 0 ? above : p > 0 ? colp : nullptr;
    const bool in_ring = g > 0;
    float* out_col = (g == G - 1 && p + 1 < npass) ? colp : nullptr;
    const int base = p * rows + g * RW + lane * R;
    float q[R], c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      q[r] = base + r < ql ? qr[base + r] : 0.0f;
      c[r] = BIG;   // D(-1, j)
    }
    // the lane's last row at its previous position, and the row above its
    // first row there: D(-1, .) = 1e30 (lane 0 of the first band reads the
    // free start, 0, as its row above, which no diagonal undercuts)
    float hand = BIG, diag0 = BIG;
    int s = -g * LAG;                    // the warp's step at global step 0
    // target values t[s - 31 + l] and t[s + 1 + l]: the window's halves
    int at = s - 31 + lane;
    float ta = at >= 0 && at < tl ? tg[at] : 0.0f;
    at += 32;
    float tb = at >= 0 && at < tl ? tg[at] : 0.0f;
    for (int rd = 0; rd < nrounds; ++rd, s += CHUNK) {
      if (live) {
        at = s + 33 + lane;              // the next chunk's second half
        const float tn = at >= 0 && at < tl ? __ldg(tg + at) : 0.0f;
        at = s + lane;                   // the position lane 0 takes at k
        const float bc = first ? 0.0f
                         : !(at >= 0 && at < tl) ? BIG
                         : in_ring ? in[at & MASK] : in[at];
        __syncwarp();
        tw[lane] = ta;
        tw[32 + lane] = tb;
        __syncwarp();
        const bool edge = s < 31 || s + 31 >= tl;
        if (track)
          run_chunk<R, true>(edge, s, lane, tl, tw, bc, q, c, hand, diag0,
                             ro, e_lane, e_r, best, end);
        else
          run_chunk<R, false>(edge, s, lane, tl, tw, bc, q, c, hand, diag0,
                              ro, e_lane, e_r, best, end);
        if (out_col) {                   // this chunk's last row, for the
          __syncwarp();                  // next pass
          at = s - 31 + lane;
          if (at >= 0 && at < tl) out_col[at] = ro[at & MASK];
        }
        ta = tb;
        tb = tn;
      }
      cluster_barrier(cl, csize);
    }
    if (out_col) __threadfence();   // the scratch row, for the next pass
    cluster_barrier(cl, csize);
  }
  if (npass == 0) {
    if (rank == 0 && threadIdx.x == 0) {
      best_out[pair] = BIG;
      end_out[pair] = -1;
    }
  } else if (g == e_g && lane == e_lane) {
    best_out[pair] = best;
    end_out[pair] = end;
  }
}

template <int R>
cudaError_t launch(const cudaLaunchConfig_t& cfg, const float* targets,
                   const int* t_len, const float* queries, const int* q_len,
                   int T, int Q, float* col, float* best, int* end) {
  return cudaLaunchKernelEx(&cfg, sdtw_kernel<R>, targets, t_len, queries,
                            q_len, T, Q, col, best, end);
}

}  // namespace

// targets [B, T] f32, t_len [B] i32, queries [B, Q] f32, q_len [B] i32, all
// contiguous on the device; col [B, T] f32 scratch (unused, and may be
// null, when one pass covers Q); best [B] f32, end [B] i32.  The launch
// shape is ops/sdtw_kernel.py:plan's: `rows` query rows a lane (2, 4 or
// 8), `warps` warps a CTA (1 to 32), `cluster` CTAs a pair (1 to 8, one
// thread block cluster).  Anything else returns cudaErrorInvalidValue; a
// launch the card refuses returns its error.
extern "C" int sig_sdtw_launch(const float* targets, const int* t_len,
                               const float* queries, const int* q_len, int B,
                               int T, int Q, int rows, int warps, int cluster,
                               float* col, float* best, int* end,
                               void* stream) {
  if (B <= 0) return 0;
  if (warps < 1 || warps > 32 || cluster < 1 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = (size_t)warps * WARP_SMEM * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (rows) {
    case 2: err = launch<2>(cfg, targets, t_len, queries, q_len, T, Q, col,
                            best, end); break;
    case 4: err = launch<4>(cfg, targets, t_len, queries, q_len, T, Q, col,
                            best, end); break;
    case 8: err = launch<8>(cfg, targets, t_len, queries, q_len, T, Q, col,
                            best, end); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
