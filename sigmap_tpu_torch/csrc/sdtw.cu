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
// Design.  One block owns one pair.  Thread k owns a strip of R query rows
// and keeps its strip's column of cells and query values in registers; it
// handles target position i at step s = i + k, so the block advances one
// anti-diagonal of strips per step with one barrier.  The strip's last row
// goes to thread k+1 through a double-buffered slot in shared memory.  A long
// query (26.7 k samples at the debug mode's read length) does not fit one
// block's registers, so the query is covered in passes of blockDim * R rows;
// between passes the boundary column (the last row of a pass, one float per
// target position) lives in a per-pair scratch buffer in device memory,
// written by the last thread and staged back into shared memory a chunk at
// a time by the whole block.  The TPU kernel's device of keeping three whole
// anti-diagonals resident (320 KB at that shape, over the 227 KB a block may
// use) is not carried over, nor its reversed, padded target or lane padding.
//
// What bounds it: the chain of dependent min/add operations inside a strip
// (about 3 dependent ops per cell, R cells per step) and one barrier per
// step; memory traffic is one target value per step per pair.  More pairs
// than SMs hide the latency at the bench shape; at the debug shape (64
// pairs) half the SMs idle, which is a later speed PR's business.
//
// Exactness: the cost is one __fsub_rn and fabsf, the cell one __fadd_rn of
// the cost and the minimum of three predecessors, so each cell rounds once,
// as sdtw_np and the TPU kernel do; the best/end update is made by the one
// thread that owns row q_len-1, in ascending target order, with a strict <.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 16;          // query rows per thread
constexpr float BIG = 1e30f;   // sdtw_kernel.py:44

__global__ void sdtw_kernel(const float* __restrict__ targets,
                            const int* __restrict__ t_len,
                            const float* __restrict__ queries,
                            const int* __restrict__ q_len, int T, int Q,
                            int lg, float* __restrict__ col,
                            float* __restrict__ best_out,
                            int* __restrict__ end_out) {
  extern __shared__ float sm[];
  const int nt = 1 << lg;
  float* hand = sm;            // [2][nt] strip handoff, by step parity
  float* tring = sm + 2 * nt;  // [2][nt] target chunks, by chunk parity
  float* lring = sm + 4 * nt;  // [2][nt] boundary-column chunks
  const int k = threadIdx.x;
  const int64_t pair = blockIdx.x;
  const int tl = min(max(t_len[pair], 0), T);
  const int ql = min(max(q_len[pair], 0), Q);
  const float* tg = targets + pair * (int64_t)T;
  const float* qr = queries + pair * (int64_t)Q;
  const int rows = nt * R;
  const int npass = (tl == 0 || ql == 0) ? 0 : (ql + rows - 1) / rows;
  const int last = ql - 1;
  float best = BIG;
  int end = -1;

  for (int p = 0; p < npass; ++p) {
    const int base = p * rows + k * R;
    float q[R], c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      q[r] = base + r < ql ? qr[base + r] : 0.0f;
      c[r] = BIG;              // D(-1, j)
    }
    // boundary columns of this pass and the next, [2, T] per pair
    const float* lin = col + (pair * 2 + (p & 1)) * (int64_t)T;
    float* lout = col + (pair * 2 + ((p + 1) & 1)) * (int64_t)T;
    const int own = (last >= base && last < base + R) ? last - base : -1;
    // D(i-1, base-1) for the strip's first row: the free-start 0 in pass
    // 0's first strip, else D(-1, .) = BIG before the first step
    float diag0 = (p == 0 && k == 0) ? 0.0f : BIG;
    const int nsteps = tl + nt - 1;
    for (int s = 0; s < nsteps; ++s) {
      if ((s & (nt - 1)) == 0) {
        const int slot = ((s >> lg) & 1) * nt + k;
        const int at = s + k;
        tring[slot] = at < tl ? tg[at] : 0.0f;
        if (p > 0) lring[slot] = at < tl ? lin[at] : BIG;
      }
      __syncthreads();
      const int i = s - k;
      if (i >= 0 && i < tl && base < ql) {
        const int ci = ((i >> lg) & 1) * nt + (i & (nt - 1));
        const float t = tring[ci];
        float left;
        if (k > 0)
          left = hand[((s - 1) & 1) * nt + k - 1];
        else
          left = p == 0 ? 0.0f : lring[ci];
        float diag = diag0;
        diag0 = left;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float up = c[r];
          const float m = fminf(fminf(up, left), diag);
          const float v = __fadd_rn(fabsf(__fsub_rn(t, q[r])), m);
          diag = up;
          left = v;
          c[r] = v;
          if (r == own && v < best) {
            best = v;
            end = i + 1;
          }
        }
        hand[(s & 1) * nt + k] = left;
        if (k == nt - 1 && p + 1 < npass) lout[i] = left;
      }
    }
    __syncthreads();  // lout complete, rings free for the next pass
  }
  const int owner = npass > 0 ? (last % rows) / R : 0;
  if (k == owner) {
    best_out[pair] = best;
    end_out[pair] = end;
  }
}

}  // namespace

// targets [B, T] f32, t_len [B] i32, queries [B, Q] f32, q_len [B] i32, all
// contiguous on the device; col [B, 2, T] f32 scratch (unused, and may be
// null, when Q <= (1 << lg) * 16); best [B] f32, end [B] i32.  blockDim is
// 1 << lg threads, 5 <= lg <= 10.
extern "C" int sig_sdtw_launch(const float* targets, const int* t_len,
                               const float* queries, const int* q_len, int B,
                               int T, int Q, int lg, float* col, float* best,
                               int* end, void* stream) {
  if (B <= 0) return 0;
  const int nt = 1 << lg;
  const size_t smem = 6 * (size_t)nt * sizeof(float);
  sdtw_kernel<<<B, nt, smem, (cudaStream_t)stream>>>(
      targets, t_len, queries, q_len, T, Q, lg, col, best, end);
  return (int)cudaGetLastError();
}
