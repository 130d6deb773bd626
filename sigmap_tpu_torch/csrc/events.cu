// Event-detection kernels B1 (peak state machine) and B2 (compression keep
// mask) for Hopper.
//
// B1 replaces sigmap_tpu/signal/events_pallas.py:_peaks_kernel (called by
// detect_peaks_pallas).  The dual-detector peak caller (event.h:117-182) is
// a serial scan with about ten scalars of state per chunk row, so a lane owns
// a row and walks its C steps with the state in registers, and a warp owns 32
// rows.  The kernel reads the t-statistics as they are, [R, C], and writes
// the interleaved (short, long) emissions [R, 2C] directly: both go through
// shared-memory tiles of 32 rows x kPeakTile steps.  A block is two warps.
// Warp 0 runs the state machine on tile k, four steps a 16-byte read of each
// input row and two 16-byte writes of its emissions (row strides are an odd
// number of 16-byte units, so a quarter warp hits all banks).  Warp 1
// meanwhile fills tile k + 1 (cp.async along C: an instruction copies 512
// consecutive bytes of two rows) and drains tile k - 1's emissions along C
// the same way, so device memory sees only whole lines, the state machine
// never waits for it, and neither warp runs the other's instructions.
// R / 32 blocks spread over every SM.  Every copy is 16 bytes, so C is a
// multiple of 4 and the pointers are 16-byte aligned (the wrapper pads rows
// of another length).
// The kernel is bound by bytes (16 B a step against ~40 operations); what it
// cannot hide is the serial chain of C dependent steps a row, so small R is
// latency-bound.
//
// B2 replaces events_pallas.py:_compress_kernel (called by
// compress_keep_pallas): the delta run-collapse of sigmap.cc:1072-1079, a
// serial scan of E event means a row carrying one value (the last kept), so
// it is laid out as B1: a lane owns a row, a warp 32 rows, and a block of
// two warps reads [R, E] and writes the [R, E] mask through padded
// shared-memory tiles of 32 rows x kKeepTile events.  Warp 0 runs the scan on
// tile k (four events a 16-byte read, their four keep flags one 16-byte
// write) while warp 1 fills tile k + 1 and drains tile k - 1 along E with
// 16-byte copies.  R / 32 blocks spread over every SM (384 at R = 12288).
// It is bound by bytes (8 B an event against 4 operations); what it cannot
// hide is the chain of E dependent steps a row.  The wrapper pads rows whose
// E is no multiple of 4, and copies a view off a 16-byte boundary.
//
// All comparisons are on f32 values computed exactly as the reference does
// (no FMA is involved: the state machine only subtracts and compares).

#include <cuda_runtime.h>
#include <cfloat>

#include "cp_async.cuh"

namespace {

struct Det {
  int pp;       // peak position, -1 = no maximum recorded yet
  float pv;     // peak value
  int valid;    // candidate peak passed the height/threshold test
  int masked;   // detector is masked up to this position
};

// One step of one detector (events.py:_detector_step).  Returns the
// emission (position + 1, or 0); sets *dominate and *pp2 for the
// short-dominates-long rule.
__device__ __forceinline__ int det_step(Det& st, float v, int i, float thr,
                                        int wl, float ph, bool active,
                                        bool* dominate, int* pp2_out) {
  const bool act = active && (st.masked < i);
  const bool in_def = st.pp == -1;
  // case 1: no maximum recorded yet
  const bool lower = v < st.pv;
  const bool fire = !lower && (__fsub_rn(v, st.pv) > ph);
  const int pp1 = fire ? i : st.pp;
  const float pv1 = (lower || fire) ? v : st.pv;
  // case 2: inside a candidate peak
  const bool upd = v > st.pv;
  const int pp2 = upd ? i : st.pp;
  const float pv2 = upd ? v : st.pv;
  const bool set_valid = (__fsub_rn(pv2, v) > ph) && (pv2 > thr);
  const int valid2 = (st.valid || set_valid) ? 1 : 0;
  const bool emit = valid2 && ((i - pp2) > (wl / 2));
  const int pp2e = emit ? -1 : pp2;
  const float pv2e = emit ? v : pv2;
  const int valid2e = emit ? 0 : valid2;
  const int emit_pos = (act && !in_def && emit) ? pp2 + 1 : 0;
  *dominate = act && !in_def && (pv2 > thr);
  *pp2_out = pp2;
  if (act) {
    st.pp = in_def ? pp1 : pp2e;
    st.pv = in_def ? pv1 : pv2e;
    st.valid = in_def ? st.valid : valid2e;
  }
  return emit_pos;
}

constexpr int kPeakRows = 32;                 // rows a block owns
constexpr int kPeakTile = 64;                 // steps a tile
constexpr int kPeakIn = kPeakTile + 4;        // row stride of an input tile
constexpr int kPeakOut = 2 * kPeakTile + 4;   // row stride of an output tile
constexpr int kPeakInBuf = 2 * kPeakRows * kPeakIn;   // t1 and t2 of a tile
constexpr int kPeakOutBuf = kPeakRows * kPeakOut;
constexpr int kPeakSmem = 2 * (kPeakInBuf + kPeakOutBuf) * 4;

__global__ void __launch_bounds__(64) peaks_kernel(
    const float* __restrict__ t1, const float* __restrict__ t2,
    const int* __restrict__ lengths, int R, int C, int w1, int w2, float th1,
    float th2, float ph, int* __restrict__ out) {
  extern __shared__ __align__(16) float peak_smem[];
  float* tin = peak_smem;                                   // [2][2][32][In]
  int* tout = reinterpret_cast<int*>(peak_smem + 2 * kPeakInBuf);  // [2][32][Out]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kPeakRows;
  const int nrows = min(kPeakRows, R - r0);
  const int ntiles = (C + kPeakTile - 1) / kPeakTile;

  auto fill = [&](int tile) {
    const int c0 = tile * kPeakTile;
    const int n = min(kPeakTile, C - c0);
    float* d1 = tin + (tile & 1) * kPeakInBuf;
    float* d2 = d1 + kPeakRows * kPeakIn;
    constexpr int kChunks = kPeakTile / 4;  // 16-byte chunks a row
    for (int x = lane; x < nrows * kChunks; x += 32) {
      const int rr = x / kChunks;
      const int c = (x % kChunks) * 4;
      if (c < n) {
        const size_t g = (size_t)(r0 + rr) * C + c0 + c;
        cp_async16(d1 + rr * kPeakIn + c, t1 + g);
        cp_async16(d2 + rr * kPeakIn + c, t2 + g);
      }
    }
    cp_async_commit();
  };
  auto drain = [&](int tile) {
    const int c0 = tile * kPeakTile;
    const int n = min(kPeakTile, C - c0);
    const int* src = tout + (tile & 1) * kPeakOutBuf;
    for (int rr = 0; rr < nrows; ++rr) {
      int* g = out + (size_t)(r0 + rr) * 2 * C + 2 * c0;
      if (4 * lane < 2 * n)
        *reinterpret_cast<int4*>(g + 4 * lane) =
            *reinterpret_cast<const int4*>(src + rr * kPeakOut + 4 * lane);
    }
  };

  // steps at or beyond C are never active: a tile's tail may be stale
  const int len = (warp == 0 && lane < nrows) ? min(lengths[r0 + lane], C) : 0;
  Det s{-1, FLT_MAX, 0, 0};
  Det l{-1, FLT_MAX, 0, 0};
  auto step = [&](float v1, float v2, int i, int& es, int& el) {
    const bool active = i < len;
    bool dominate;
    int s_pp2;
    es = det_step(s, v1, i, th1, w1, ph, active, &dominate, &s_pp2);
    if (dominate) {  // short dominates long (event.h:155-164)
      l.pp = -1;
      l.pv = FLT_MAX;
      l.valid = 0;
      l.masked = s_pp2 + w1;
    }
    bool unused_dom;
    int unused_pp2;
    el = det_step(l, v2, i, th2, w2, ph, active, &unused_dom, &unused_pp2);
  };

  if (warp == 1) {
    fill(0);
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int tile = 0; tile < ntiles; ++tile) {
    if (warp == 1) {
      if (tile + 1 < ntiles) fill(tile + 1);
      if (tile > 0) drain(tile - 1);
      cp_async_wait<0>();
    } else {
      const int c0 = tile * kPeakTile;
      const int n = min(kPeakTile, C - c0);
      const float* d1 = tin + (tile & 1) * kPeakInBuf + lane * kPeakIn;
      const float* d2 = d1 + kPeakRows * kPeakIn;
      int* mine = tout + (tile & 1) * kPeakOutBuf + lane * kPeakOut;
      for (int c = 0; c < n; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(d1 + c);
        const float4 b = *reinterpret_cast<const float4*>(d2 + c);
        int4 e0, e1;
        step(a.x, b.x, c0 + c, e0.x, e0.y);
        step(a.y, b.y, c0 + c + 1, e0.z, e0.w);
        step(a.z, b.z, c0 + c + 2, e1.x, e1.y);
        step(a.w, b.w, c0 + c + 3, e1.z, e1.w);
        *reinterpret_cast<int4*>(mine + 2 * c) = e0;
        *reinterpret_cast<int4*>(mine + 2 * c + 4) = e1;
      }
    }
    // tile + 1 is in and tile's emissions are out, for both warps
    __syncthreads();
  }
  if (warp == 1) drain(ntiles - 1);
}

constexpr int kKeepRows = 32;                 // rows a block owns
constexpr int kKeepTile = 64;                 // events a tile
constexpr int kKeepLd = kKeepTile + 4;        // row stride of a tile
constexpr int kKeepBuf = kKeepRows * kKeepLd;
constexpr int kKeepSmem = 2 * 2 * kKeepBuf * 4;  // means and flags, twice

__global__ void __launch_bounds__(64) compress_keep_kernel(
    const float* __restrict__ norm, const int* __restrict__ n, int R, int E,
    float delta, int* __restrict__ keep) {
  extern __shared__ __align__(16) float keep_smem[];
  float* tin = keep_smem;                                        // [2][32][Ld]
  int* tout = reinterpret_cast<int*>(keep_smem + 2 * kKeepBuf);  // [2][32][Ld]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kKeepRows;
  const int nrows = min(kKeepRows, R - r0);
  const int ntiles = (E + kKeepTile - 1) / kKeepTile;

  // as B1's fill and drain, one array each way: 16-byte copies along E
  auto fill = [&](int tile) {
    const int c0 = tile * kKeepTile;
    const int m = min(kKeepTile, E - c0);
    float* d = tin + (tile & 1) * kKeepBuf;
    constexpr int kChunks = kKeepTile / 4;  // 16-byte chunks a row
    for (int x = lane; x < nrows * kChunks; x += 32) {
      const int rr = x / kChunks;
      const int c = (x % kChunks) * 4;
      if (c < m) {
        const size_t g = (size_t)(r0 + rr) * E + c0 + c;
        cp_async16(d + rr * kKeepLd + c, norm + g);
      }
    }
    cp_async_commit();
  };
  auto drain = [&](int tile) {
    const int c0 = tile * kKeepTile;
    const int m = min(kKeepTile, E - c0);
    const int* src = tout + (tile & 1) * kKeepBuf;
    constexpr int kChunks = kKeepTile / 4;
    for (int x = lane; x < nrows * kChunks; x += 32) {
      const int rr = x / kChunks;
      const int c = (x % kChunks) * 4;
      if (c < m)
        *reinterpret_cast<int4*>(keep + (size_t)(r0 + rr) * E + c0 + c) =
            *reinterpret_cast<const int4*>(src + rr * kKeepLd + c);
    }
  };

  // the step of sigmap.cc:1075-1078, as the reference orders it
  const int nr = (warp == 0 && lane < nrows) ? n[r0 + lane] : 0;
  float last = 0.0f;
  auto step = [&](float v, int j) {
    const bool k = (j < nr) && (j == 0 || fabsf(__fsub_rn(v, last)) > delta);
    if (k) last = v;
    return k ? 1 : 0;
  };

  if (warp == 1) {
    fill(0);
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int tile = 0; tile < ntiles; ++tile) {
    if (warp == 1) {
      if (tile + 1 < ntiles) fill(tile + 1);
      if (tile > 0) drain(tile - 1);
      cp_async_wait<0>();
    } else {
      const int c0 = tile * kKeepTile;
      const int m = min(kKeepTile, E - c0);
      const float* in = tin + (tile & 1) * kKeepBuf + lane * kKeepLd;
      int* mine = tout + (tile & 1) * kKeepBuf + lane * kKeepLd;
      for (int c = 0; c < m; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(in + c);
        int4 k;
        k.x = step(v.x, c0 + c);
        k.y = step(v.y, c0 + c + 1);
        k.z = step(v.z, c0 + c + 2);
        k.w = step(v.w, c0 + c + 3);
        *reinterpret_cast<int4*>(mine + c) = k;
      }
    }
    // tile + 1 is in and tile's flags are out, for both warps
    __syncthreads();
  }
  if (warp == 1) drain(ntiles - 1);
}

}  // namespace

extern "C" int sig_peaks_launch(const float* t1, const float* t2,
                                const int* lengths, int R, int C, int w1,
                                int w2, float th1, float th2, float ph,
                                int* out, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  if (C % 4 != 0 || ((size_t)t1 | (size_t)t2 | (size_t)out) % 16 != 0)
    return 1;  // cudaErrorInvalidValue: the copies are 16 bytes each
  cudaError_t e = cudaFuncSetAttribute(
      peaks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPeakSmem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (R + kPeakRows - 1) / kPeakRows;
  peaks_kernel<<<blocks, 64, kPeakSmem, (cudaStream_t)stream>>>(
      t1, t2, lengths, R, C, w1, w2, th1, th2, ph, out);
  return (int)cudaGetLastError();
}

extern "C" int sig_compress_keep_launch(const float* norm, const int* n, int R,
                                        int E, float delta, int* keep,
                                        void* stream) {
  if (R <= 0 || E <= 0) return 0;
  if (E % 4 != 0 || ((size_t)norm | (size_t)keep) % 16 != 0)
    return 1;  // cudaErrorInvalidValue: the copies are 16 bytes each
  const int blocks = (R + kKeepRows - 1) / kKeepRows;
  compress_keep_kernel<<<blocks, 64, kKeepSmem, (cudaStream_t)stream>>>(
      norm, n, R, E, delta, keep);
  return (int)cudaGetLastError();
}
