// Event-detection kernels B1 (peak state machine) and B2 (compression keep
// mask) for Hopper.
//
// B1 replaces sigmap_tpu/signal/events_pallas.py:_peaks_kernel (called by
// detect_peaks_pallas).  The dual-detector peak caller (event.h:117-182) is
// a serial scan with about ten scalars of state per chunk row, so one thread
// owns one row and walks its C steps with the state in registers.  Inputs
// are [C, R] so neighbouring threads read neighbouring addresses; the output
// is [C, R] pairs (short, long) that the wrapper transposes to the [R, 2C]
// interleaved layout.  The kernel is bound by the latency of its C dependent
// steps: rows are independent, so the only remedy is enough rows in flight
// (R = reads x chunks, ~12k on the main path).
//
// B2 replaces events_pallas.py:_compress_kernel (called by
// compress_keep_pallas): the delta run-collapse of sigmap.cc:1072-1079, one
// thread per row over E event means, same layout rules as B1.
//
// All comparisons are on f32 values computed exactly as the reference does
// (no FMA is involved: the state machine only subtracts and compares).

#include <cuda_runtime.h>
#include <cfloat>

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

__global__ void peaks_kernel(const float* __restrict__ t1,
                             const float* __restrict__ t2,
                             const int* __restrict__ lengths, int R, int C,
                             int w1, int w2, float th1, float th2, float ph,
                             int2* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int len = lengths[r];
  Det s{-1, FLT_MAX, 0, 0};
  Det l{-1, FLT_MAX, 0, 0};
  for (int i = 0; i < C; ++i) {
    const size_t at = (size_t)i * R + r;
    const float v1 = t1[at];
    const float v2 = t2[at];
    const bool active = i < len;
    bool dominate;
    int s_pp2;
    const int es = det_step(s, v1, i, th1, w1, ph, active, &dominate, &s_pp2);
    if (dominate) {  // short dominates long (event.h:155-164)
      l.pp = -1;
      l.pv = FLT_MAX;
      l.valid = 0;
      l.masked = s_pp2 + w1;
    }
    bool unused_dom;
    int unused_pp2;
    const int el =
        det_step(l, v2, i, th2, w2, ph, active, &unused_dom, &unused_pp2);
    out[at] = make_int2(es, el);
  }
}

__global__ void compress_keep_kernel(const float* __restrict__ norm,
                                     const int* __restrict__ n, int R, int E,
                                     float delta, int* __restrict__ keep) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int nr = n[r];
  float last = 0.0f;
  for (int j = 0; j < E; ++j) {
    const size_t at = (size_t)j * R + r;
    const float v = norm[at];
    const bool k = (j < nr) && (j == 0 || fabsf(__fsub_rn(v, last)) > delta);
    keep[at] = k ? 1 : 0;
    if (k) last = v;
  }
}

}  // namespace

extern "C" int sig_peaks_launch(const float* t1, const float* t2,
                                const int* lengths, int R, int C, int w1,
                                int w2, float th1, float th2, float ph,
                                int* out, void* stream) {
  if (R <= 0) return 0;
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  peaks_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      t1, t2, lengths, R, C, w1, w2, th1, th2, ph,
      reinterpret_cast<int2*>(out));
  return (int)cudaGetLastError();
}

extern "C" int sig_compress_keep_launch(const float* norm, const int* n, int R,
                                        int E, float delta, int* keep,
                                        void* stream) {
  if (R <= 0) return 0;
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  compress_keep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      norm, n, R, E, delta, keep);
  return (int)cudaGetLastError();
}
