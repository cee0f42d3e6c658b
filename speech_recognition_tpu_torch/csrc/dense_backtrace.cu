// K21: the dense Viterbi backtrace over K11's backpointer planes.
//
// Replaces no TPU kernel: the JAX package runs this walk as one XLA scan,
// speech_recognition_tpu/ops/viterbi.py viterbi_backtrace (a lax.scan over
// the frames, one stream per call, vmapped by its callers).  Its plain
// version is ops/viterbi.viterbi_backtrace_ref, a loop of batched gathers
// (about ten launches a frame).
//
// Per stream b, from s = end_state[b], for t = T-1 down to 0: the frame's
// state is s; for t < nf[b] the eps chain is unwound, up to eps_depth hops
// s_eps <- eps_bp[b, t, s_eps] while the origin is >= 0 (a hop that finds
// -1 would find it again at the same state, so the walk stops there: the
// JAX scan's later hops are no-ops), the eps flag is "a hop was taken",
// and for 0 < t < nf the walk moves to bp[b, t, s_eps].  Frames t >= nf
// repeat the state with flag 0.  An index below 0 wraps by S and one past
// S - 1 clamps, as JAX's indexing does (K11's planes hold neither where
// the walk reads: bp[:, 0] is -1 and is never followed).
//
// What bounds it on the H100: the walk is T dependent steps a stream, each
// one or two reads of an int32 plane at a state known only after the step
// before.  K11's planes of the dense decode (64 x 500 x 385, 99 MB for
// both) are past the 50 MB L2, so a step is a device-memory round trip
// (~0.5-1 us), while the bytes the walk reads and writes (~0.3 MB) would
// take ~0.1 us at 3.35 TB/s.  The time is the longest stream's chain of
// round trips, whatever B is.
//
// What the design does about it: one thread a stream, and a frame's two
// reads (the eps origin and the backpointer, both at the frame's state)
// issued together, so a frame without an eps hop costs one round trip; the
// backpointer is read again only at a state an eps hop moved to.  The
// planes are read in place, at the strides the wrapper passes (K11's
// [B, T, S] or a [T, S] plane's view): nothing is copied, no shared
// memory, no size limit.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ long long state_index(long long s, int S) {
  if (s < 0) s += S;
  return s < 0 ? 0 : (s >= S ? S - 1 : s);
}

// bp / eps_bp: int32 planes with strides (b, t, s) in elements; end_state
// and nf [B] int32 -> states [B, T] int32, flags [B, T] u8 (0/1).
__global__ void __launch_bounds__(kThreads) dense_backtrace_kernel(
    const int* __restrict__ bp, long long bp_b, long long bp_t, long long bp_s,
    const int* __restrict__ eps_bp, long long ep_b, long long ep_t, long long ep_s,
    const int* __restrict__ end_state, const int* __restrict__ nf, int* __restrict__ states,
    uint8_t* __restrict__ flags, int T, int S, int B, int eps_depth) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int* bpb = bp + b * bp_b;
  const int* epb = eps_bp + b * ep_b;
  int* out = states + (long long)b * T;
  uint8_t* flag = flags + (long long)b * T;
  const int n = nf[b];
  int s = end_state[b];
  for (int t = T - 1; t >= 0; --t) {
    out[t] = s;
    uint8_t used = 0;
    if (t < n) {
      long long se = state_index(s, S);
      // both reads of the frame at once; bp is re-read after an eps hop
      int prev = t > 0 ? bpb[t * bp_t + se * bp_s] : 0;
      for (int k = 0; k < eps_depth; ++k) {
        const int origin = epb[t * ep_t + se * ep_s];
        if (origin < 0) break;
        used = 1;
        se = state_index(origin, S);
      }
      if (t > 0) {
        if (used) prev = bpb[t * bp_t + se * bp_s];
        s = prev;
      }
    }
    flag[t] = used;
  }
}

}  // namespace

extern "C" int dense_backtrace_launch(const int* bp, long long bp_b, long long bp_t,
                                      long long bp_s, const int* eps_bp, long long ep_b,
                                      long long ep_t, long long ep_s, const int* end_state,
                                      const int* nf, int* states, uint8_t* flags, int T, int S,
                                      int B, int eps_depth, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || eps_depth < 0) return (int)cudaErrorInvalidValue;
  dense_backtrace_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                           (cudaStream_t)stream>>>(bp, bp_b, bp_t, bp_s, eps_bp, ep_b, ep_t,
                                                   ep_s, end_state, nf, states, flags, T, S, B,
                                                   eps_depth);
  return (int)cudaGetLastError();
}
