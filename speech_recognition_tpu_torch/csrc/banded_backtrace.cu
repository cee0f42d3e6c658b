// K2: value-carried backtrace over the banded backpointer planes, and K9:
// the general backtrace over any banded graph without cross edges.
//
// K2 replaces the TPU kernel speech_recognition_tpu/ops/viterbi_banded_pallas.py
// _backtrace_kernel_val (reached through banded_backtrace_tb_pallas with
// eps_prev), for uniform word graphs of W states with eps depth 1.
//
// Per stream b the walk seeds at t = T-1 with end_state[b] and runs to
// t = 0.  The recorded state of frame t is the state before the step.
// For t < nf: code = bp8[t, st, b]; an eps code (4) takes the
// predecessor from eps_prev[t, st / W, b] (the forward kernel stored the
// post-unwind predecessor there), a band code d takes st - d; the step is
// taken only for 0 < t < nf, and the eps flag is code == 4 for t < nf.
// Frames t >= nf pass the state through.
//
// K9 replaces _backtrace_kernel (banded_backtrace_tb_pallas without
// eps_prev), the walk the bank-input forward (K8) feeds.  Per stream and
// frame t < nf, from the recorded state st: code = bp8[t, st, b]; up to
// eps_depth times, while code is the eps code, the origin u =
// eps_u[t, start_pos[st], b] moves st to word_ends[u] and code is re-read
// there (a chain of eps arrivals within one frame, as 1-state words make);
// then, for t > 0, the predecessor is st - code.  The eps flag is set when
// any unwind step ran.  The rules are those of the plain version
// ops/viterbi_banded.banded_backtrace_tb.
//
// What bounds them on the H100: one dependent 1-byte load per frame and
// stream (K9: plus two per eps unwind step), ~T * B bytes read from a
// [T, S, B] plane (~0.26 MB of the ~99 MB plane at T=500, B=512):
// latency, not bandwidth -- T loads in a chain, each a device-memory round
// trip.
//
// What the design does about it: one thread per stream and nothing else.
// The TPU kernel's one-hot [S, B] state plane (a full-plane pass per
// frame to read one value per stream, an MXU select per unwind step) is
// not needed: on this card a gather is an indexed load.  B independent
// chains keep the memory system busy; hiding the per-frame latency further
// (prefetching a frame's candidate codes) is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBand = 2;
constexpr int kEpsCode = kMaxBand + 2;

__global__ void __launch_bounds__(kThreads)
banded_backtrace_kernel(const int8_t* __restrict__ bp8,
                        const int* __restrict__ eps_prev,
                        const int* __restrict__ end_state,
                        const int* __restrict__ nf, int* __restrict__ states,
                        uint8_t* __restrict__ flags, int T, int S, int R,
                        int B, int W) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = nf[b];
  int st = end_state[b];
  for (int t = T - 1; t >= 0; --t) {
    const int rec = st;
    uint8_t m = 0;
    if (t < n) {
      const int code = bp8[((size_t)t * S + st) * B + b];
      m = code == kEpsCode;
      if (t > 0)
        st = m ? eps_prev[((size_t)t * R + st / W) * B + b]
               : st - min(code, kMaxBand);
    }
    states[(size_t)t * B + b] = rec;
    flags[(size_t)t * B + b] = m;
  }
}

__global__ void __launch_bounds__(kThreads)
banded_backtrace_general_kernel(const int8_t* __restrict__ bp8,
                                const void* __restrict__ eps_u, int u_wide,
                                const int* __restrict__ start_pos,
                                const int* __restrict__ word_ends,
                                const int* __restrict__ end_state,
                                const int* __restrict__ nf,
                                int* __restrict__ states,
                                uint8_t* __restrict__ flags, int T, int S,
                                int R, int B, int eps_depth) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = nf[b];
  int st = end_state[b];
  for (int t = T - 1; t >= 0; --t) {
    const int rec = st;
    uint8_t used = 0;
    if (t < n) {
      const int8_t* plane = bp8 + (size_t)t * S * B + b;
      int code = plane[(size_t)st * B];
      for (int k = 0; k < eps_depth && code == kEpsCode; ++k) {
        used = 1;
        const size_t o = ((size_t)t * R + start_pos[st]) * B + b;
        const int u = u_wide ? static_cast<const int*>(eps_u)[o]
                             : static_cast<const int8_t*>(eps_u)[o];
        st = word_ends[u];
        code = plane[(size_t)st * B];
      }
      st = t > 0 ? st - code : rec;
    }
    states[(size_t)t * B + b] = rec;
    flags[(size_t)t * B + b] = used;
  }
}

}  // namespace

// bp8 [T,S,B] i8, eps_prev [T,R,B] i32, end_state/nf [B] i32
//   -> states [T,B] i32, flags [T,B] u8 (0/1)
extern "C" int banded_backtrace_launch(const int8_t* bp8, const int* eps_prev,
                                       const int* end_state, const int* nf,
                                       int* states, uint8_t* flags, int T,
                                       int S, int R, int B, int W,
                                       void* stream) {
  if (B <= 0 || T <= 0 || W < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  banded_backtrace_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      bp8, eps_prev, end_state, nf, states, flags, T, S, R, B, W);
  return (int)cudaGetLastError();
}

// bp8 [T,S,B] i8, eps_u [T,R,B] i8 or i32, start_pos [S] / word_ends [L] /
// end_state [B] / nf [B] i32 -> states [T,B] i32, flags [T,B] u8 (0/1)
extern "C" int banded_backtrace_general_launch(
    const int8_t* bp8, const void* eps_u, int u_wide, const int* start_pos,
    const int* word_ends, const int* end_state, const int* nf, int* states,
    uint8_t* flags, int T, int S, int R, int B, int eps_depth,
    void* stream) {
  if (B <= 0 || T <= 0 || eps_depth < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  banded_backtrace_general_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      bp8, eps_u, u_wide, start_pos, word_ends, end_state, nf, states, flags,
      T, S, R, B, eps_depth);
  return (int)cudaGetLastError();
}
