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
// What bounds them on the H100: a walk is T dependent steps per stream,
// each a 1-byte read of the [T, S, B] plane at a state known only after
// the step before (K2: plus one eps_prev read per word).  Read where they
// lie (the plane is ~99 MB at T=500, S=385, B=512, over the 50 MB L2),
// every step is a device-memory round trip: ~0.3 us a frame, ~0.15 ms in
// all, while the bytes on the path (~0.26 MB) would take 0.0004 ms.  The
// floor that means something for a serial walk is T steps out of shared
// memory, ~10-15 us.  Streaming a stream group's whole slice of the plane
// through shared memory instead moves the whole plane (the copy is half of
// every 32-byte sector at B's stride) and measured slower than the chain.
//
// What K2's design does about it (below): a round trip
// fetches a window of frames x the states the band can reach, so the
// chain pays one round trip per window instead of per frame, and the next
// window of the same word is loaded while the warp walks this one: on K1's
// planes about half of the windows arrive before they are needed and the
// rest follow the ~6 word changes per stream.  No layout, alignment or
// size limit: any B, S and word length.  K9 stays one thread per stream,
// reading the plane where it lies.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBand = 2;
constexpr int kEpsCode = kMaxBand + 2;
constexpr int kWin = 128;             // codes one warp loads per window
constexpr int kPerLane = kWin / 32;   // codes (and eps_prev entries) per lane

// K2: one warp per stream (one CTA).  A window holds, for F
// frames t, t-1, ..., t-F+1, the codes of the states [lo, hi] the band
// can reach from hi (lo: the word start, at most 31 states below) and the
// word's eps_prev entries; F = min(t + 1, kWin / (hi - lo + 2)).  The
// lanes load a window into registers (one round trip) and stash it in
// shared memory as one entry per (frame, state): the step's target
// (eps_prev at an eps code, else s - min(code, 2)) and the eps mark.  Then
// every lane walks the same chain, one shared-memory load per frame, until
// the window ends, the walk leaves [lo, hi] or takes an eps code.  While
// it walks, the lanes already load the next window of the same word and
// state span (frames below): when the walk ends inside [lo, hi] with the
// window used up, that window is the next one, and its round trip was
// hidden.
__global__ void __launch_bounds__(32)
banded_backtrace_window_kernel(const int8_t* __restrict__ bp8,
                               const int* __restrict__ eps_prev,
                               const int* __restrict__ end_state,
                               const int* __restrict__ nf,
                               int* __restrict__ states,
                               uint8_t* __restrict__ flags, int T, int S, int R,
                               int B, int W) {
  __shared__ int step[kWin];  // target << 1 | eps mark, [frame][state]
  __shared__ int epsv[kWin];
  __shared__ int recs[kWin];
  __shared__ uint8_t marks[kWin];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int n = min(max(nf[b], 0), T);
  int st = end_state[b];
  for (int t = n + lane; t < T; t += 32) {  // frames passed through
    states[(size_t)t * B + b] = st;
    flags[(size_t)t * B + b] = 0;
  }
  int8_t rc[kPerLane];
  int re[kPerLane];
  int v = 0, lo = 0, hi = 0, ns = 1;
  // the window of F frames from t0 down into rc / re
  auto load = [&](int t0, int F) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j, f = i / ns;
      if (i < F * ns) rc[j] = bp8[((size_t)(t0 - f) * S + lo + i - f * ns) * B + b];
      if (i < F) re[j] = eps_prev[((size_t)(t0 - i) * R + v) * B + b];
    }
  };
  bool ahead = false;  // rc / re hold the window at t (same lo, hi)
  for (int t = n - 1; t >= 0;) {
    if (!ahead) {
      v = st / W;
      hi = st;
      lo = max(v * W, st - 31);
      ns = hi - lo + 1;
      load(t, min(t + 1, kWin / (ns + 1)));
    }
    const int nfr = min(t + 1, kWin / (ns + 1));
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (lane + 32 * j < nfr) epsv[lane + 32 * j] = re[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j, f = i / ns;
      if (i < nfr * ns) {
        const int code = rc[j];
        step[i] = code == kEpsCode ? epsv[f] << 1 | 1
                                   : (lo + i - f * ns - min(code, kMaxBand)) << 1;
      }
    }
    __syncwarp();
    const int t2 = t - nfr;  // the next window of this word and span
    if (t2 >= 0) load(t2, min(t2 + 1, kWin / (ns + 1)));
    int f = 0;
    while (f < nfr) {  // every lane walks the same chain
      const int e = step[f * ns + st - lo];
      if (lane == 0) {
        recs[f] = st;
        marks[f] = e & 1;
      }
      if (t - f++ > 0) st = e >> 1;
      if ((e & 1) || st < lo || st > hi) break;
    }
    __syncwarp();
    for (int i = lane; i < f; i += 32) {
      states[(size_t)(t - i) * B + b] = recs[i];
      flags[(size_t)(t - i) * B + b] = marks[i];
    }
    __syncwarp();  // the next window is stashed over this one
    ahead = f == nfr && t2 >= 0 && st >= lo && st <= hi;
    t -= f;
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
                                       int S, int R, int B, int W, void* stream) {
  if (B <= 0 || T <= 0 || W < 1) return (int)cudaErrorInvalidValue;
  banded_backtrace_window_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
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
