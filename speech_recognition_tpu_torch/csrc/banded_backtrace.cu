// K2: value-carried backtrace over the banded backpointer planes, and K9:
// the general backtrace over any banded graph, cross edges included.
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
// then, for t > 0, the predecessor is st - code, or cross_src[st] for the
// cross code (3: a trie's parent-arc end -> child-arc start frame edge).
// The eps flag is set when any unwind step ran.  The rules are those of
// the plain version ops/viterbi_banded.banded_backtrace_tb.
//
// What bounds them on the H100: a walk is T dependent steps per stream,
// each a 1-byte read of the [T, S, B] plane at a state known only after
// the step before (K2: plus one eps_prev read per word; K9: an eps_u, a
// start_pos and a word_ends read per unwind step).  Read where they lie
// (the plane is ~99 MB at T=500, S=385, B=512, over the 50 MB L2), every
// step is a device-memory round trip: ~0.3 us a frame, ~0.15 ms in all,
// while the bytes on the path (~0.26 MB) would take 0.0004 ms.  The floor
// that means something for a serial walk is T steps out of shared memory,
// ~10-15 us.  Streaming a stream group's whole slice of the plane through
// shared memory instead moves the whole plane (the copy is half of every
// 32-byte sector at B's stride) and measured slower than the chain (K2).
//
// What the design does about it (both kernels, below): a round trip
// fetches a window of frames x the states the band can reach, so the
// chain pays one round trip per window instead of per frame, and the next
// window of the same word is loaded while the warp walks this one: on K1's
// planes about half of the windows arrive before they are needed and the
// rest follow the ~6 word changes per stream.  K9 also loads the word's
// eps_u entries with its window and stashes each frame's unwind target
// (word_ends of that entry), so an unwind at the word start costs no
// read of its own; the state it lands on lies in another word, so it
// starts a new window at the same frame.  A cross step lands in the parent
// arc, below the child arc's start: it leaves the window as an unwind does
// and the walk reloads at the next frame (on a trie the span hint is the
// last arc start, so a window covers the states of one arc).  No layout,
// alignment or size limit: any B, S, word length and eps depth.

#include "common.cuh"

namespace {

constexpr int kMaxBand = 2;
constexpr int kCrossCode = kMaxBand + 1;
constexpr int kEpsCode = kMaxBand + 2;
constexpr int kWin = 128;             // codes one warp loads per window
constexpr int kPerLane = kWin / 32;   // codes (and eps_prev entries) per lane
constexpr int kGenWarps = 4;          // K9: streams (warps) per CTA
constexpr int kGenStageBytes = 32 * 1024;  // K9: graph tables staged up to this
constexpr unsigned kFull = 0xffffffffu;

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

// K9: one warp per stream, kGenWarps streams per CTA, the graph tables
// (start_pos, word_ends, cross_src, the span hint) staged in shared memory
// where they fit in kGenStageBytes, else read through L1.  A window is
// K2's: F frames x the states [lo, hi = st], F = min(t + 1, kWin / (hi -
// lo + 2)), where lo is a hint, the last span start at or below st (a
// ballot over the hint table, at most 31 below: the word starts, and on a
// graph with cross edges the arc starts too); with it the eps_u entries
// eps_u[t, start_pos[lo], b] of the F frames.  Stashed per (frame, state):
// the step target (s - code, cross_src[s] for the cross code) and the eps
// mark; per frame: word_ends of the eps_u entry.
// Lane 0 walks (the other lanes wait at one __syncwarp a window; writing
// each frame's state where it goes from the walk measured slower than
// stashing them for the lanes to write): at frame t it records st (the
// state before any unwind); while the code is
// the eps code and fewer than eps_depth unwinds ran, st moves to the
// unwind target (the window's at lo, else read where it lies) and the
// code is re-read at the same frame, in a new window once st leaves
// [lo, hi]; then st steps to its target for t > 0 (s - 4 if the eps code
// is left after eps_depth unwinds).  The flag is whether an unwind ran.
// While lane 0 walks, the lanes load the next window of the same word and
// span and, where the stashed window has an eps code at lo, the window of
// the word its unwind lands in (at that frame): the walk takes it if it
// unwinds there, so a word change waits for no round trip of its own.
__global__ void __launch_bounds__(kGenWarps * 32)
banded_backtrace_general_kernel(const int8_t* __restrict__ bp8,
                                const void* __restrict__ eps_u, int u_wide,
                                const long long* __restrict__ start_pos,
                                const long long* __restrict__ word_ends,
                                const long long* __restrict__ cross_src,
                                const uint8_t* __restrict__ is_start,
                                const int* __restrict__ end_state,
                                const int* __restrict__ nf,
                                int* __restrict__ states,
                                uint8_t* __restrict__ flags, int T, int S,
                                int R, int L, int B, int eps_depth, int stage,
                                long long* __restrict__ trace) {
  extern __shared__ __align__(16) int tabs[];  // staged: start_pos, word_ends,
                                                // [cross_src,] the span hint
  constexpr int kFrames = kWin / 2;             // a window's frames, at most
  __shared__ int step_s[kGenWarps][kWin];      // (s - code) * 2 + eps mark, [frame][state]
  __shared__ int uw_s[kGenWarps][kFrames];     // unwind target at lo per frame
  __shared__ int recs_s[kGenWarps][kFrames];   // the walk's states and flags
  __shared__ uint8_t marks_s[kGenWarps][kFrames];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* sp_t = nullptr;
  const int* we_t = nullptr;
  const int* cs_t = nullptr;
  const uint8_t* is_t = is_start;
  if (stage) {
    int* sp = tabs;
    int* we = tabs + S;
    int* cs = we + L;
    uint8_t* is = reinterpret_cast<uint8_t*>(cross_src ? cs + S : cs);
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      sp[i] = (int)start_pos[i];
      is[i] = is_start[i];
      if (cross_src) cs[i] = (int)cross_src[i];
    }
    for (int i = threadIdx.x; i < L; i += blockDim.x) we[i] = (int)word_ends[i];
    __syncthreads();
    sp_t = sp;
    we_t = we;
    cs_t = cross_src ? cs : nullptr;
    is_t = is;
  }
  auto start_of = [&](int s) -> int { return sp_t ? sp_t[s] : (int)start_pos[s]; };
  // the step target of code c at state s (the eps code's is s - 4, taken
  // only when the eps code is left after eps_depth unwinds)
  auto target_of = [&](int s, int c) -> int {
    if (c == kCrossCode && cross_src) return cs_t ? cs_t[s] : (int)cross_src[s];
    return s - c;
  };
  auto end_of = [&](int u) -> int {
    if ((unsigned)u >= (unsigned)L) return 0;  // never taken on a forward's planes
    return we_t ? we_t[u] : (int)word_ends[u];
  };
  const int b = blockIdx.x * kGenWarps + warp;
  if (b >= B) return;  // the whole warp leaves; no block barrier follows
  int* step = step_s[warp];
  int* uw = uw_s[warp];
  int* recs = recs_s[warp];
  uint8_t* marks = marks_s[warp];
  const int8_t* u8 = static_cast<const int8_t*>(eps_u);
  const int* u32 = static_cast<const int*>(eps_u);
  auto u_at = [&](size_t o) -> int { return u_wide ? u32[o] : (int)u8[o]; };

  const int n = min(max(nf[b], 0), T);
  int st = end_state[b];
  for (int t = n + lane; t < T; t += 32) {  // frames passed through
    states[(size_t)t * B + b] = st;
    flags[(size_t)t * B + b] = 0;
  }
  // A window's span: [lo, lo + ns), ns states, eps_u slot r0; inv = the
  // reciprocal that divides an entry index i < kWin by ns exactly.
  struct Span {
    int lo, ns, r0, inv;
  };
  auto span_of = [&](int s) -> Span {
    const int c = s - lane;
    const unsigned m = __ballot_sync(kFull, c >= 0 && is_t[c]);
    Span w;
    w.lo = m ? s - (__ffs(m) - 1) : max(s - 31, 0);
    w.ns = s - w.lo + 1;
    w.r0 = start_of(w.lo);
    w.inv = (65536 + w.ns - 1) / w.ns;
    return w;
  };
  auto frames_of = [&](const Span& w, int t0) { return min(t0 + 1, kWin / (w.ns + 1)); };
  // the window of F frames from t0 down over span w into rc / re
  auto load = [&](const Span& w, int t0, int8_t (&rc)[kPerLane], int (&re)[kPerLane]) {
    const int F = frames_of(w, t0);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j, f = (i * w.inv) >> 16;
      if (i < F * w.ns) rc[j] = bp8[((size_t)(t0 - f) * S + w.lo + i - f * w.ns) * B + b];
      if (i < F) re[j] = u_at(((size_t)(t0 - i) * R + w.r0) * B + b);
    }
  };
  int8_t rc[kPerLane], sc[kPerLane];  // codes: this span's window, a word change's
  int re[kPerLane], se[kPerLane];
  Span w = {0, 1, 0, 65536}, ws = w;
  int rec = st, k = 0;  // the frame's recorded state, unwinds run at it
  uint8_t used = 0;
  bool ahead = false;   // rc / re hold the window at t (same span)
  int spec_st = -1, spec_t = -1;  // sc / se hold the window of spec_st at spec_t
  // lane 0's cycles: window loads, stashes and write-outs, walks; windows
  // waited for, loaded during the walk (same span or word change)
  long long cyc[2] = {0, 0}, tick = trace ? clock64() : 0;
  int n_wait = 0, n_ahead = 0;
  auto lap = [&](int ph) {
    if (trace) {
      const long long now = clock64();
      cyc[ph] += now - tick;
      tick = now;
    }
  };
  for (int t = n - 1; t >= 0;) {
    const bool took = !ahead && spec_st == st && spec_t == t;
    n_wait += !ahead && !took;
    n_ahead += ahead || took;
    if (took) {
      w = ws;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        rc[j] = sc[j];
        re[j] = se[j];
      }
    } else if (!ahead) {
      w = span_of(st);
      load(w, t, rc, re);
    }
    const int hi = w.lo + w.ns - 1;
    const int nfr = frames_of(w, t);
    int first_eps = kWin;  // the window's first entry with an eps code at lo
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j, f = (i * w.inv) >> 16, s = w.lo + i - f * w.ns;
      if (i < nfr * w.ns) {
        const int code = rc[j];
        step[i] = target_of(s, code) * 2 + (code == kEpsCode);
        if (code == kEpsCode && s == w.lo) first_eps = min(first_eps, i);
      }
      if (i < nfr) uw[i] = end_of(re[j]);
    }
    first_eps = __reduce_min_sync(kFull, first_eps);
    __syncwarp();
    const int t2 = t - nfr;  // the next window of this word and span
    if (t2 >= 0) load(w, t2, rc, re);
    spec_st = -1;
    if (first_eps < kWin) {  // the word this window's first unwind lands in
      const int fe = (first_eps * w.inv) >> 16;
      spec_st = uw[fe];
      spec_t = t - fe;
      ws = span_of(spec_st);
      load(ws, spec_t, sc, se);
    }
    lap(0);
    int f = 0;
    if (lane == 0) {  // the walk
      while (f < nfr) {
        const int e = step[f * w.ns + st - w.lo];
        if ((e & 1) && k < eps_depth) {  // unwind, and re-read at the same frame
          ++k;
          used = 1;
          st = st == w.lo ? uw[f]
                          : end_of(u_at(((size_t)(t - f) * R + start_of(st)) * B + b));
          if (st < w.lo || st > hi) break;  // another word: a new window at this frame
          continue;
        }
        recs[f] = rec;
        marks[f] = used;
        if (t - f > 0) st = e >> 1;
        ++f;
        rec = st;
        k = 0;
        used = 0;
        if (st < w.lo || st > hi) break;
      }
    }
    __syncwarp();
    f = __shfl_sync(kFull, f, 0);
    st = __shfl_sync(kFull, st, 0);
    rec = __shfl_sync(kFull, rec, 0);
    k = __shfl_sync(kFull, k, 0);
    used = (uint8_t)__shfl_sync(kFull, (int)used, 0);
    lap(1);
    for (int i = lane; i < f; i += 32) {
      states[(size_t)(t - i) * B + b] = recs[i];
      flags[(size_t)(t - i) * B + b] = marks[i];
    }
    __syncwarp();  // the next window is stashed over this one
    ahead = f == nfr && t2 >= 0 && st >= w.lo && st <= hi;
    t -= f;
  }
  if (trace && lane == 0) {
    long long* tr = trace + 5 * (size_t)b;
    tr[0] = cyc[0];
    tr[1] = cyc[1];
    tr[2] = n_wait;
    tr[3] = n_ahead;
    tr[4] = n;
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

// bp8 [T,S,B] i8, eps_u [T,R,B] i8 or i32, start_pos [S] / word_ends [L]
// i64, cross_src [S] i64 (null: no cross edges), the span hint [S] u8 (the
// word starts, and the arc starts of a graph with cross edges), end_state
// / nf [B] i32 -> states [T,B] i32, flags [T,B] u8 (0/1).  trace (null: off): [B][5] per stream, lane 0's
// cycles loading and stashing windows (and writing out), walking; the
// windows waited for, the windows loaded during the walk (same span or
// word change), the frames.
extern "C" int banded_backtrace_general_launch(
    const int8_t* bp8, const void* eps_u, int u_wide, const long long* start_pos,
    const long long* word_ends, const long long* cross_src, const uint8_t* is_start,
    const int* end_state, const int* nf, int* states, uint8_t* flags, int T, int S, int R,
    int L, int B, int eps_depth, long long* trace, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || L <= 0 || eps_depth < 1)
    return (int)cudaErrorInvalidValue;
  const long long tab = 4LL * (S + L) + (cross_src ? 4LL * S : 0) + ((S + 3) / 4) * 4LL;
  const int stage = tab <= kGenStageBytes;
  banded_backtrace_general_kernel<<<(B + kGenWarps - 1) / kGenWarps, kGenWarps * 32,
                                    stage ? (size_t)tab : 0, (cudaStream_t)stream>>>(
      bp8, eps_u, u_wide, start_pos, word_ends, cross_src, is_start, end_state, nf, states,
      flags, T, S, R, L, B, eps_depth, stage, trace);
  return (int)cudaGetLastError();
}
