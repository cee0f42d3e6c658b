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
// both) are past the 50 MB L2, so a step that reads device memory is a
// round trip (~0.5-1 us), while the bytes the walk needs (~0.3 MB) would
// take ~0.1 us at 3.35 TB/s.  The time is the longest stream's chain.
//
// Two forms, picked by ops/viterbi_kernels.dense_backtrace_plan:
//
// * window (planes whose state stride is 1, as K11 writes them): a lane
//   group walks one stream (a warp, or 32 / lanes streams a warp where S is
//   under 32) through windows of W frames x R consecutive states staged in
//   shared memory, so a round trip buys a window instead of a frame.  The
//   planes are [B, T, S], so a window's row is 4R contiguous bytes: one
//   bulk copy (Hopper's TMA, completion on an mbarrier) a row, issued by
//   the group's lanes a row each; where R == S and the rows are contiguous
//   (the block layout) the window is one segment a plane, one bulk copy (or
//   16 bytes a lane by cp.async where a plane's segment is under 4 KB, the
//   isolated shape's).  The window for (t, s) is frames [t - W + 1, t] x states
//   [s - R + 1, s] (clipped at 0; where R == S on a grid of W frames from
//   T - 1, so a warp's streams reload together): the paths' graphs are left
//   to right, so the walk's state never rises and stays in the window until
//   it falls below it or the frames run out.  While the group walks window
//   k, the window below it (the next W frames, the same states) is in
//   flight into the other stage; the walk takes it when it crosses the
//   frame edge at a state it holds, else drops it and loads the window of
//   its (frame, state): one round trip, exact either way.  Every lane of a
//   group walks the same chain in step (a broadcast read of one
//   shared-memory word), so whether to load is the same in every lane and
//   a group needs only __syncwarp over its lanes.
//   A frame costs instructions x latency with one warp an SM (the sausage's
//   64 streams), so the walk runs a tight loop for the common frame (state
//   in the window, no eps hop: one read at an index checked in place, the
//   eps origin beside it) and leaves it for any other frame; the states and
//   flags go to a ring of 32 frames in shared memory and out 32 at a time
//   (a store a frame, or one by lane 0 behind a branch, costs more:
//   scripts/exp_r20_k21_variants.py, exp_r20_walk_floor.py).
// * chain (any other strides, and S past K11's shared-memory frontier):
//   one thread a stream, the planes read in place; a frame's two reads (the
//   eps origin and the backpointer, both at the frame's state) are issued
//   together, so a frame without an eps hop costs one round trip.
//
// Optional per-stream counters of the window form (`stats`, [B, 7] int64,
// for the timing lab): windows walked, windows taken from the load ahead,
// loads ahead dropped, words staged, cycles waiting for copies to land,
// cycles in window changes (the waits, the copies' issue), cycles in all.

#include "common.cuh"

namespace {

constexpr int kChainThreads = 128;
constexpr int kMaxWarps = 4;  // window form: warps a CTA
constexpr int kStats = 7;
constexpr int kBulkBytes = 4096;  // a block-layout plane this large: one bulk copy
constexpr int kRingWords = 44;  // a stream's last 32 states and flags, two mbarriers

__device__ __forceinline__ int state_index(int s, int S) {
  if (s < 0) s += S;
  return s < 0 ? 0 : (s >= S ? S - 1 : s);
}

// bp / eps_bp: int32 planes with strides (b, t, s) in elements; end_state
// and nf [B] int32 -> states [B, T] int32, flags [B, T] u8 (0/1).
__global__ void __launch_bounds__(kChainThreads) dense_backtrace_chain_kernel(
    const int* __restrict__ bp, long long bp_b, long long bp_t, long long bp_s,
    const int* __restrict__ eps_bp, long long ep_b, long long ep_t, long long ep_s,
    const int* __restrict__ end_state, const int* __restrict__ nf, int* __restrict__ states,
    uint8_t* __restrict__ flags, int T, int S, int B, int eps_depth) {
  const int b = blockIdx.x * kChainThreads + threadIdx.x;
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
      int se = state_index(s, S);
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

// the 16-byte chunks that n words from address u span
__device__ __forceinline__ int chunks(uintptr_t u, int n) {
  return (((int)(u >> 2) & 3) + n + 3) >> 2;
}

// 16 bytes to a shared-space byte address (converted once, not a copy)
__device__ __forceinline__ void cp_async16_s(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
// One stream's windows.  Two stages in shared memory, each the bp rows then
// (eps_depth > 0) the eps_bp rows of one window; the current stage holds
// frames [wt, wt + W) x states [wlo, wlo + R), the other the load ahead
// (frames from pt, the same states; pt < 0: none in flight).  A row is
// one bulk copy of the 16-byte chunks that states [lo, lo + R) span, so
// its entry for state s sits ph + s - lo words into the row, ph the row's
// word phase ((address / 4) & 3); the chunks around a row's first and last
// state hold words of the same allocation (allocations are at least
// 16-byte aligned).  The group's lanes issue a row each and arrive on the
// stage's mbarrier with their rows' bytes.  In the block layout (R == S
// and both planes' frame stride S: K11's planes of S states) a window's
// rows are one segment a plane, with one phase a stage and plane: one bulk
// copy, or below kBulkBytes 16 bytes a lane by cp.async (waited for with
// cp.async.wait_group).
struct Windows {
  int buf;        // word index of the group's stages in smem
  unsigned sbuf;  // their shared-space byte address
  unsigned mbar;  // the stages' mbarriers (stage st's at mbar + 8 st)
  unsigned parity;  // bit st: the phase parity stage st's next fill completes
  const int* bp;
  const int* ep;
  long long bp_t, ep_t;
  unsigned abp, aep;  // the planes' word addresses, low bits (row phases)
  int W, R, S, T, lanes, l, plane, stage, rstride;
  bool block, grid, bulk;  // bulk: copies by the TMA unit, else cp.async
  unsigned mask;
  int cur, wt, wlo, pt;
  int cpb, cpe, apb, ape;  // block layout: phases of the current / ahead stage
  long long n_windows, n_ahead, n_dropped, words, wait, in_reload;

  // the window's rows [t_lo, t_hi] x states [lo, lo + R) of both planes
  // into stage st; returns the block layout's phases (bp, eps_bp).  The stage's
  // last reads (every lane's, before the caller's __syncwarp) come before
  // the copies' writes: a proxy fence orders the two
  __device__ __forceinline__ int2 issue(int st, int t_lo, int t_hi, int lo) {
    const unsigned dst = sbuf + 4u * (unsigned)(st * stage), bar = mbar + 8u * st;
    const int rows = t_hi - t_lo + 1;
    int2 ph = make_int2(0, 0);
    if (block) {
      // a segment a plane: one bulk copy, or below kBulkBytes 16-byte
      // chunks over the lanes (small copies: the lanes' cp.async beat one
      // bulk copy a stream)
      const uintptr_t ub = (uintptr_t)(bp + t_lo * bp_t), ue = (uintptr_t)(ep + t_lo * ep_t);
      ph = make_int2((int)(ub >> 2) & 3, (int)(ue >> 2) & 3);
      const int nb = chunks(ub, rows * S), ne = plane ? chunks(ue, rows * S) : 0;
      const char* gb = (const char*)(ub & ~(uintptr_t)15);
      const char* ge = (const char*)(ue & ~(uintptr_t)15);
      if (bulk) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive_expect(bar, l == 0 ? 16u * (nb + ne) : 0u);
        if (l == 0) {
          bulk_copy(dst, gb, 16u * nb, bar);
          if (ne) bulk_copy(dst + 4u * plane, ge, 16u * ne, bar);
        }
      } else {
        for (int c = l; c < nb; c += lanes) cp_async16_s(dst + 16u * c, gb + 16 * c);
        for (int c = l; c < ne; c += lanes)
          cp_async16_s(dst + 4u * plane + 16u * c, ge + 16 * c);
        cp_async_commit();
      }
      words += 4ll * (nb + ne);
    } else {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      unsigned mine = 0;
      for (int f = l; f < rows; f += lanes) {
        const long long t = t_lo + f;
        mine += 16u * chunks((uintptr_t)(bp + t * bp_t + lo), R);
        if (plane) mine += 16u * chunks((uintptr_t)(ep + t * ep_t + lo), R);
      }
      mbar_arrive_expect(bar, mine);
      for (int f = l; f < rows; f += lanes) {
        const long long t = t_lo + f;
        const unsigned d = dst + 4u * (unsigned)(f * rstride);
        const uintptr_t ub = (uintptr_t)(bp + t * bp_t + lo);
        bulk_copy(d, (const void*)(ub & ~(uintptr_t)15), 16u * chunks(ub, R), bar);
        if (plane) {
          const uintptr_t ue = (uintptr_t)(ep + t * ep_t + lo);
          bulk_copy(d + 4u * plane, (const void*)(ue & ~(uintptr_t)15), 16u * chunks(ue, R),
                    bar);
        }
      }
      words += __reduce_add_sync(mask, mine) / 4;
    }
    return ph;
  }

  // wait for stage st's fill to land (cp.async: this lane's copies, with
  // `newer` a later fill left in flight; bulk copies: the stage's mbarrier)
  __device__ __forceinline__ void land(int st, bool newer) {
    if (!bulk) {
      if (newer)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    } else {
      mbar_wait(mbar + 8u * st, (parity >> st) & 1u);
      parity ^= 1u << st;
    }
  }

  // the smem index of frame t's bp entry of state wlo in the current
  // stage, and how much further its eps_bp entries are; t >= wt
  __device__ __forceinline__ int2 row(int t) const {
    const int pb = block ? cpb : (int)((abp + (unsigned)t * (unsigned)bp_t + wlo) & 3u);
    const int pe = block ? cpe : (int)((aep + (unsigned)t * (unsigned)ep_t + wlo) & 3u);
    return make_int2(buf + cur * stage + (t - wt) * rstride + pb, plane ? plane + pe - pb : 0);
  }

  // the smem index of (t, se)'s bp entry and its eps_bp entry's distance,
  // loading its window where the current stage does not hold it
  __device__ __forceinline__ int2 at(int t, int se) {
    if (!(t >= wt && (unsigned)(se - wlo) < (unsigned)R)) reload(t, se);
    const int2 r = row(t);
    return make_int2(r.x + se - wlo, r.y);
  }

  __device__ __forceinline__ void reload(int t, int se) {
    const long long c0 = clock64();
    ++n_windows;
    if (pt >= 0 && t < wt && t >= pt && (unsigned)(se - wlo) < (unsigned)R) {
      // the window loaded ahead holds it: take it, and load the one below
      land(cur ^ 1, false);
      wait += clock64() - c0;
      __syncwarp(mask);
      ++n_ahead;
      cur ^= 1;
      wt = pt;
      cpb = apb;
      cpe = ape;
      pt = -1;
      if (wt > 0) {
        pt = max(0, wt - W);
        const int2 ph = issue(cur ^ 1, pt, wt - 1, wlo);
        apb = ph.x;
        ape = ph.y;
      }
    } else {
      // a miss: drop the load ahead (its copies land before the stage is
      // reused), load (t, se)'s window and the one below it
      if (pt >= 0) {
        land(cur ^ 1, false);
        ++n_dropped;
      }
      __syncwarp(mask);
      const int lo = max(0, se - R + 1);  // R <= S: lo + R <= S
      // R == S: windows on a frame grid from T - 1, the same for every
      // stream, so a warp's streams reload at the same frames
      const int top = grid ? T - 1 - W * ((T - 1 - t) / W) : t;
      const int t_lo = max(0, top - W + 1);
      const int2 ph = issue(cur ^ 1, t_lo, top, lo);
      cpb = ph.x;
      cpe = ph.y;
      pt = -1;
      const long long c1 = clock64();
      if (t_lo > 0) {
        pt = max(0, t_lo - W);
        const int2 pha = issue(cur, pt, t_lo - 1, lo);
        apb = pha.x;
        ape = pha.y;
      }
      land(cur ^ 1, pt >= 0);
      wait += clock64() - c1;
      __syncwarp(mask);
      cur ^= 1;
      wt = t_lo;
      wlo = lo;
    }
    in_reload += clock64() - c0;
  }
};

// bp / eps_bp: int32 planes with strides (b, t, 1); as the chain kernel.
// `lanes` (a power of two, <= min(32, R)) lanes walk each stream; a CTA
// holds blockDim.x / 32 warps; `block`: the block layout (see Windows).
__global__ void __launch_bounds__(kMaxWarps * 32) dense_backtrace_window_kernel(
    const int* __restrict__ bp, long long bp_b, long long bp_t,
    const int* __restrict__ eps_bp, long long ep_b, long long ep_t,
    const int* __restrict__ end_state, const int* __restrict__ nf, int* __restrict__ states,
    uint8_t* __restrict__ flags, int T, int S, int B, int eps_depth, int W, int R, int lanes,
    int block, long long* __restrict__ stats) {
  extern __shared__ __align__(16) int smem[];
  const long long c0 = clock64();
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x / lanes;  // the CTA's lane groups, in order
  const int b = blockIdx.x * (blockDim.x / lanes) + group;
  if (b >= B) return;  // the group's lanes leave together
  Windows w;
  w.l = lane % lanes;
  w.lanes = lanes;
  w.W = W;
  w.R = R;
  w.S = S;
  w.T = T;
  w.block = block != 0;
  w.grid = R == S;
  w.bulk = !w.block || W * S * 4 >= kBulkBytes;
  w.rstride = w.block ? S : 4 * ((R + 6) >> 2);  // words a row
  const int plane_words = w.block ? 4 * ((W * S + 6) >> 2) : W * w.rstride;
  w.plane = eps_depth > 0 ? plane_words : 0;
  w.stage = plane_words * (eps_depth > 0 ? 2 : 1);
  w.buf = group * (2 * w.stage + kRingWords);
  w.sbuf = (unsigned)__cvta_generic_to_shared(smem) + 4u * (unsigned)w.buf;
  w.mbar = w.sbuf + 4u * (unsigned)(2 * w.stage + 40);  // after the ring
  w.parity = 0;
  w.bp = bp + b * bp_b;
  w.ep = eps_bp + b * ep_b;
  w.bp_t = bp_t;
  w.ep_t = ep_t;
  w.abp = (unsigned)((uintptr_t)w.bp >> 2);
  w.aep = (unsigned)((uintptr_t)w.ep >> 2);
  w.mask = (lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u) << (lane - w.l);
  if (w.l == 0) {
    mbar_init(w.mbar, lanes);
    mbar_init(w.mbar + 8, lanes);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp(w.mask);
  w.cur = 0;
  w.wt = 0x7fffffff;  // nothing staged yet
  w.wlo = 0;
  w.pt = -1;
  w.cpb = w.cpe = w.apb = w.ape = 0;
  w.n_windows = w.n_ahead = w.n_dropped = w.words = w.wait = w.in_reload = 0;
  int* out = states + (long long)b * T;
  uint8_t* flag = flags + (long long)b * T;
  const int n = min(max(nf[b], 0), T);
  int s = end_state[b];
  // the walk's states and flags, kept for 32 frames in a ring in shared
  // memory and written together
  int* ring = smem + w.buf + 2 * w.stage;
  uint8_t* ring_f = (uint8_t*)(ring + 32);
  // a warp of one stream starts at its last frame (the frames past it
  // repeat the end state, flag 0, written here); a warp of several steps
  // every frame from T - 1 in step, so streams on one frame grid reload at
  // the same frames
  const int t0 = lanes == 32 ? n - 1 : T - 1;
  for (int t = t0 + 1 + w.l; t < T; t += lanes) {
    out[t] = s;
    flag[t] = 0;
  }
  for (int top = t0; top >= 0; top = (top & ~31) - 1) {
    const int bottom = top & ~31;
    int t = top;
    for (;;) {
      // frames below nf whose state the current window holds and that take
      // no eps hop: one read at a state index checked in place (the window
      // lies within [0, S), so no wrap or clamp applies), the eps origin
      // read beside it; any other frame leaves this loop
      for (; t >= bottom; --t) {
        ring[t & 31] = s;  // every lane of the group: one value, one address
        const bool active = t < n;
        const unsigned d = (unsigned)(s - w.wlo);
        const bool in = t >= w.wt && d < (unsigned)R;
        const int2 r = in ? w.row(t) : make_int2(w.buf, 0);
        const int k = r.x + (in ? (int)d : 0);
        const int p = smem[k];
        const int e = smem[k + r.y];
        if (active && (!in || (eps_depth > 0 && e >= 0))) break;
        if (active && t > 0) s = p;
        ring_f[t & 31] = 0;
      }
      if (t < bottom) break;
      // frame t in full: its window, the eps chain
      int se = state_index(s, S);
      int2 k = w.at(t, se);
      int p = smem[k.x];
      int e = smem[k.x + k.y];
      bool used = false;
      if (eps_depth > 0 && e >= 0) {
        used = true;
        for (int h = 1;; ++h) {
          se = state_index(e, S);
          const bool last = h >= eps_depth;
          if (last && t == 0) break;
          k = w.at(t, se);
          if (!last) e = smem[k.x + k.y];
          if (last || e < 0) {
            p = smem[k.x];
            break;
          }
        }
      }
      if (t > 0) s = p;
      ring_f[t & 31] = used;
      --t;
    }
    __syncwarp(w.mask);
    for (int t = bottom + w.l; t <= top; t += lanes) {
      out[t] = ring[t & 31];
      flag[t] = ring_f[t & 31];
    }
    __syncwarp(w.mask);
  }
  if (w.pt >= 0) w.land(w.cur ^ 1, false);  // a load ahead never taken lands first
  if (stats != nullptr && w.l == 0) {
    long long* st = stats + (long long)b * kStats;
    st[0] = w.n_windows;
    st[1] = w.n_ahead;
    st[2] = w.n_dropped;
    st[3] = w.words;
    st[4] = w.wait;
    st[5] = w.in_reload;
    st[6] = clock64() - c0;
  }
}

}  // namespace

// Shared memory a CTA of the window form needs (bytes): `warps` warps of
// 32 / lanes streams, two stages and an output ring each
// (ops/viterbi_kernels.window_smem mirrors it).
static long long window_smem(int W, int R, int S, int lanes, int warps, int depth, int block) {
  const long long plane =
      block ? 4 * ((W * (long long)S + 6) >> 2) : (long long)W * 4 * ((R + 6) >> 2);
  return (long long)warps * (32 / lanes) * (2 * plane * (depth > 0 ? 2 : 1) + kRingWords) * 4;
}

// form 0: chain (W, R, lanes, warps, grid, smem, block and stats unused);
// 1: window, `grid` CTAs of `warps` warps with `smem` bytes of dynamic
// shared memory, `block` the block layout (R == S, frame strides S).
extern "C" int dense_backtrace_launch(int form, const int* bp, long long bp_b, long long bp_t,
                                      long long bp_s, const int* eps_bp, long long ep_b,
                                      long long ep_t, long long ep_s, const int* end_state,
                                      const int* nf, int* states, uint8_t* flags, int T, int S,
                                      int B, int eps_depth, int W, int R, int lanes, int warps,
                                      int grid, int smem, int block, long long* stats,
                                      void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || eps_depth < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (form == 0) {
    dense_backtrace_chain_kernel<<<(B + kChainThreads - 1) / kChainThreads, kChainThreads, 0,
                                   st>>>(bp, bp_b, bp_t, bp_s, eps_bp, ep_b, ep_t, ep_s,
                                         end_state, nf, states, flags, T, S, B, eps_depth);
    return (int)cudaGetLastError();
  }
  if (form != 1 || bp_s != 1 || (eps_depth > 0 && ep_s != 1) || W < 1 || R < 1 || R > S ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || lanes > R || warps < 1 ||
      warps > kMaxWarps || grid < 1 || (long long)grid * warps * (32 / lanes) < B ||
      (block && (R != S || bp_t != S || (eps_depth > 0 && ep_t != S))) ||
      window_smem(W, R, S, lanes, warps, eps_depth, block) > smem)
    return (int)cudaErrorInvalidValue;
  SRT_SET_SMEM(dense_backtrace_window_kernel, smem);
  dense_backtrace_window_kernel<<<grid, warps * 32, smem, st>>>(
      bp, bp_b, bp_t, eps_bp, ep_b, ep_t, end_state, nf, states, flags, T, S, B, eps_depth, W,
      R, lanes, block, stats);
  return (int)cudaGetLastError();
}
