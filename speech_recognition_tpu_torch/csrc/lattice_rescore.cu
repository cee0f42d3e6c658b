// K7: exact bigram rescoring over the word lattice.
//
// Replaces the TPU kernel speech_recognition_tpu/ops/lattice.py
// _hq_sweep_pallas (its inner `kern`): the blocked lookup of H - Q rows in
// a VMEM-resident ring, which exists because XLA would not keep the
// [dmax, B, L] ring resident across the rescoring scan.  On the card the
// lookup is one indexed load, so this kernel is the whole rescoring DP of
// ops/lattice.rescore_tbl (the plain version, which the tests hold against
// the reference's lattice_rescore bit for bit).  Per stream b and frame
// t < T, over leaf slots l (planes ends_cost, ends_tau [T, B, L]):
//   D[l]     s0 + start_l[l] where tau <= 0; otherwise s0 + hq with hq the
//            STORED (rounded) H - q row of frame tau, live only for
//            tau < t and t - tau <= dmax, else POS_INF
//   backoff  (base_l [L], pidx [L, K], pcost [L, K]): m_all / arg_all the
//            first minimum of D + base_l; per target j the sparse
//            candidates D[pidx[j, k]] + pcost[j, k] in k order, replacing
//            only on strictly smaller; the sparse one wins only if strictly
//            below m_all; H = min(., POS_INF)
//   dense    (big [L, L], source-major): H[j] = min(first minimum over the
//            source i of D[i] + big[i, j], POS_INF)
//   store    pred_w[t, b, j] = the winning source; ring row t % dmax = H - q[t]
//   end      D at frame clip(nf - 1, 0, T - 1) plus end_l, first minimum ->
//            cost[b], best_leaf[b]
//
// What bounds it on the H100: one CTA owns one stream for all T frames, so
// a frame's time is the latency of its dependent steps: the frame's
// ends_cost / ends_tau rows from device memory, then the ring rows that
// tau selects, then the block-wide argmin, then the sparse gathers of D,
// with barriers between.  The bytes per frame are small (8L of lattice
// rows, up to 4L of ring, 8L of pred_w and ring written): at 128 x 500 on
// the 1k trie the whole DP moves ~1.3 GB, ~0.4 ms at 3.35 TB/s.  The ring
// is [B, dmax, L] floats in device memory: 65.5 MB at B = 128, dmax = 128,
// L = 1,000, more than the 50 MB L2, so a ring read may go to device memory.
//
// What the staged mode does about it (ops/lattice_kernels.rescore_plan):
// each thread owns the leaves l = tid + i * threads (i < kNL), and every
// per-leaf quantity stays with its owner, so the frame loop has ONE block
// barrier, the one that publishes D to the sparse gathers.
// - The lattice rows of frame t + 2 are copied with cp.async into a ring
//   of kDepth = 3 shared-memory rows while frame t computes; each
//   thread copies and reads only its own leaves, so a wait_group, not a
//   barrier, makes them visible.
// - The ring column l is written and read only by leaf l's owner.  The
//   next frame's ring reads (tau <= t - 1: final rows) are issued into
//   registers right after this frame's D, so they are in flight across
//   the barrier and the sparse phase; the newest row (tau = t, written this
//   frame) stays in a register.  Slot (t + 1) % dmax is overwritten only in
//   frame t + 1, after its read; no live lookup at frame t + 1 maps to the
//   slot written at frame t.
// - D and the argmin partials are double-buffered by frame parity, so the
//   next frame writes them without waiting for this frame's readers; the
//   block argmin is one barrier: each warp publishes its (value, index)
//   and every warp reduces the partials itself.
// - pidx / pcost are staged transposed ([K, L]) in shared memory where
//   they fit (the 1k trie), else read through L1 (the dictionary-shaped
//   trie).
// Where even the D rows and three row frames do not fit (over ~7,200
// leaves) or a thread would own more than 8 leaves, the direct mode runs:
// 1,024 threads per stream, the D row (and D at the last frame) in shared
// memory or, past ~29,000 leaves, in a device-memory scratch, the rows
// read where they lie, four barriers per frame.
//
// Every launch (ops/lattice_kernels.rescore_and_walk; rescore_lattice
// with no walk) also does three jobs that were launches of their own, in
// both modes:
// - q, the per-frame minimum of ends_cost, from the rows the kernel reads
//   anyway: each thread's minimum over its leaves, a warp redux.sync of
//   its order-preserving key, published beside the argmin partials at the
//   frame's barrier and reduced by every warp.  The staged mode reduces
//   q[t + 1] in frame t, from the rows already landed for it, so no frame
//   waits for its own q (q[0] takes one barrier before the first frame);
//   the direct mode reduces q[t] behind one more barrier in frame t.  A
//   float minimum does not depend on order, so q equals ends_cost.amin(2)
//   bit for bit.
// - the truncation count of the reference's _lattice_truncation_count:
//   the (t, l) with t < nf, ends_cost < POS_INF / 2 and t - tau > max_dur,
//   a register count a thread, one block sum at the end into n_trunc[b].
// - K22's word walk (lattice_walk.cuh) from the best leaf: past the block
//   barrier of the final argmin every pred_w store of the CTA is visible,
//   so lane 0 of warp 0 follows the chain on the rows just written and the
//   warp writes the rows of -1.

#include <limits.h>
#include <math.h>

#include "lattice_walk.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // == 32: one reduction warp

struct Params {
  const float* ends_cost;  // [T, B, L]
  const int* ends_tau;     // [T, B, L]
  const float* start_l;    // [L]
  const float* end_l;      // [L]
  const int* nf;           // [B]
  const float* big;        // [L, L] dense LM (source, target) or null
  const float* base_l;     // [L] backoff level or null
  const int* pidx;         // [L, K] seen predecessors (target-major)
  const float* pcost;      // [L, K]
  const int2* tab;         // [K, L] (pidx, pcost bits): the staged mode's copy
  float* ring;             // [B, dmax, L] H - q rows
  float* scratch;          // [B, 2, L] D rows (direct mode past shared memory)
  long long* trace;        // [B, kPhases] staged-mode cycles per phase, or null
  float* cost;             // [B]
  int* best_leaf;          // [B]
  int* pred_w;             // [T, B, L]
  float* q_out;            // [T, B] the q the kernel computed, or null
  int* n_trunc;            // [B] truncated live arcs
  int* leaves_rev;         // [max_words, B] the walk's leaves
  int* n_words;            // [B] the walk's words
  int T, B, L, K, dmax, max_dur, max_words;
};

constexpr int kPhases = 4;  // row wait, D + gathers, barrier, recombination

size_t smem_bytes(int L) { return (size_t)2 * L * sizeof(float); }

// Staged mode: every shared-memory row is Lp = L rounded up to 4 floats:
// D [2][Lp], the lattice rows ends_cost / ends_tau [kDepth][Lp] each, and
// (tables) the packed (pidx, pcost) pairs [K][Lp].
constexpr int kDepth = 3;
size_t staged_smem_bytes(int L, int K, bool tables) {
  const size_t lp = ((size_t)L + 3) & ~(size_t)3;
  return 4 * lp * (2 + 2 * kDepth + (tables ? 2 * (size_t)K : 0));
}

// (value, leaf index) lexicographic min: the first minimum in leaf order.
__device__ __forceinline__ void argmin_merge(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide first minimum; every thread gets the result.  Contains
// barriers, so all threads must call it.
__device__ void block_argmin(float& v, int& i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    argmin_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                 __shfl_xor_sync(0xffffffffu, i, off));
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = red_v[lane];
    i = red_i[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      argmin_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                   __shfl_xor_sync(0xffffffffu, i, off));
    if (lane == 0) {
      red_v[0] = v;
      red_i[0] = i;
    }
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  __syncthreads();  // red_v / red_i are reused by the next call
}

// An order-preserving 32-bit key of a float (-0 taken as +0), and back.
__device__ __forceinline__ unsigned fkey(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float fval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// Warp-wide first minimum, (value, index) lexicographic, every lane gets
// it: two redux.sync (the least key, then the least index holding it)
// where the shuffle tree takes ten shuffles.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  const unsigned k = fkey(v), m = __reduce_min_sync(0xffffffffu, k);
  i = (int)__reduce_min_sync(0xffffffffu, k == m ? (unsigned)i : 0xffffffffu);
  v = fval(m);
}

// An arc the rescorer drops for its length (the reference's truncation
// count): live (t < nf, cost below POS_INF / 2) and longer than max_dur,
// i.e. tau < lim = t - max_dur; `live_t` is t < nf, known once a frame.
__device__ __forceinline__ int truncated(bool live_t, int lim, float s0, int tau) {
  return live_t & (tau < lim) & (s0 < SRT_POS_INF * 0.5f);
}

// K22's walk as the last step of stream b's CTA, in one warp: lane 0
// follows the chain from `best` on the [T, B, L] planes, then the warp
// writes the rows of -1.  Call past a block barrier that follows every
// pred_w store of the CTA.
__device__ __forceinline__ void walk_tail(const Params& p, int b, int best, int nf, int lane) {
  const long long row = (long long)p.B * p.L;
  int k = 0, count = 0;
  if (lane == 0)
    k = lattice_walk_chain(p.pred_w, row, 1, p.L, p.ends_tau, row, 1, p.L, b, best, nf, p.T,
                           p.L, p.B, p.max_words, p.leaves_rev, count);
  k = __shfl_sync(0xffffffffu, k, 0);
  for (int r = k + lane; r < p.max_words; r += 32) p.leaves_rev[(size_t)r * p.B + b] = -1;
  if (lane == 0) p.n_words[b] = count;
}

// Direct mode.  kScratch: the D rows live in p.scratch, not shared memory.
template <bool kScratch>
__global__ void __launch_bounds__(kThreads, 1) lattice_rescore_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  float* d = kScratch ? p.scratch + (size_t)b * 2 * p.L : smem;  // [L] this frame's D
  float* dfin = d + p.L;    // [L] D at the stream's last frame
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int L = p.L, K = p.K, dmax = p.dmax;
  const int lane = tid & 31, warp = tid >> 5;
  const bool backoff = p.base_l != nullptr;
  float* ring = p.ring + (size_t)b * dmax * L;
  const int nf = p.nf[b];
  const int t_fin = min(max(nf - 1, 0), p.T - 1);
  int n_long = 0;  // this thread's truncated arcs

  for (int t = 0; t < p.T; ++t) {
    const size_t row = ((size_t)t * p.B + b) * L;
    const bool live_t = t < nf;
    const int lim = t - p.max_dur;
    float mv = INFINITY;  // first minimum of D + base_l (backoff)
    int mi = INT_MAX;
    float qmin = INFINITY;  // this thread's minimum of ends_cost
    for (int l = tid; l < L; l += kThreads) {
      const float s0 = __ldg(p.ends_cost + row + l);
      const int tau = __ldg(p.ends_tau + row + l);
      qmin = fminf(qmin, s0);
      n_long += truncated(live_t, lim, s0, tau);
      float dl;
      if (tau <= 0) {
        dl = s0 + __ldg(p.start_l + l);
      } else {
        const float hq = (tau < t && t - tau <= dmax)
                             ? ring[(size_t)(tau % dmax) * L + l]
                             : SRT_POS_INF;
        dl = s0 + hq;
      }
      d[l] = dl;
      if (t == t_fin) dfin[l] = dl;
      if (backoff) {
        const float db = dl + __ldg(p.base_l + l);
        if (db < mv) {  // strict: first minimum among this thread's leaves
          mv = db;
          mi = l;
        }
      }
    }
    if (backoff)
      block_argmin(mv, mi, red_v, red_i);  // its barriers also publish d
    else
      __syncthreads();

    // red_v is free: block_argmin's last barrier follows its reads, and
    // the next frame writes it after the barrier that ends this one
    unsigned* red_q = reinterpret_cast<unsigned*>(red_v);
    const unsigned wk = __reduce_min_sync(0xffffffffu, fkey(qmin));
    if (lane == 0) red_q[warp] = wk;
    __syncthreads();
    const float qt = fval(__reduce_min_sync(0xffffffffu, red_q[lane]));
    if (p.q_out != nullptr && tid == 0) p.q_out[(size_t)t * p.B + b] = qt;
    float* ring_row = ring + (size_t)(t % dmax) * L;
    for (int j = tid; j < L; j += kThreads) {
      float h;
      int pj;
      if (backoff) {
        float hs = SRT_POS_INF;
        int ps = 0;
        for (int k = 0; k < K; ++k) {
          const int src = __ldg(p.pidx + (size_t)j * K + k);
          const float c = d[src] + __ldg(p.pcost + (size_t)j * K + k);
          if (c < hs) {
            hs = c;
            ps = src;
          }
        }
        const bool take = hs < mv;
        h = fminf(take ? hs : mv, SRT_POS_INF);
        pj = take ? ps : mi;
      } else {
        float m = d[0] + __ldg(p.big + j);
        int a = 0;
        for (int i = 1; i < L; ++i) {
          const float c = d[i] + __ldg(p.big + (size_t)i * L + j);
          if (c < m) {
            m = c;
            a = i;
          }
        }
        h = fminf(m, SRT_POS_INF);
        pj = a;
      }
      p.pred_w[row + j] = pj;
      // this frame's reads of the slot (tau = t - dmax) all came before
      // the barrier above; later frames read it after the one below
      ring_row[j] = h - qt;
    }
    __syncthreads();  // d is rewritten next frame
  }

  float fv = INFINITY;
  int fi = INT_MAX;
  for (int l = tid; l < L; l += kThreads) {
    const float c = dfin[l] + __ldg(p.end_l + l);
    if (c < fv) {
      fv = c;
      fi = l;
    }
  }
  block_argmin(fv, fi, red_v, red_i);  // ends with a barrier
  if (tid == 0) {
    p.cost[b] = fv;
    p.best_leaf[b] = fi;
  }
  const int wc = __reduce_add_sync(0xffffffffu, n_long);
  if (lane == 0) red_i[warp] = wc;
  __syncthreads();
  if (warp == 0) {
    const int c = __reduce_add_sync(0xffffffffu, red_i[lane]);
    if (lane == 0) p.n_trunc[b] = c;
    // every pred_w store came before the frame loop's last barrier
    walk_tail(p, b, fi, nf, lane);
  }
}

// Staged mode (see the header): kNL leaves per thread, kDense the dense
// recombination, kTables pidx / pcost in shared memory.
template <int kNL, bool kDense, bool kTables>
__global__ void __launch_bounds__(kThreads, 1)
lattice_rescore_staged_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ unsigned red_q[2][kWarps];  // q's keys; at the end the counts
  const int L = p.L, K = p.K, T = p.T, B = p.B, dmax = p.dmax;
  const int lp = (L + 3) & ~3;
  float* dbuf = smem;                                  // [2][lp]
  float* rcost = dbuf + 2 * lp;                             // [kDepth][lp]
  int* rtau = reinterpret_cast<int*>(rcost + kDepth * lp);   // [kDepth][lp]
  int2* stab = reinterpret_cast<int2*>(rtau + kDepth * lp);  // [K][lp]
  const int tid = threadIdx.x, nthr = blockDim.x, b = blockIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  float* ring = p.ring + (size_t)b * dmax * L;
  const int nf = p.nf[b];
  const int t_fin = min(max(nf - 1, 0), T - 1);
  int n_long = 0;  // this thread's truncated arcs

  if constexpr (kTables)  // read after the first frame's barrier
    for (int x = tid; x < L * K; x += nthr) {
      const int k = x / L, j = x - k * L;
      stab[k * lp + j] = __ldg(p.tab + x);
    }
  // the lattice rows of frame f into row slot `slot`, own leaves only;
  // one commit group per frame (empty past T)
  auto issue_rows = [&](int f, int slot) {
    if (f < T) {
      const size_t row = ((size_t)f * B + b) * L;
      float* dc = rcost + slot * lp;
      int* dt = rtau + slot * lp;
#pragma unroll
      for (int i = 0; i < kNL; ++i) {
        const int l = tid + i * nthr;
        if (l < L) {
          cp_async4(dc + l, p.ends_cost + row + l);
          cp_async4(dt + l, p.ends_tau + row + l);
        }
      }
    }
    cp_async_commit();
  };
  for (int f = 0; f < kDepth - 1; ++f) issue_rows(f, f);

  float hq_next[kNL], newest[kNL], dfin[kNL];
#pragma unroll
  for (int i = 0; i < kNL; ++i) hq_next[i] = newest[i] = dfin[i] = SRT_POS_INF;
  // q one frame ahead: frame t reduces q[t + 1] from the rows already
  // landed for it, so no frame waits on its own q; q[0] first, behind
  // one barrier of its own
  float q_next;
  {
    cp_async_wait<kDepth - 2>();  // frame 0's rows
    float qmin = INFINITY;
#pragma unroll
    for (int i = 0; i < kNL; ++i)
      if (tid + i * nthr < L) qmin = fminf(qmin, rcost[tid + i * nthr]);
    const unsigned wk = __reduce_min_sync(0xffffffffu, fkey(qmin));
    if (lane == 0) red_q[1][warp] = wk;
    __syncthreads();  // frame 1 rewrites red_q[1] only past frame 0's barrier
    q_next = fval(__reduce_min_sync(0xffffffffu, lane < nwarps ? red_q[1][lane] : ~0u));
  }
  long long tr[kPhases] = {0, 0, 0, 0};
  long long tc = p.trace ? clock64() : 0;
  auto stamp = [&](int k) {
    if (p.trace) {
      const long long now = clock64();
      tr[k] += now - tc;
      tc = now;
    }
  };

  // slots without a division in the loop: rows of frame t in slot rs
  // (t % kDepth), H - q of frame t in ring slot qs (t % dmax)
  for (int t = 0, rs = 0, qs = 0; t < T; ++t) {
    const int rs_prev = rs == 0 ? kDepth - 1 : rs - 1, rs_next = rs == kDepth - 1 ? 0 : rs + 1;
    issue_rows(t + kDepth - 1, rs_prev);  // frame t - 1's slot is free
    // rows of frames t and t + 1 complete; later frames may be in flight
    cp_async_wait<kDepth - 2>();
    stamp(0);
    const float* rc = rcost + rs * lp;
    const int* rt = rtau + rs * lp;
    float* d = dbuf + (t & 1) * lp;
    const float qt = q_next;
    const bool live_t = t < nf;
    const int lim = t - p.max_dur;
    const int* rt1 = rtau + rs_next * lp;
    const float* rc1 = rcost + rs_next * lp;
    float mv = INFINITY;  // first minimum of D + base_l over own leaves
    int mi = INT_MAX;
    float qmin = INFINITY;  // frame t + 1's minimum over own leaves
#pragma unroll
    for (int i = 0; i < kNL; ++i) {
      const int l = tid + i * nthr;
      if (l < L) {
        const float s0 = rc[l];
        const int tau = rt[l];
        if (t + 1 < T) qmin = fminf(qmin, rc1[l]);
        n_long += truncated(live_t, lim, s0, tau);
        const bool live = tau > 0 && tau < t && t - tau <= dmax;
        const float hq = live ? (tau == t - 1 ? newest[i] : hq_next[i]) : SRT_POS_INF;
        const float dl = tau <= 0 ? s0 + __ldg(p.start_l + l) : s0 + hq;
        d[l] = dl;
        if (t == t_fin) dfin[i] = dl;
        if (!kDense) {
          const float db = dl + __ldg(p.base_l + l);
          if (db < mv) {  // strict, leaves ascending: the first minimum
            mv = db;
            mi = l;
          }
        }
        // the next frame's ring value, in flight across the barrier: the
        // same row as this frame's needs no read; else a final row
        // (tau <= t - 1) is read; tau = t comes from `newest`
        if (t + 1 < T) {
          const int tau1 = rt1[l];
          if (tau1 == tau && live)
            hq_next[i] = hq;
          else if (tau1 > 0 && tau1 < t && t + 1 - tau1 <= dmax) {
            const int slot = qs - (t - tau1);  // tau1 % dmax
            hq_next[i] = ring[(size_t)(slot < 0 ? slot + dmax : slot) * L + l];
          }
        }
      }
    }
    if (!kDense) {
      warp_argmin(mv, mi);
      if (lane == 0) {
        red_v[t & 1][warp] = mv;
        red_i[t & 1][warp] = mi;
      }
    }
    {
      const unsigned wk = __reduce_min_sync(0xffffffffu, fkey(qmin));
      if (lane == 0) red_q[t & 1][warp] = wk;
    }
    stamp(1);
    __syncthreads();  // D and the partials of frame t are published
    stamp(2);
    if (!kDense) {
      mv = lane < nwarps ? red_v[t & 1][lane] : INFINITY;
      mi = lane < nwarps ? red_i[t & 1][lane] : INT_MAX;
      warp_argmin(mv, mi);
    }
    // q[t + 1], first used next frame
    q_next = fval(__reduce_min_sync(0xffffffffu, lane < nwarps ? red_q[t & 1][lane] : ~0u));
    if (p.q_out != nullptr && tid == 0) p.q_out[(size_t)t * B + b] = qt;
    float* ring_row = ring + (size_t)qs * L;
    const size_t row = ((size_t)t * B + b) * L;
#pragma unroll
    for (int i = 0; i < kNL; ++i) {
      const int j = tid + i * nthr;
      if (j < L) {
        float h;
        int pj;
        if constexpr (kDense) {
          float m = d[0] + __ldg(p.big + j);
          int a = 0;
          for (int s = 1; s < L; ++s) {
            const float c = d[s] + __ldg(p.big + (size_t)s * L + j);
            if (c < m) {
              m = c;
              a = s;
            }
          }
          h = fminf(m, SRT_POS_INF);
          pj = a;
        } else {
          float hs = SRT_POS_INF;
          int ps = 0;
          auto pair = [&](int k) {
            return kTables ? stab[k * lp + j] : __ldg(p.tab + (size_t)k * L + j);
          };
          // four pairs at a time: their loads, then their D gathers, are
          // independent; the compares stay in k order
          int k = 0;
          for (; k + 4 <= K; k += 4) {
            int2 e[4];
            float c[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) e[u] = pair(k + u);
#pragma unroll
            for (int u = 0; u < 4; ++u) c[u] = d[e[u].x] + __int_as_float(e[u].y);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c[u] < hs) {
                hs = c[u];
                ps = e[u].x;
              }
          }
          for (; k < K; ++k) {
            const int2 e = pair(k);
            const float c = d[e.x] + __int_as_float(e.y);
            if (c < hs) {
              hs = c;
              ps = e.x;
            }
          }
          const bool take = hs < mv;
          h = fminf(take ? hs : mv, SRT_POS_INF);
          pj = take ? ps : mi;
        }
        __stcs(p.pred_w + row + j, pj);
        const float v = h - qt;
        ring_row[j] = v;
        newest[i] = v;
      }
    }
    stamp(3);
    rs = rs_next;
    qs = qs == dmax - 1 ? 0 : qs + 1;
  }

  // red[T & 1] was last read in frame T - 2, before frame T - 1's barrier
  float fv = INFINITY;
  int fi = INT_MAX;
#pragma unroll
  for (int i = 0; i < kNL; ++i) {
    const int l = tid + i * nthr;
    if (l < L) {
      const float c = dfin[i] + __ldg(p.end_l + l);
      if (c < fv) {
        fv = c;
        fi = l;
      }
    }
  }
  warp_argmin(fv, fi);
  const unsigned wc = __reduce_add_sync(0xffffffffu, (unsigned)n_long);
  if (lane == 0) {
    red_v[T & 1][warp] = fv;
    red_i[T & 1][warp] = fi;
    red_q[T & 1][warp] = wc;
  }
  // the partials are published, and every pred_w store of the CTA is
  // visible to the walk past this barrier
  __syncthreads();
  if (warp == 0) {
    fv = lane < nwarps ? red_v[T & 1][lane] : INFINITY;
    fi = lane < nwarps ? red_i[T & 1][lane] : INT_MAX;
    warp_argmin(fv, fi);
    const unsigned c = __reduce_add_sync(0xffffffffu, lane < nwarps ? red_q[T & 1][lane] : 0u);
    if (lane == 0) {
      p.cost[b] = fv;
      p.best_leaf[b] = fi;
      p.n_trunc[b] = (int)c;
    }
    // no clock reads around the walk: with them the launch ran ~1.5%
    // slower, trace or no trace (scripts/exp_r9_k7_variants.py, "walk
    // clock")
    walk_tail(p, b, fi, nf, lane);
  }
  if (p.trace && tid == 0)
    for (int k = 0; k < kPhases; ++k) p.trace[(size_t)b * kPhases + k] = tr[k];
}

template <int kNL>
int launch_staged(const Params& p, bool tables, int threads, cudaStream_t stream) {
  void (*kern)(Params) = p.big != nullptr ? lattice_rescore_staged_kernel<kNL, true, false>
                         : tables         ? lattice_rescore_staged_kernel<kNL, false, true>
                                          : lattice_rescore_staged_kernel<kNL, false, false>;
  const size_t smem = staged_smem_bytes(p.L, p.K, tables);
  SRT_SET_SMEM(kern, smem);
  kern<<<p.B, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lattice_rescore_smem_bytes(int L) {
  const size_t n = smem_bytes(L);
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
}

extern "C" int lattice_rescore_staged_smem_bytes(int L, int K, int tables) {
  const size_t n = staged_smem_bytes(L, K, tables != 0);
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
}

// leaves (1, 2, 4 or 8): the staged mode with that many leaves per thread,
// `threads` threads per CTA and the LM tables in shared memory when
// `tables`; it reads the backoff LM's pairs from tab ([K, L, 2] int32:
// pidx, pcost's bits) and ignores pidx / pcost; trace: null or [B, 4]
// int64.
// leaves 0: the direct mode, its D rows in shared memory, or in `scratch`
// ([B, 2, L] floats) when it is not null.
// Every launch computes q ([T, B] into q_out when not null), counts the
// arcs past max_dur into n_trunc ([B]) and walks each stream's words into
// leaves_rev ([max_words, B]; null when max_words is 0) and n_words ([B]).
extern "C" int lattice_rescore_launch(
    const float* ends_cost, const int* ends_tau, const float* start_l, const float* end_l, const int* nf, const float* big,
    const float* base_l, const int* pidx, const float* pcost, const int* tab,
    float* ring,
    float* cost, int* best_leaf, int* pred_w, int T, int B, int L, int K,
    int dmax, int leaves, int threads, int tables, float* scratch,
    long long* trace, float* q_out, int* n_trunc, int max_dur, int* leaves_rev,
    int* n_words, int max_words, void* stream) {
  const bool dense = big != nullptr;
  if (B <= 0 || T <= 0 || L <= 0 || dmax <= 0 ||
      dense == (base_l != nullptr) ||
      (!dense && (K <= 0 || pidx == nullptr || pcost == nullptr)) ||
      n_trunc == nullptr || n_words == nullptr || max_dur < 1 || max_words < 0 ||
      (max_words > 0 && leaves_rev == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{ends_cost, ends_tau, start_l, end_l, nf, big, base_l, pidx,
           pcost, reinterpret_cast<const int2*>(tab), ring, scratch, trace, cost,
           best_leaf, pred_w, q_out, n_trunc, leaves_rev, n_words, T, B, L,
           dense ? 0 : K, dmax, max_dur, max_words};
  const cudaStream_t st = (cudaStream_t)stream;
  if (leaves == 0) {
    if (scratch != nullptr) {
      lattice_rescore_kernel<true><<<B, kThreads, 0, st>>>(p);
    } else {
      const size_t smem = smem_bytes(L);
      SRT_SET_SMEM(lattice_rescore_kernel<false>, smem);
      lattice_rescore_kernel<false><<<B, kThreads, smem, st>>>(p);
    }
    return (int)cudaGetLastError();
  }
  if (threads % 32 != 0 || threads > kThreads || (size_t)threads * leaves < (size_t)L ||
      (tables && dense) || (!dense && tab == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (leaves) {
    case 1: return launch_staged<1>(p, tables, threads, st);
    case 2: return launch_staged<2>(p, tables, threads, st);
    case 4: return launch_staged<4>(p, tables, threads, st);
    case 8: return launch_staged<8>(p, tables, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
