// K15 and K16: the log-space forward-backward (sum-product) pass, banded
// and dense.  Each call is two launches: a scan (the forward and the
// backward of every item side by side) and a combine pass (gamma and the
// xi sums).
//
// Neither has a TPU kernel: each replaces a pass the JAX package leaves to
// XLA as lax.scans, speech_recognition_tpu/ops/forward_backward.py
//   K15  forward_backward_banded (:259): band [3, S] logsumexp, static
//        cross edges, eps_depth passes over the [R, L] eps block;
//   K16  forward_backward (:62): a [S, S] logsumexp matvec per frame and
//        eps passes over a [S, S] eps matrix, xi_mode "band" or "dense".
// Per item b, as ops/forward_backward.py's plain versions compute it (the
// JAX formulas op for op, in f32 with IEEE expf / logf / log1pf: this
// source is built without --use_fast_math):
//   log_e = -min(nll, POS_INF); scores = cost >= POS_INF / 2 ? NEG_INF : -cost;
//   LSE(z) = log(sum exp(z - m)) + m over a finite max m, NEG_INF where m
//     is not finite; logaddexp as torch.logaddexp;
//   alpha[0] = eps_fwd(init + log_e[0]); alpha[t] = eps_fwd(LSE over the
//     frame edges of alpha[t - 1] + log_e[t]) for t < nf, frozen after;
//   log Z = jax logsumexp(alpha[max(nf, 1) - 1] + end_scores);
//   beta[t] = end_scores for t >= nf - 1, else LSE over the frame edges
//     leaving each state of eps_bwd(beta[t + 1]) + log_e[t + 1];
//   gamma[t] = exp(min(alpha[t] + beta[t] - log Z, 50)) for t < nf, else 0;
//   xi[d, u] += exp(min(alpha[t - 1, u] + logT[u + d, u] + log_e[t, u + d]
//     + beta[t, u + d] - log Z, 50)) for 1 <= t < nf (dense: every
//     (to, from) pair); xi_cross[s] the same for the cross edge into s.
// Emissions are read as the graph-order nll [B, T, S] the JAX function
// takes.  end_scores may be null (0 everywhere); n_frames int32 or int64.
//
// What bounds them on the H100.  Each frame of an item depends on the one
// before, so an item's scan is a serial chain of block steps: a frame is
// 1 + eps_depth steps (K16) or 1 + 2 eps_depth (K15), each ending in a
// block barrier.  The exps, logs and bytes of a whole call are a small
// share of its time (chip_smoke's bounds): the chain of dependent IEEE
// expf / logf / log1pf and shared-memory loads in each step, and the
// barrier and block max that close it, is what remains (a step of one
// 2-term LSE, a logaddexp and a block max takes ~0.8-1.0 k cycles on an
// H100 at K16's 7 CTAs an SM; the scans' clock64 traces read ~1.6-2.7 k a
// step: scripts/exp_r14_forward_backward.py --lab).  The design shortens
// the chain:
// - the scan runs 2B CTAs, item b's forward (2b) and its backward (2b + 1)
//   at the same time: beta does not depend on alpha, so the chain is the
//   longer of the two, not their sum.  Each writes its rows to a [B, T, S]
//   plane (alpha, beta; the forward also log Z);
// - gamma and the xi sums leave the chain: the combine pass, a thread per
//   (item, state) (dense xi: per (item, to, from) pair) looping over t in
//   ascending order (the JAX scan's), reads the two planes.  No atomics:
//   every sum has one owner and one order, so two calls agree bit for bit;
// - each frame's emission row is staged two frames ahead in a shared ring
//   by cp.async (where the plan finds room), off the chain;
// - K15's eps pass is a thread per start row (backward: end column) over
//   its finite span, the max and sum passes in registers, the span's terms
//   (score, state) staged in shared memory with the ring: one barrier
//   before the apply and one after it, where a warp per row and a staging
//   gather took three.  Spans wider than FB_WIDE_SPAN (the 1k trie's 8 x
//   1,000 block) keep a warp per row.  The apply runs a logaddexp only for
//   the start (end) states, a thread a row (column); every other state's
//   logaddexp with NEG_INF is exactly fmaxf(x, NEG_INF).  The spans and end
//   positions are found by each CTA at its start, not by the wrapper;
// - K16's matvecs loop over the finite entries only.  Each CTA builds, in
//   shared memory where the plan finds room (else in device memory), CSR
//   lists of its matrices' finite entries, rows for the forward and
//   columns for the backward, each in ascending index order.  An LSE over
//   a list is the dense loop's answer bit for bit (see lse_fin); rows past
//   the lists' capacity, and the rare row whose dense maximum the list
//   cannot pin down, run the dense loop itself;
// - registers capped (FB_SCAN_MIN_CTAS, FB_DENSE_MIN_CTAS) so that all 2B
//   scan CTAs of the path shapes are resident at once.
// Graphs whose rows do not fit in shared memory (K15 past ~29,000 states,
// K16 past ~19,000) take the device-row tier: each scan CTA's rows (K15 also
// its eps vector) live in a device-memory scratch of its own, read and
// written through L1 between the same barriers (a barrier orders global
// memory within the CTA as it does shared memory); shared memory then holds
// the block-reduction scratch alone, and no ring.  K16's finite-entry lists
// are built before the scan by three grid-wide launches (count, scan, fill;
// one list per matrix and direction, not per CTA), since one CTA reading a
// matrix of ~19,000^2 entries would take minutes.  The lists are the ones
// build_list makes, in the same order, so the LSEs are the same.

#include "common.cuh"

#include <math.h>

#include <algorithm>

#define FB_NEG_INF (-1e30f)
#define FB_HALF_INF (0.5e30f)
#define FB_RED 64  // floats of block-reduction scratch (+ the xmax slots)
#define FB_SCAN_THREADS 224
// register caps: K15 72 a thread (4 CTAs of 224 threads an SM: the
// sausage's 512 scan CTAs in one wave), K16 96 (its 96-thread CTAs, 7 an
// SM at the soft-EM call, are held by shared memory, not registers)
#define FB_SCAN_MIN_CTAS 4
#define FB_DENSE_MIN_CTAS 3
#define FB_COMBINE_THREADS 256
// K15: an eps span wider than this gets a warp, not a thread; one up to
// FB_SPAN_REG wide keeps its terms in registers between its two passes
#define FB_WIDE_SPAN 64
#define FB_SPAN_REG 12
// K16: a list up to this long (transcript graphs: all) takes the
// branch-light path, its terms in registers
#define FB_LIST_REG 2
// K16: a term off a finite-entry list is at most fl(NEG_INF + max x); where
// that lies this far below the list's maximum its exp is exactly 0
#define FB_EXP_ZERO (-256.0f)

namespace {

__device__ __forceinline__ float score_of(float cost) {
  return cost >= FB_HALF_INF ? FB_NEG_INF : -cost;
}

__device__ __forceinline__ float emis_of(float nll) { return -fminf(nll, SRT_POS_INF); }

struct Ent {
  float sc;  // an entry's score
  int idx;   // its column (row list), row (column list) or state (K15 span)
};

// torch.logaddexp (and JAX's, on these inputs)
__device__ __forceinline__ float lae(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// JAX _lse_rows over three rows, summed in row order
__device__ __forceinline__ float lse3(float z0, float z1, float z2) {
  const float m = fmaxf(fmaxf(z0, z1), z2);
  if (!isfinite(m)) return FB_NEG_INF;
  return logf(expf(z0 - m) + expf(z1 - m) + expf(z2 - m)) + m;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the warp's max by one redux on order-preserving integer keys (equal to
// warp_max but for the sign of a zero)
__device__ __forceinline__ float warp_max_redux(float v) {
  const int i = __float_as_int(v);
  const int k = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// block-wide max or sum, the same value in every thread (red: FB_RED floats)
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nw ? red[lane] : (kMax ? -INFINITY : 0.0f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ float end_of(const float* es, int s) { return es ? es[s] : 0.0f; }

// jax.scipy.special.logsumexp of x[s] + e[s] over the block's states
__device__ float block_logsumexp(const float* x, const float* e, int S, float* red) {
  float m = -INFINITY;
  for (int s = threadIdx.x; s < S; s += blockDim.x) m = fmaxf(m, x[s] + end_of(e, s));
  m = block_reduce<true>(m, red);
  const float ms = isfinite(m) ? m : 0.0f;
  float sum = 0.0f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) sum += expf((x[s] + end_of(e, s)) - ms);
  sum = block_reduce<false>(sum, red);
  return logf(fabsf(sum)) + ms;
}

__device__ __forceinline__ int frames_of(const void* nf, int nf64, int b, int T) {
  const long long v = nf64 ? static_cast<const long long*>(nf)[b] : static_cast<const int*>(nf)[b];
  return (int)min(max(v, 0LL), (long long)T);
}

// LSE over a finite span [lo, hi) of the eps block, NEG_INF for an empty
// span (JAX _lse over the block's axis).  z(k) is the k-th term.
// One thread, both passes in registers:
template <class Z>
__device__ __forceinline__ float span_lse_thread(int lo, int hi, Z z) {
  const int n = hi - lo;
  if (n <= FB_SPAN_REG) {  // every term loaded at once, kept for the sum
    float zr[FB_SPAN_REG];
#pragma unroll
    for (int k = 0; k < FB_SPAN_REG; ++k) zr[k] = k < n ? z(lo + k) : -INFINITY;
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < FB_SPAN_REG; ++k) m = fmaxf(m, zr[k]);
    if (n <= 0 || !isfinite(m)) return FB_NEG_INF;
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < FB_SPAN_REG; ++k)
      if (k < n) sum += expf(zr[k] - m);
    return logf(sum) + m;
  }
  float m = -INFINITY;
  for (int k = lo; k < hi; ++k) m = fmaxf(m, z(k));
  if (!isfinite(m)) return FB_NEG_INF;
  float sum = 0.0f;
  for (int k = lo; k < hi; ++k) sum += expf(z(k) - m);
  return logf(sum) + m;
}
// one warp, lanes strided, xor-shuffle max and sum (the wide spans)
template <class Z>
__device__ __forceinline__ float span_lse_warp(int lo, int hi, Z z) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int k = lo + lane; k < hi; k += 32) m = fmaxf(m, z(k));
  m = warp_max(m);
  if (lo >= hi || !isfinite(m)) return FB_NEG_INF;
  float sum = 0.0f;
  for (int k = lo + lane; k < hi; k += 32) sum += expf(z(k) - m);
  return logf(warp_sum(sum)) + m;
}

// The emission rows of an item's frames, staged two frames ahead in a
// 3-slot shared-memory ring by cp.async (each thread copies the states it
// owns, so its own entries are ready after its own wait; the others' after
// the next barrier), or read from device memory where the plan leaves no
// room (ring null).  A step k that works on frame f_k first stages
// f_{k+2}, then waits for all but that group: f_{k+1} is then in; f_k was
// in a step earlier.  Every thread commits a group each step, empty or not.
struct ERing {
  const float* nll;  // [T, S] of the item
  float* ring;       // [3, S] or null
  int S;
  __device__ __forceinline__ const float* row(int t) const {
    return ring ? ring + (t % 3) * S : nll + (size_t)t * S;
  }
  // stage frame t if lo <= t < hi, then commit and wait for all but it
  __device__ __forceinline__ void stage(int t, int lo, int hi) const {
    if (!ring) return;
    if (t >= lo && t < hi) {
      float* d = ring + (t % 3) * S;
      const float* src = nll + (size_t)t * S;
      for (int i = threadIdx.x; i < S; i += blockDim.x) cp_async4(d + i, src + i);
    }
    cp_async_commit();
    cp_async_wait<1>();
  }
};

// The optional clock64 trace of a scan CTA: thread 0's cycles by phase,
// each phase up to the end of the barrier that closes it, added to
// trace[8 * blockIdx.x + phase] (zeroed by the caller); null: off.
struct Trace {
  long long* p;
  long long t;
  __device__ __forceinline__ void start(long long* base) {
    p = base && threadIdx.x == 0 ? base + 8 * (size_t)blockIdx.x : nullptr;
    t = p ? clock64() : 0;
  }
  __device__ __forceinline__ void mark(int i) {
    if (p) {
      const long long n = clock64();
      p[i] += n - t;
      t = n;
    }
  }
};

// ---------------------------------------------------------------- K15 ----

struct BandedArgs {
  const float* nll;             // [B, T, S]
  const float* band;            // [(B,) 3, S] costs, edge s - d -> s
  const float* init;            // [(B,) S] costs
  const float* blk;             // [(B,) R, L] costs
  const int* starts;            // [(B,) R]
  const int* ends;              // [(B,) L]
  const int* start_pos;         // [(B,) S]
  const unsigned char* is_start;  // [(B,) S]
  const int* cross_src;         // [(B,) S] or null
  const float* cross_cost;      // [(B,) S] costs
  const int* inv_off;           // [(B,) S + 1] real cross edges by origin (CSR)
  const int* inv_dst;           // [(B,) S]
  const float* end_scores;      // [(B,) S] or null
  const void* n_frames;         // [B] int32 or int64
  int* aux;                     // [2B, aux_ld] per-CTA scratch: spans, end positions
  float* alpha;                 // [B, T, S]
  float* beta;                  // [B, T, S]
  float* gamma;                 // [B, T, S]
  float* xi;                    // [B, 3, S]
  float* xi_cross;              // [B, S] or null
  float* log_z;                 // [B]
  long long* trace;             // [2B, 8] or null
  float* rows;                  // [2B, rows_ld] (the device-row tier) or null
  int T, S, R, L, aux_ld, rows_ld;
  int graph_per_item, end_per_item, eps_depth, nf64, ering;
};

// per-CTA scratch: forward lo, hi, wide list, count, owned state [R] each;
// backward the same over L, then end_pos [S]
int banded_aux_ints(int S, int R, int L) { return std::max(4 * R + 1, 4 * L + 1 + S); }

// the shared layout: the block scratch, the eps vector [max(R, L)], two
// rows; staged (the plan's ring flag): the emission ring [3S], the band's
// scores [3S] and the narrow spans' terms [max(R, L), FB_SPAN_REG] (Ent).
// The device-row tier (rows_smem 0): the block scratch alone; the eps
// vector and the rows, banded_rows_floats of them, in device memory.
__host__ __device__ __forceinline__ size_t banded_se_offset(int S, int R, int L) {
  return (FB_RED + (size_t)(R > L ? R : L) + 8 * (size_t)S + 1) & ~(size_t)1;
}
size_t banded_rows_floats(int S, int R, int L) { return (size_t)std::max(R, L) + 2 * (size_t)S; }
size_t banded_smem_floats(int S, int R, int L, int ering, int rows_smem) {
  if (!rows_smem) return FB_RED;
  const size_t m = std::max(R, L);
  return ering ? banded_se_offset(S, R, L) + 2 * FB_SPAN_REG * m : FB_RED + banded_rows_floats(S, R, L);
}

// the spans of the eps block's finite entries, [lo, hi) (0, 0 where none),
// and the list of the wide ones: rows (forward, a warp a row, ballots over
// 32-column chunks) or columns (backward, a thread a column)
__device__ void banded_spans(const float* blk, int R, int L, bool cols, int* lo, int* hi,
                             int* wide, int* n_wide) {
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nw = nth >> 5;
  if (!cols) {
    for (int r = warp; r < R; r += nw) {
      int l0 = -1, l1 = 0;
      for (int c = 0; c < L; c += 32) {
        const int l = c + lane;
        const unsigned m = __ballot_sync(0xffffffffu, l < L && blk[(size_t)r * L + l] < FB_HALF_INF);
        if (m) {
          if (l0 < 0) l0 = c + __ffs(m) - 1;
          l1 = c + 32 - __clz(m);
        }
      }
      if (lane == 0) {
        lo[r] = l0 < 0 ? 0 : l0;
        hi[r] = l0 < 0 ? 0 : l1;
      }
    }
  } else {
    for (int l = tid; l < L; l += nth) {
      int r0 = -1, r1 = 0;
      for (int r = 0; r < R; ++r)
        if (blk[(size_t)r * L + l] < FB_HALF_INF) {
          if (r0 < 0) r0 = r;
          r1 = r + 1;
        }
      lo[l] = r0 < 0 ? 0 : r0;
      hi[l] = r0 < 0 ? 0 : r1;
    }
  }
  __syncthreads();
  const int n = cols ? L : R;
  if (warp == 0) {
    int cnt = 0;
    for (int c = 0; c < n; c += 32) {
      const int i = c + lane;
      const bool w = i < n && hi[i] - lo[i] > FB_WIDE_SPAN;
      const unsigned m = __ballot_sync(0xffffffffu, w);
      if (w) wide[cnt + __popc(m & ((1u << lane) - 1))] = i;
      cnt += __popc(m);
    }
    if (lane == 0) *n_wide = cnt;
  }
}

// end_pos[s]: the last l with ends[l] == s, else -1 (one warp, chunks of
// 32 in ascending order; within a chunk the highest lane of a value writes)
__device__ void banded_end_pos(const int* ends, int L, int S, int* end_pos) {
  for (int s = threadIdx.x; s < S; s += blockDim.x) end_pos[s] = -1;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) == 0) {
    for (int c = 0; c < L; c += 32) {
      const int l = c + lane;
      const unsigned act = __ballot_sync(0xffffffffu, l < L);
      if (l < L) {
        const int s = ends[l];
        const unsigned peers = __match_any_sync(act, s);
        if (31 - __clz(peers) == lane) end_pos[s] = l;
      }
      __syncwarp();
    }
  }
}

// the scan: CTA 2b runs item b's forward, CTA 2b + 1 its backward
__global__ void __launch_bounds__(FB_SCAN_THREADS, FB_SCAN_MIN_CTAS)
fb_banded_scan_kernel(BandedArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x >> 1;
  const bool bwd = blockIdx.x & 1;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  const int T = a.T, S = a.S, R = a.R, L = a.L;
  const size_t g = a.graph_per_item ? b : 0;
  const float* band = a.band + g * 3 * S;
  const float* blk = a.blk + g * R * L;
  const int* starts = a.starts + g * R;
  const int* ends = a.ends + g * L;
  const bool cross = a.cross_src != nullptr;
  const int* csrc = cross ? a.cross_src + g * S : nullptr;
  const float* ccost = cross ? a.cross_cost + g * S : nullptr;
  const float* ends_sc = a.end_scores ? a.end_scores + (a.end_per_item ? (size_t)b * S : 0)
                                      : nullptr;
  const float* nll = a.nll + (size_t)b * T * S;
  const int nf = frames_of(a.n_frames, a.nf64, b, T);
  int* aux = a.aux + (size_t)blockIdx.x * a.aux_ld;

  float* red = smem;
  // [max(R, L)]: start-row candidates / end-column pullbacks, then the rows
  float* v = a.rows ? a.rows + (size_t)blockIdx.x * a.rows_ld : red + FB_RED;
  float* row0 = v + max(R, L);
  float* row1 = row0 + S;
  const ERing er{nll, a.ering ? row1 + S : nullptr, S};
  Trace tr;
  tr.start(a.trace);
  // the band's scores, converted once into shared memory with the ring
  // (read by the band step at s, s + 1 and s + 2: visible after setup's
  // barriers), else converted at each read
  float* bs = a.ering ? row1 + 4 * S : nullptr;
  if (bs)
    for (int i = tid; i < 3 * S; i += nth) bs[i] = score_of(band[i]);
  auto bsc = [&](int i) { return bs ? bs[i] : score_of(band[i]); };
  // staged: each narrow span's terms (score, state), filled at setup
  Ent* se = a.ering ? reinterpret_cast<Ent*>(smem + banded_se_offset(S, R, L)) : nullptr;

  if (!bwd) {
    // ---- forward ----
    const float* init = a.init + g * S;
    const int* start_pos = a.start_pos + g * S;
    const unsigned char* is_start = a.is_start + g * S;
    int *rlo = aux, *rhi = aux + R, *wide = aux + 2 * R, *n_wide_p = aux + 3 * R;
    int* rown = aux + 3 * R + 1;  // the start state row r applies to, else -1
    banded_spans(blk, R, L, false, rlo, rhi, wide, n_wide_p);
    for (int r = tid; r < R; r += nth) {
      const int st = starts[r], lo = rlo[r], n = rhi[r] - lo;
      rown[r] = is_start[st] && start_pos[st] == r ? st : -1;
      if (se && n <= FB_SPAN_REG)
        for (int k = 0; k < n; ++k)
          se[r * FB_SPAN_REG + k] = Ent{score_of(blk[(size_t)r * L + lo + k]), ends[lo + k]};
    }
    float* alpha = a.alpha + (size_t)b * T * S;
    float* cur = row0;
    float* prv = row1;
    const int F = max(nf, 1);
    er.stage(0, 0, F);
    er.stage(1, 0, F);
    er.stage(2, 0, F);
    const float* e0 = er.row(0);
    for (int s = tid; s < S; s += nth) cur[s] = score_of(init[s]) + emis_of(e0[s]);
    __syncthreads();
    tr.mark(0);
    const int n_wide = *n_wide_p;
    // eps passes on row x at frame t; the last writes the alpha row
    auto eps_fwd = [&](float* x, const float* e, float* arow) {
      for (int pass = 0; pass < a.eps_depth; ++pass) {
        for (int r = tid; r < R; r += nth) {
          const int lo = rlo[r], hi = rhi[r];
          if (hi - lo > FB_WIDE_SPAN) continue;
          const float* br = blk + (size_t)r * L;
          const Ent* sr = se + r * FB_SPAN_REG - lo;
          const float base =
              se && hi - lo <= FB_SPAN_REG
                  ? span_lse_thread(lo, hi, [&](int l) { return sr[l].sc + x[sr[l].idx]; })
                  : span_lse_thread(lo, hi, [&](int l) { return score_of(br[l]) + x[ends[l]]; });
          v[r] = base + emis_of(e[starts[r]]);
        }
        for (int i = warp; i < n_wide; i += nw) {
          const int r = wide[i];
          const float* br = blk + (size_t)r * L;
          const float base =
              span_lse_warp(rlo[r], rhi[r], [&](int l) { return score_of(br[l]) + x[ends[l]]; });
          if (lane == 0) v[r] = base + emis_of(e[starts[r]]);
        }
        __syncthreads();
        tr.mark(2);
        const bool last = pass + 1 == a.eps_depth;
        // a start state takes its row's candidate, by that row's thread;
        // any other, lae(x, NEG_INF), which is exactly fmaxf(x, NEG_INF)
        for (int r = tid; r < R; r += nth) {
          const int st = rown[r];
          if (st < 0) continue;
          const float y = lae(x[st], v[r]);
          x[st] = y;
          if (last) arow[st] = y;
        }
        for (int s = tid; s < S; s += nth) {
          float y;
          if (!is_start[s])
            y = fmaxf(x[s], FB_NEG_INF) + 0.0f;
          else if (starts[start_pos[s]] != s)  // a slot of another state
            y = lae(x[s], v[start_pos[s]]);
          else
            continue;
          x[s] = y;
          if (last) arow[s] = y;
        }
        __syncthreads();
        tr.mark(3);
      }
    };
    eps_fwd(cur, e0, alpha);
    for (int t = 1; t < nf; ++t) {
      float* tmp = cur;
      cur = prv;
      prv = tmp;
      er.stage(t + 2, 0, F);
      const float* e = er.row(t);
#pragma unroll 2
      for (int s = tid; s < S; s += nth) {
        const float z0 = bsc(s) + prv[s];
        const float z1 = bsc(S + s) + (s >= 1 ? prv[s - 1] : FB_NEG_INF);
        const float z2 = bsc(2 * S + s) + (s >= 2 ? prv[s - 2] : FB_NEG_INF);
        float base = lse3(z0, z1, z2);
        if (cross) base = lae(base, prv[csrc[s]] + score_of(ccost[s]));
        cur[s] = base + emis_of(e[s]);
      }
      __syncthreads();
      tr.mark(1);
      eps_fwd(cur, e, alpha + (size_t)t * S);
    }
    const float logz = block_logsumexp(cur, ends_sc, S, red);
    if (tid == 0) a.log_z[b] = logz;
    tr.mark(4);
    return;
  }

  // ---- backward: W = beta[t] through its eps passes (+ emis after the
  // last), N = beta[t - 1] ----
  const int* ioff = cross ? a.inv_off + g * (S + 1) : nullptr;
  const int* idst = cross ? a.inv_dst + g * S : nullptr;
  int *clo = aux, *chi = aux + L, *wide = aux + 2 * L, *n_wide_p = aux + 3 * L;
  int* cown = aux + 3 * L + 1;  // the end state column l applies to, else -1
  int* end_pos = aux + 4 * L + 1;
  banded_spans(blk, R, L, true, clo, chi, wide, n_wide_p);
  banded_end_pos(ends, L, S, end_pos);
  __syncthreads();
  for (int l = tid; l < L; l += nth) {
    const int st = ends[l], lo = clo[l], n = chi[l] - lo;
    cown[l] = end_pos[st] == l ? st : -1;
    if (se && n <= FB_SPAN_REG)
      for (int k = 0; k < n; ++k)
        se[l * FB_SPAN_REG + k] = Ent{score_of(blk[(size_t)(lo + k) * L + l]), starts[lo + k]};
  }
  float* beta = a.beta + (size_t)b * T * S;
  float* W = row0;
  float* N = row1;
  const int tl = max(nf, 1) - 1;
  er.stage(tl, 1, tl + 1);
  er.stage(tl - 1, 1, tl + 1);
  for (int s = tid; s < S; s += nth) {
    const float y = end_of(ends_sc, s);
    W[s] = y;
    beta[(size_t)tl * S + s] = y;
  }
  __syncthreads();
  tr.mark(0);
  const int n_wide = *n_wide_p;
  for (int t = tl; t >= 1; --t) {
    er.stage(t - 2, 1, tl + 1);
    const float* e = er.row(t);
    for (int pass = 0; pass < a.eps_depth; ++pass) {
      auto zc = [&](const float* bc, int r) {
        const int st = starts[r];
        return score_of(bc[(size_t)r * L]) + (W[st] + emis_of(e[st]));
      };
      for (int l = tid; l < L; l += nth) {
        const int lo = clo[l], hi = chi[l];
        if (hi - lo > FB_WIDE_SPAN) continue;
        const Ent* sc = se + l * FB_SPAN_REG - lo;
        v[l] = se && hi - lo <= FB_SPAN_REG
                   ? span_lse_thread(lo, hi, [&](int r) {
                       const int st = sc[r].idx;
                       return sc[r].sc + (W[st] + emis_of(e[st]));
                     })
                   : span_lse_thread(lo, hi, [&](int r) { return zc(blk + l, r); });
      }
      for (int i = warp; i < n_wide; i += nw) {
        const int l = wide[i];
        const float c = span_lse_warp(clo[l], chi[l], [&](int r) { return zc(blk + l, r); });
        if (lane == 0) v[l] = c;
      }
      __syncthreads();
      tr.mark(2);
      const bool last = pass + 1 == a.eps_depth;
      // an end state takes its column's pullback, by that column's thread;
      // any other, lae(W, NEG_INF), which is exactly fmaxf(W, NEG_INF)
      for (int l = tid; l < L; l += nth) {
        const int st = cown[l];
        if (st < 0) continue;
        float w = lae(W[st], v[l]);
        if (last) w = w + emis_of(e[st]);
        W[st] = w;
      }
      for (int s = tid; s < S; s += nth) {
        if (end_pos[s] >= 0) continue;
        float w = fmaxf(W[s], FB_NEG_INF) + 0.0f;
        if (last) w = w + emis_of(e[s]);
        W[s] = w;
      }
      __syncthreads();
      tr.mark(3);
    }
    float* brow = beta + (size_t)(t - 1) * S;
#pragma unroll 2
    for (int u = tid; u < S; u += nth) {
      const float z0 = bsc(u) + W[u];
      const float z1 = u + 1 < S ? bsc(S + u + 1) + W[u + 1] : FB_NEG_INF;
      const float z2 = u + 2 < S ? bsc(2 * S + u + 2) + W[u + 2] : FB_NEG_INF;
      float nb = lse3(z0, z1, z2);
      if (cross) {
        const int i0 = ioff[u], i1 = ioff[u + 1];
        float m = -INFINITY;
        for (int k = i0; k < i1; ++k) {
          const int i = idst[k];
          m = fmaxf(m, score_of(ccost[i]) + W[i]);
        }
        const float ms = isfinite(m) ? m : 0.0f;
        float tot = 0.0f;
        for (int k = i0; k < i1; ++k) {
          const int i = idst[k];
          const float z = score_of(ccost[i]) + W[i];
          tot += isfinite(z) ? expf(z - ms) : 0.0f;
        }
        nb = lae(nb, tot > 0.0f ? logf(tot) + ms : FB_NEG_INF);
      }
      N[u] = nb;
      brow[u] = nb;
    }
    __syncthreads();
    tr.mark(1);
    float* tmp = W;
    W = N;
    N = tmp;
  }
}

// ---------------------------------------------------------------- K16 ----

struct DenseArgs {
  const float* nll;         // [B, T, S]
  const float* trans;       // [(B,) S, S] costs, [to, from]
  const float* eps;         // [(B,) S, S] costs or null
  const float* init;        // [(B,) S] costs
  const float* end_scores;  // [(B,) S] or null
  const void* n_frames;     // [B] int32 or int64
  int* lists;               // [2B, n_lists * list_ints] (lists in device memory) or null
  float* alpha;             // [B, T, S]
  float* beta;              // [B, T, S]
  float* gamma;             // [B, T, S]
  float* xi;                // [B, 3, S] (band) or [B, S, S] (dense)
  float* log_z;             // [B]
  long long* trace;         // [2B, 8] or null
  float* rows;              // [2B, 3S] (the device-row tier: lists prebuilt) or null
  int T, S, cap;
  int mats_per_item, init_per_item, end_per_item, eps_depth, xi_dense, nf64, lists_smem, ering;
};

// a finite-entry list: offsets [S + 1] (an even count of ints), then up to
// cap entries; row i's entries are ent[off[i], off[i + 1]) where off[i + 1]
// <= cap, else it is past the capacity (the dense loop)
__host__ __device__ __forceinline__ size_t list_off_ints(int S) { return ((size_t)S + 2) & ~(size_t)1; }
__host__ __device__ __forceinline__ size_t list_ints(int S, int cap) {
  return list_off_ints(S) + 2 * (size_t)cap;
}

// the rows (and the emission ring), an even count of floats, then the lists
__host__ __device__ __forceinline__ size_t dense_rows_floats(int S, int ering) {
  return (FB_RED + (3 + (ering ? 3 : 0)) * (size_t)S + 1) & ~(size_t)1;
}

// the device-row tier (rows_smem 0): the block scratch alone
size_t dense_smem_floats(int S, int use_eps, int cap, int lists_smem, int ering, int rows_smem) {
  if (!rows_smem) return FB_RED;
  const size_t rows = dense_rows_floats(S, ering);
  return rows + (lists_smem ? (1 + (use_eps ? 1 : 0)) * list_ints(S, cap) : 0);
}

// build the list of M's finite entries by row (cols false: a warp a row,
// ballots over 32-column chunks keep the order) or by column (a thread a
// column, rows ascending); ends with a barrier
__device__ void build_list(const float* M, int S, bool cols, int cap, int* reg) {
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nw = nth >> 5;
  int* off = reg;
  Ent* ent = reinterpret_cast<Ent*>(reg + list_off_ints(S));
  // a warp takes four rows at a time, their loads in flight together
  auto row_chunk = [&](int v0, int u, float* x) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = v0 + j < S && u < S ? __ldg(M + (size_t)(v0 + j) * S + u) : SRT_POS_INF;
  };
  if (!cols) {
    for (int v0 = 4 * warp; v0 < S; v0 += 4 * nw) {
      int c[4] = {0, 0, 0, 0};
      for (int u0 = 0; u0 < S; u0 += 32) {
        float x[4];
        row_chunk(v0, u0 + lane, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] += __popc(__ballot_sync(0xffffffffu, x[j] < FB_HALF_INF));
      }
      if (lane == 0)
        for (int j = 0; j < 4 && v0 + j < S; ++j) off[v0 + j + 1] = c[j];
    }
  } else {
    for (int u = tid; u < S; u += nth) {
      int c = 0;
#pragma unroll 8
      for (int v = 0; v < S; ++v) c += __ldg(M + (size_t)v * S + u) < FB_HALF_INF;
      off[u + 1] = c;
    }
  }
  if (tid == 0) off[0] = 0;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of off[1..S], one warp, chunks of 32
    int carry = 0;
    for (int i0 = 1; i0 <= S; i0 += 32) {
      const int i = i0 + lane;
      int x = i <= S ? off[i] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      x += carry;
      if (i <= S) off[i] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  if (!cols) {
    for (int v0 = 4 * warp; v0 < S; v0 += 4 * nw) {
      int base[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) base[j] = v0 + j < S && off[v0 + j + 1] <= cap ? off[v0 + j] : -1;
      for (int u0 = 0; u0 < S; u0 += 32) {
        const int u = u0 + lane;
        float x[4];
        row_chunk(v0, u, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool fin = x[j] < FB_HALF_INF;
          const unsigned m = __ballot_sync(0xffffffffu, fin);
          if (base[j] >= 0) {
            if (fin) ent[base[j] + __popc(m & ((1u << lane) - 1))] = Ent{score_of(x[j]), u};
            base[j] += __popc(m);
          }
        }
      }
    }
  } else {
    for (int u = tid; u < S; u += nth) {
      if (off[u + 1] > cap) continue;
      int p = off[u];
#pragma unroll 4
      for (int v = 0; v < S; ++v) {
        const float c = __ldg(M + (size_t)v * S + u);
        if (c < FB_HALF_INF) ent[p++] = Ent{score_of(c), v};
      }
    }
  }
  __syncthreads();
}

// LSE over j of score(M(i, j)) + x[j] (rows) or score(M(j, i)) + x[j]
// (columns), the dense loop's answer bit for bit: its terms are those of
// the list plus, for every other j, fl(NEG_INF + x[j]) <= zall =
// fl(NEG_INF + max x) (rounding is monotone).  With mf the list's maximum:
//  - where fl(zall - mf) < FB_EXP_ZERO, the dense maximum is mf and every
//    other term's exp is exactly 0.0f; adding 0.0f in the same ascending
//    order changes no bit, so the list's sum is the dense sum;
//  - else, where the dense maximum mx is known (an empty list: zall; mf
//    >= zall: mf), a non-finite mx gives NEG_INF, and mx <= -HALF_INF
//    gives mx itself (log of a sum in [1, S] is far below half an ulp of
//    |mx| >= 5e29);
//  - else (or past the capacity) the dense loop runs, costs through L1.
__device__ float lse_fin(const int* reg, int cap, const float* M, int S, bool cols, int i,
                         const float* x, float zall) {
  const int* off = reg;
  const Ent* ent = reinterpret_cast<const Ent*>(reg + list_off_ints(S));
  const int lo = off[i], hi = off[i + 1];
  if (hi <= cap && hi - lo <= FB_LIST_REG) {
    // every lane computes the sum and the log whatever its list's length
    // (the same values, without the branches that split a warp)
    const int n = hi - lo;
    const Ent e0 = ent[n > 0 ? lo : 0], e1 = ent[n > 1 ? lo + 1 : 0];
    const float z0 = n > 0 ? e0.sc + x[e0.idx] : -INFINITY;
    const float z1 = n > 1 ? e1.sc + x[e1.idx] : -INFINITY;
    const float mf = fmaxf(z0, z1);
    const float ms = isfinite(mf) ? mf : 0.0f;
    const float sum = (n > 0 ? expf(z0 - ms) : 0.0f) + (n > 1 ? expf(z1 - ms) : 0.0f);
    const float lf = logf(sum) + ms;
    if (isfinite(mf) && zall - mf < FB_EXP_ZERO) return lf;
    const float mx = n == 0 ? zall : mf;
    if ((n == 0 || mf >= zall) && !(isfinite(mx) && mx > -FB_HALF_INF))
      return isfinite(mx) ? mx : FB_NEG_INF;
  } else if (hi <= cap) {
    float mf = -INFINITY;
    for (int k = lo; k < hi; ++k) {
      const Ent e = ent[k];
      mf = fmaxf(mf, e.sc + x[e.idx]);
    }
    if (isfinite(mf) && zall - mf < FB_EXP_ZERO) {
      float sum = 0.0f;
      for (int k = lo; k < hi; ++k) {
        const Ent e = ent[k];
        sum += expf((e.sc + x[e.idx]) - mf);
      }
      return logf(sum) + mf;
    }
    if (lo == hi || mf >= zall) {
      const float mx = lo == hi ? zall : mf;
      if (!isfinite(mx)) return FB_NEG_INF;
      if (mx <= -FB_HALF_INF) return mx;
    }
  }
  float mx = -INFINITY;
  for (int j = 0; j < S; ++j)
    mx = fmaxf(mx, score_of(cols ? M[(size_t)j * S + i] : M[(size_t)i * S + j]) + x[j]);
  if (!isfinite(mx)) return FB_NEG_INF;
  float sum = 0.0f;
  for (int j = 0; j < S; ++j)
    sum += expf((score_of(cols ? M[(size_t)j * S + i] : M[(size_t)i * S + j]) + x[j]) - mx);
  return logf(sum) + mx;
}

__global__ void __launch_bounds__(FB_SCAN_THREADS, FB_DENSE_MIN_CTAS)
fb_dense_scan_kernel(DenseArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x >> 1;
  const bool bwd = blockIdx.x & 1;
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nth >> 5;
  const int T = a.T, S = a.S;
  const bool use_eps = a.eps != nullptr;
  const size_t g = a.mats_per_item ? b : 0;
  const float* mt = a.trans + g * S * S;
  const float* me = use_eps ? a.eps + g * S * S : nullptr;
  const float* ends_sc = a.end_scores ? a.end_scores + (a.end_per_item ? (size_t)b * S : 0)
                                      : nullptr;
  const float* nll = a.nll + (size_t)b * T * S;
  const int nf = frames_of(a.n_frames, a.nf64, b, T);

  float* red = smem;            // block_reduce: [0, 33)
  float* wmax = smem + 40;      // the xmax slots: two parities of 8 warps
  float* r0 = a.rows ? a.rows + (size_t)blockIdx.x * 3 * S : smem + FB_RED;
  float* r1 = r0 + S;
  float* r2 = r1 + S;
  const ERing er{nll, a.ering ? r2 + S : nullptr, S};
  const size_t li = list_ints(S, a.cap);
  const int n_kinds = use_eps ? 2 : 1;
  // the device-row tier reads the prebuilt lists of its matrix and
  // direction (fb_list_pass_kernel); else each CTA builds its own
  int* lt = a.lists_smem ? reinterpret_cast<int*>(smem + dense_rows_floats(S, a.ering))
            : a.rows     ? a.lists + (g * 2 + bwd) * n_kinds * li
                         : a.lists + (size_t)blockIdx.x * n_kinds * li;
  int* le = lt + li;
  Trace tr;
  tr.start(a.trace);
  if (!a.rows) {
    build_list(mt, S, bwd, a.cap, lt);
    if (use_eps) build_list(me, S, bwd, a.cap, le);
  }

  // each step publishes the warp maxima of the vector it writes; the next
  // step reads them (zall = fl(NEG_INF + max x)) after the barrier
  int par = 0;
  auto publish = [&](float m) {
    m = warp_max_redux(m);
    if (lane == 0) wmax[par * 8 + warp] = m;
  };
  auto zall = [&]() {
    float m = -INFINITY;
    for (int i = 0; i < nw; ++i) m = fmaxf(m, wmax[par * 8 + i]);
    par ^= 1;
    return FB_NEG_INF + m;
  };

  if (!bwd) {
    // ---- forward: two rows, each step reads one and writes the other ----
    float* alpha = a.alpha + (size_t)b * T * S;
    const float* init = a.init + (a.init_per_item ? (size_t)b * S : 0);
    float* cur = r0;
    float* nxt = r1;
    const int F = max(nf, 1);
    er.stage(0, 0, F);
    er.stage(1, 0, F);
    er.stage(2, 0, F);
    const float* e0 = er.row(0);
    float lm = -INFINITY;
    for (int v = tid; v < S; v += nth) {
      const float y = score_of(init[v]) + emis_of(e0[v]);
      cur[v] = y;
      lm = fmaxf(lm, y);
      if (!use_eps) alpha[v] = y;
    }
    publish(lm);
    __syncthreads();
    tr.mark(0);
    auto eps_fwd = [&](const float* e, float* arow) {
      if (!use_eps) return;
      for (int pass = 0; pass < a.eps_depth; ++pass) {
        const float z = zall();
        const bool last = pass + 1 == a.eps_depth;
        float m = -INFINITY;
        for (int v = tid; v < S; v += nth) {
          const float y = lae(cur[v], lse_fin(le, a.cap, me, S, false, v, cur, z) + emis_of(e[v]));
          nxt[v] = y;
          m = fmaxf(m, y);
          if (last) arow[v] = y;
        }
        publish(m);
        __syncthreads();
        tr.mark(2);
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    };
    eps_fwd(e0, alpha);
    for (int t = 1; t < nf; ++t) {
      er.stage(t + 2, 0, F);
      const float* e = er.row(t);
      float* arow = alpha + (size_t)t * S;
      const float z = zall();
      float m = -INFINITY;
      for (int v = tid; v < S; v += nth) {
        const float y = lse_fin(lt, a.cap, mt, S, false, v, cur, z) + emis_of(e[v]);
        nxt[v] = y;
        m = fmaxf(m, y);
        if (!use_eps) arow[v] = y;
      }
      publish(m);
      __syncthreads();
      tr.mark(1);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      eps_fwd(e, arow);
    }
    const float logz = block_logsumexp(cur, ends_sc, S, red);
    if (tid == 0) a.log_z[b] = logz;
    tr.mark(4);
    return;
  }

  // ---- backward: W = beta[t] through its eps passes (each thread owns its
  // states), Y / Y2 = W + emis, the vector every column LSE reads ----
  float* beta = a.beta + (size_t)b * T * S;
  float* W = r0;
  float* Y = r1;
  float* Y2 = r2;
  const int tl = max(nf, 1) - 1;
  er.stage(tl, 1, tl + 1);
  er.stage(tl - 1, 1, tl + 1);
  float lm = -INFINITY;
  const float* etl = er.row(tl);
  for (int s = tid; s < S; s += nth) {
    const float w = end_of(ends_sc, s);
    W[s] = w;
    beta[(size_t)tl * S + s] = w;
    if (tl >= 1) {
      const float y = w + emis_of(etl[s]);
      Y[s] = y;
      lm = fmaxf(lm, y);
    }
  }
  publish(lm);
  __syncthreads();
  tr.mark(0);
  for (int t = tl; t >= 1; --t) {
    er.stage(t - 2, 1, tl + 1);
    const float* e = er.row(t);
    if (use_eps) {
      for (int pass = 0; pass < a.eps_depth; ++pass) {
        const float z = zall();
        float m = -INFINITY;
        for (int u = tid; u < S; u += nth) {
          const float w = lae(W[u], lse_fin(le, a.cap, me, S, true, u, Y, z));
          W[u] = w;
          const float y = w + emis_of(e[u]);
          Y2[u] = y;
          m = fmaxf(m, y);
        }
        publish(m);
        __syncthreads();
        tr.mark(2);
        float* tmp = Y;
        Y = Y2;
        Y2 = tmp;
      }
    }
    const float z = zall();
    const float* ep = er.row(t - 1);  // ready: staged two steps back
    float* brow = beta + (size_t)(t - 1) * S;
    float m = -INFINITY;
    for (int u = tid; u < S; u += nth) {
      const float w = lse_fin(lt, a.cap, mt, S, true, u, Y, z);
      W[u] = w;
      brow[u] = w;
      if (t >= 2) {
        const float y = w + emis_of(ep[u]);
        Y2[u] = y;
        m = fmaxf(m, y);
      }
    }
    publish(m);
    __syncthreads();
    tr.mark(1);
    float* tmp = Y;
    Y = Y2;
    Y2 = tmp;
  }
}

// ------------------------------------------- K16's prebuilt lists ----
// The device-row tier's lists: list id = (g * 2 + dir) * n_kinds + kind for
// matrix g (each item's, or the one shared), direction dir (0: rows, the
// forward's; 1: columns, the backward's) and kind (0: trans, 1: eps), each
// list_ints(S, cap) ints, the layout and order of build_list.

struct ListArgs {
  const float* trans;  // [(B,) S, S]
  const float* eps;    // [(B,) S, S] or null
  int* lists;          // [n_lists, list_ints]
  int S, cap, n_kinds;
};

__device__ __forceinline__ const float* list_matrix(const ListArgs& a, int id, int* dir,
                                                    int** reg) {
  const int kind = id % a.n_kinds, d = (id / a.n_kinds) & 1, g = id / (2 * a.n_kinds);
  *dir = d;
  *reg = a.lists + (size_t)id * list_ints(a.S, a.cap);
  return (kind ? a.eps : a.trans) + (size_t)g * a.S * a.S;
}

// kFill false: the count of each row's (column's) finite entries into
// off[i + 1]; true: the entries of each row (column) within the capacity,
// at off[i] after the scan.  Rows: a warp a row, ballots over 32-column
// chunks; columns: a thread a column, rows ascending.  blockIdx.y: list.
template <bool kFill>
__global__ void __launch_bounds__(256) fb_list_pass_kernel(ListArgs a) {
  int dir, *reg;
  const float* M = list_matrix(a, blockIdx.y, &dir, &reg);
  const int S = a.S, lane = threadIdx.x & 31;
  int* off = reg;
  Ent* ent = reinterpret_cast<Ent*>(reg + list_off_ints(S));
  if (!dir) {
    const int nw = gridDim.x * (blockDim.x >> 5);
    for (int v = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); v < S; v += nw) {
      const float* row = M + (size_t)v * S;
      int c = kFill ? (off[v + 1] <= a.cap ? off[v] : -1) : 0;
      if (kFill && c < 0) continue;
      for (int u0 = 0; u0 < S; u0 += 32) {
        const int u = u0 + lane;
        const float x = u < S ? __ldg(row + u) : SRT_POS_INF;
        const bool fin = x < FB_HALF_INF;
        const unsigned m = __ballot_sync(0xffffffffu, fin);
        if (kFill && fin) ent[c + __popc(m & ((1u << lane) - 1))] = Ent{score_of(x), u};
        c += __popc(m);
      }
      if (!kFill && lane == 0) off[v + 1] = c;
    }
  } else {
    for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < S; u += gridDim.x * blockDim.x) {
      if (kFill) {
        if (off[u + 1] > a.cap) continue;
        int p = off[u];
#pragma unroll 8
        for (int v = 0; v < S; ++v) {
          const float c = __ldg(M + (size_t)v * S + u);
          if (c < FB_HALF_INF) ent[p++] = Ent{score_of(c), v};
        }
      } else {
        int c = 0;
#pragma unroll 8
        for (int v = 0; v < S; ++v) c += __ldg(M + (size_t)v * S + u) < FB_HALF_INF;
        off[u + 1] = c;
      }
    }
  }
  if (!kFill && blockIdx.x == 0 && threadIdx.x == 0) off[0] = 0;
}

// the inclusive scan of off[1..S] of list blockIdx.x, one CTA of 1,024
// threads over chunks of 1,024 entries
__global__ void __launch_bounds__(1024) fb_list_scan_kernel(ListArgs a) {
  __shared__ int wsum[32];
  __shared__ int carry;
  int* off = a.lists + (size_t)blockIdx.x * list_ints(a.S, a.cap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int i0 = 1; i0 <= a.S; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    int x = i <= a.S ? off[i] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < (int)(blockDim.x >> 5) ? wsum[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      wsum[lane] = w;  // inclusive warp totals
    }
    __syncthreads();
    const int base = carry + (warp ? wsum[warp - 1] : 0);
    if (i <= a.S) off[i] = x + base;
    __syncthreads();
    if (threadIdx.x == 0) carry += wsum[(blockDim.x >> 5) - 1];
    __syncthreads();
  }
}

int build_lists(const ListArgs& l, int n_lists, cudaStream_t stream) {
  const dim3 grid((unsigned)std::min((l.S + 255) / 256, 1024), (unsigned)n_lists);
  fb_list_pass_kernel<false><<<grid, 256, 0, stream>>>(l);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  fb_list_scan_kernel<<<n_lists, 1024, 0, stream>>>(l);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  fb_list_pass_kernel<true><<<grid, 256, 0, stream>>>(l);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ combine ----

struct CombineArgs {
  const float* nll;        // [B, T, S]
  const float* alpha;      // [B, T, S]
  const float* beta;       // [B, T, S]
  const float* log_z;      // [B]
  const void* n_frames;    // [B]
  const float* band;       // K15: [(B,) 3, S] costs by destination, else null
  const float* trans;      // K16: [(B,) S, S] costs, [to, from], else null
  const int* cross_src;    // K15: [(B,) S] or null
  const float* cross_cost;
  float* gamma;            // [B, T, S]
  float* xi;               // [B, 3, S] or [B, S, S]
  float* xi_cross;         // [B, S] or null
  int T, S, graph_per_item, xi_dense, nf64;
};

// one thread a slot of item blockIdx.y: slot u < S owns gamma[:, u] and
// (band xi) xi[:, u] and xi_cross[u]; slot S + v * S + u (dense xi) owns
// xi[v, u].  Frames in ascending order.
__global__ void __launch_bounds__(FB_COMBINE_THREADS) fb_combine_kernel(CombineArgs a) {
  const int b = blockIdx.y;
  const int S = a.S, T = a.T;
  const long long slot = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_slots = S + (a.xi_dense ? (long long)S * S : 0);
  if (slot >= n_slots) return;
  const int nf = frames_of(a.n_frames, a.nf64, b, T);
  const float logz = a.log_z[b];
  const size_t g = a.graph_per_item ? b : 0;
  const size_t base = (size_t)b * T * S;
  const float* al = a.alpha + base;
  const float* be = a.beta + base;
  const float* nll = a.nll + base;
  if (slot >= S) {  // dense xi[v, u]
    const int v = (int)((slot - S) / S), u = (int)((slot - S) % S);
    const float lb = score_of(a.trans[g * S * S + (size_t)v * S + u]);
    float acc = 0.0f;
#pragma unroll 8
    for (int t = 1; t < nf; ++t) {
      const size_t r = (size_t)t * S;
      const float eb = emis_of(__ldg(nll + r + v)) + __ldg(be + r + v);
      acc += expf(fminf(((__ldg(al + r - S + u) + lb) + eb) - logz, 50.0f));
    }
    a.xi[(size_t)b * S * S + (size_t)v * S + u] = acc;
    return;
  }
  const int u = (int)slot;
  float* gam = a.gamma + base;
  const bool band_xi = !a.xi_dense;
  float lb[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int v = u + d;
    lb[d] = v >= S ? FB_NEG_INF
                   : score_of(a.band ? a.band[g * 3 * S + (size_t)d * S + v]
                                     : a.trans[g * S * S + (size_t)v * S + u]);
  }
  const bool cross = a.cross_src != nullptr;
  const int cs = cross ? a.cross_src[g * S + u] : 0;
  const float lc = cross ? score_of(a.cross_cost[g * S + u]) : 0.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, accx = 0.0f;
  float ap = 0.0f;
#pragma unroll 8
  for (int t = 0; t < nf; ++t) {
    const size_t r = (size_t)t * S;
    const float at = __ldg(al + r + u), bt = __ldg(be + r + u);
    gam[r + u] = expf(fminf((at + bt) - logz, 50.0f));
    if (band_xi && t >= 1) {
      const float eb0 = emis_of(__ldg(nll + r + u)) + bt;
      const float eb1 =
          u + 1 < S ? emis_of(__ldg(nll + r + u + 1)) + __ldg(be + r + u + 1) : FB_NEG_INF;
      const float eb2 =
          u + 2 < S ? emis_of(__ldg(nll + r + u + 2)) + __ldg(be + r + u + 2) : FB_NEG_INF;
      acc0 += expf(fminf(((ap + lb[0]) + eb0) - logz, 50.0f));
      acc1 += expf(fminf(((ap + lb[1]) + eb1) - logz, 50.0f));
      acc2 += expf(fminf(((ap + lb[2]) + eb2) - logz, 50.0f));
      if (cross) accx += expf(fminf(((__ldg(al + r - S + cs) + lc) + eb0) - logz, 50.0f));
    }
    ap = at;
  }
  for (int t = nf; t < T; ++t) gam[(size_t)t * S + u] = 0.0f;
  if (band_xi) {
    float* x = a.xi + (size_t)b * 3 * S;
    x[u] = acc0;
    x[S + u] = acc1;
    x[2 * S + u] = acc2;
    if (cross) a.xi_cross[(size_t)b * S + u] = accx;
  }
}

int launch_combine(const CombineArgs& c, int B, cudaStream_t stream) {
  const long long n_slots = c.S + (c.xi_dense ? (long long)c.S * c.S : 0);
  const dim3 grid((unsigned)((n_slots + FB_COMBINE_THREADS - 1) / FB_COMBINE_THREADS), B);
  fb_combine_kernel<<<grid, FB_COMBINE_THREADS, 0, stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fb_banded_smem_bytes(int S, int R, int L, int ering, int rows_smem) {
  const size_t n = 4 * banded_smem_floats(S, R, L, ering, rows_smem);
  return n > (size_t)1 << 30 ? 1 << 30 : (int)n;
}

extern "C" int fb_banded_aux_ints(int S, int R, int L) { return banded_aux_ints(S, R, L); }

// floats of one scan CTA's device-memory rows in the device-row tier
extern "C" long long fb_banded_rows_floats(int S, int R, int L) {
  return (long long)banded_rows_floats(S, R, L);
}

extern "C" int fb_dense_smem_bytes(int S, int use_eps, int cap, int lists_smem, int ering,
                                   int rows_smem) {
  const size_t n = 4 * dense_smem_floats(S, use_eps, cap, lists_smem, ering, rows_smem);
  return n > (size_t)1 << 30 ? 1 << 30 : (int)n;
}

extern "C" long long fb_dense_list_ints(int S, int cap) { return (long long)list_ints(S, cap); }

// scan CTAs of `threads` threads and `smem` bytes resident on one SM at once
extern "C" int fb_scan_occupancy(int dense, int threads, int smem) {
  int n = 0;
  const cudaError_t e =
      dense ? cudaFuncSetAttribute(fb_dense_scan_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
            : cudaFuncSetAttribute(fb_banded_scan_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  if (dense)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_dense_scan_kernel, threads, smem);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_banded_scan_kernel, threads, smem);
  return n;
}

extern "C" int fb_banded_launch(
    const float* nll, const float* band, const float* init, const float* blk, const int* starts,
    const int* ends, const int* start_pos, const unsigned char* is_start, const int* cross_src,
    const float* cross_cost, const int* inv_off, const int* inv_dst, const float* end_scores,
    const void* n_frames, int* aux, float* alpha, float* beta, float* gamma, float* xi,
    float* xi_cross, float* log_z, long long* trace, float* rows, int B, int T, int S, int R,
    int L, int graph_per_item, int end_per_item, int eps_depth, int nf64, int ering,
    int threads, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (rows) ering = 0;  // the device-row tier stages nothing
  BandedArgs a{nll,       band,      init,      blk,        starts,  ends,
               start_pos, is_start,  cross_src, cross_cost, inv_off, inv_dst,
               end_scores, n_frames, aux,       alpha,      beta,    gamma,
               xi,        xi_cross,  log_z,     trace,      rows,    T,
               S,         R,         L,         banded_aux_ints(S, R, L),
               (int)banded_rows_floats(S, R, L), graph_per_item, end_per_item, eps_depth, nf64,
               ering};
  const size_t smem = 4 * banded_smem_floats(S, R, L, ering, rows == nullptr);
  SRT_SET_SMEM(fb_banded_scan_kernel, smem);
  fb_banded_scan_kernel<<<2 * B, threads, smem, stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  CombineArgs c{nll,  alpha, beta, log_z,    n_frames, band, nullptr, cross_src, cross_cost,
                gamma, xi,   xi_cross, T,   S,        graph_per_item, 0, nf64};
  return launch_combine(c, B, stream);
}

extern "C" int fb_dense_launch(const float* nll, const float* trans, const float* eps,
                               const float* init, const float* end_scores, const void* n_frames,
                               int* lists, float* alpha, float* beta, float* gamma, float* xi,
                               float* log_z, long long* trace, float* rows, int B, int T,
                               int S, int mats_per_item, int init_per_item, int end_per_item,
                               int eps_depth, int xi_dense, int nf64, int cap, int lists_smem,
                               int ering, int threads, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (rows) {  // the device-row tier: no ring, lists prebuilt in device memory
    ering = 0;
    lists_smem = 0;
    const ListArgs l{trans, eps, lists, S, cap, eps ? 2 : 1};
    const int rc = build_lists(l, (mats_per_item ? B : 1) * 2 * l.n_kinds, stream);
    if (rc) return rc;
  }
  DenseArgs a{nll,   trans, eps,   init,  end_scores, n_frames,      lists,
              alpha, beta,  gamma, xi,    log_z,      trace,         rows,
              T,     S,     cap,   mats_per_item, init_per_item, end_per_item, eps_depth,
              xi_dense, nf64, lists_smem, ering};
  const size_t smem = 4 * dense_smem_floats(S, eps != nullptr, cap, lists_smem, ering,
                                            rows == nullptr);
  SRT_SET_SMEM(fb_dense_scan_kernel, smem);
  fb_dense_scan_kernel<<<2 * B, threads, smem, stream>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  CombineArgs c{nll,   alpha, beta,  log_z,   n_frames, nullptr, trans, nullptr, nullptr,
                gamma, xi,    nullptr, T,     S,        mats_per_item, xi_dense, nf64};
  return launch_combine(c, B, stream);
}
