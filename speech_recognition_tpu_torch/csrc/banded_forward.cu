// Banded Viterbi forward DP over composed word graphs, four warps per
// stream, shared by three kernels.  Graphs of at most 32 words and
// BANDED_WARP_MAX_STATES states (the streaming path's CLI loop graph) run
// its warp form instead, one warp a stream with the frame step in
// registers (csrc/banded_warp.cu, all modes but K10's); the plan
// (ops/viterbi_banded_kernels.banded_plan) picks the form.
//
// K1 (kFused): the DP half of the fused emission + banded forward over a
// uniform composed word graph (eps depth 1, disjoint word starts and ends).
// Its emissions come from the emission kernel (csrc/bank_emission.cu) as a
// [T, B, U] plane.  Together they replace the TPU kernel
// speech_recognition_tpu/ops/viterbi_banded_pallas.py _kernel with
// fuse_emission=True, emit_eps_prev=True (viterbi_banded_tb_pallas, reached
// from decode/connected._decode_banded_batch).
//
// K8 (kGeneral): the forward on unit-bank emissions [U, T, B]
// (models.hmm.bank_nll_ubt) over any banded graph without cross edges, any
// eps depth.  Replaces _kernel with bank_input=True (the form
// _decode_banded_batch takes for 1-state words, words of different
// lengths, transcript graphs).
//
// K10 (kWordTrace): K1's graphs and emission plane, with an int32
// entry-time frontier tau instead of a backpointer plane.  With the
// emission kernel it replaces _kernel(emit_wordtrace=True)
// (ops/viterbi_banded_pallas.py:133, reached at :867 from
// viterbi_banded_wordtrace_pallas, the backend="wordtrace" decode).
//
// K17 (kFusedChunk, kGeneralChunk): one chunk of a streaming decode on K1's
// or K8's DP (decode/streaming.StreamingDecoder).  It replaces no Pallas
// kernel: the JAX package runs the chunk step as a lax.scan
// (speech_recognition_tpu/decode/streaming.py:86 _chunk_step).  What
// changes against K1 / K8 (the plain version is
// ops/viterbi_banded_kernels.viterbi_banded_chunk_ref):
//   carry  each stream starts from its carried frontier [S, B] (passed in
//          init's place); with `first` frame 0 seeds from it (code 0), else
//          frame 0 relaxes the band from it like any later frame
//   mask   every frame t >= nf (nf = the chunk's valid frames, 0 allowed)
//          freezes the carry, frame 0 included; final = the carry
//   org    (the C interface's modes 5 and 6) an int32 ancestor map carried
//          beside the costs, as K10 carries tau: s at the chunk start, the
//          band winner's org[s-d] (0 for s < d), and on an eps arrival the
//          origin end's org as the pass found it (snapshotted with the
//          word-end costs, Jacobi); written out as org [S, B]
//
// Per frame t of stream b (the plain versions' semantics, unchanged):
//   band   best = min_d band[d,s] + cost[s-d] (d = 0, 1, 2; cost[s-d] is
//          POS_INF for s < d); frame 0 seeds from init with d = 0.  K1 and
//          K10 take the min-chain, the largest d winning ties; K8 the plain
//          scan's _select_band (start at POS_INF, replace on <=).  K10's
//          tau follows the winner: tau[s-d] (0 for s < d), 0 at frame 0
//   emis   cost[s] = min(best + nll[bank_state[s]], POS_INF) (K8 clamps the
//          emission to POS_INF first)
//   eps    eps_depth passes; each computes, for every word r, the strict
//          first-minimum origin u of eps[r,u] + cost[end(u)] over the row's
//          finite span from the costs the previous pass left (Jacobi: a
//          1-state word entered in pass k is an origin in pass k+1), then
//          applies the candidates that strictly improve their start state:
//          bp8 = 4 (eps), eps_u = the origin of the last pass that did; K1
//          records eps_prev = end(u) - d_end(u); K10 sets tau[start] = t and
//          records eps_tau = tau[end(u)] before the pass
//   mask   K1, K10: t >= nf freezes the carry (frame 0 of an empty stream
//          gives POS_INF, tau 0), final = the carry after the last frame.
//          K8: frame 0 is never masked, frames t >= 1 with t >= nf freeze
//          the carry, final = the carry for 1 <= nf <= T, else POS_INF.
//          Frozen frames still compute and write their plane rows from the
//          frozen carry.
// Outputs: final [S,B] f32; eps_u [T,R,B] i8 (i32 when L > 127); K1 and
// K8: bp8 [T,S,B] i8; K1: eps_prev [T,R,B] i32; K10: eps_tau [T,R,B] i32
// and final_tau [S,B] i32 (no bp8).
//
// What bounds it on the H100: at B=512, T=500, S=385 the planes are ~140 MB
// (~0.04 ms at 3.35 TB/s) and the DP ~1.6 G operations (~0.02 ms), so the
// bound is the latency of T dependent frame steps per stream.  K10 moves
// less (no bp8 plane) but carries a second frontier: one more shared-memory
// load and store per state and frame.
//
// What the design does about it: kWps = 4 warps own one stream for all T
// frames and meet at the stream's own named barrier (no CTA barrier in the
// frame loop).  The stream's frontier (two [S] cost rows, each with
// POS_INF in front so that s-1 and s-2 need no test, K10's two tau rows
// with 0 in front, and the codes) lives in its work area, in shared memory
// or, when that does not fit, in a device-memory scratch.  Its 128 lanes
// take the states l, l + 128, ...: every table read is coalesced (shared
// memory without bank conflicts, or L1) and the s-1 / s-2 reads hit
// consecutive words.  The CTA copies the graph tables (per state a float4
// of the three band costs and the bank row; word starts and ends, row
// spans, the eps block transposed to [L, R]) into shared memory where they
// fit.  At B = 512 a frame step is bound by the instructions each warp
// issues and their latency, so the loops stay rolled and lean: a register
// frontier needs fully unrolled state loops, whose code outgrew the
// instruction cache (measured: 2.68 / 3.36 / 6.24 ms at 4 / 8 / 16 states
// per lane on the same 77-state graph, scripts/exp_r6_dp_plan.py); the
// band step issues the loads of kBatch states before their stores (which
// could alias them; K10's tau[s-d] loads follow the selects, still before
// the stores), and frame 0 has a loop of its own; four warps per stream
// instead of one gave each scheduler other warps' work to issue while one
// waits (K1's DP 1.54 -> 1.15 ms).  An eps pass snapshots the word-end
// costs (and K10's word-end taus), then each lane computes its rows'
// candidates from the snapshot and applies them to the row's start state
// directly (one start per row), so every candidate reads the pre-pass
// costs (Jacobi); K8 stops once a pass improves nothing, as the next pass
// would repeat it.  The emission row of frame t + kRing-1 is copied with
// cp.async into the stream's ring of kRing frames while frame t computes.
// The codes are written straight into a shared-memory staging slot; an
// extra writer warp sends the bp8 rows and the eps_u / eps_prev (K10:
// eps_u / eps_tau) rows of kf frames to device memory as
// [S, streams-per-CTA] segments (one 4- or 16-byte store for a full
// 4-stream segment) while the compute warps fill the other of two buffers
// (named barriers kBarFull / kBarEmpty); where even one frame's staging
// does not fit, each stream writes its rows itself.  The wrapper
// (ops/viterbi_banded_kernels.banded_plan) chooses where the work area and
// the tables live, the ring and kf from the sizes; nothing is refused for
// size.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBand = 2;
constexpr int kEpsCode = kMaxBand + 2;
constexpr int kRing = 4;      // frames of emissions in flight per stream
constexpr int kMaxTile = 4;   // streams per CTA
constexpr int kWps = 4;       // warps per stream
constexpr int kSL = kWps * kWarp;  // lanes per stream
constexpr int kBatch = 4;     // states per lane whose loads are issued together
constexpr int kPad = 4;       // POS_INF floats in front of each cost row
// phases of a frame step that the optional cycle trace separates: emission
// wait, band, eps passes, plane rows, mask, flush
constexpr int kPhases = 6;

enum Mode { kFused = 0, kGeneral = 1, kWordTrace = 2, kFusedChunk = 3, kGeneralChunk = 4 };
// The C interface's mode numbers add 5 and 6: the chunk modes 3 and 4 with
// the ancestor map.  The DP a mode runs (K1's, K8's or K10's), whether it
// carries a chunk's frontier, and whether it keeps the ancestor map:
__host__ __device__ constexpr int base_mode(int mode) {
  return mode <= kWordTrace ? mode : (mode - kFusedChunk) % 2;
}
__host__ __device__ constexpr bool chunk_mode(int mode) { return mode >= kFusedChunk; }
__host__ __device__ constexpr bool org_mode(int mode) { return mode >= 5; }

struct Params {
  const float* nll;       // emission (u, t, b) at u*su + t*st + b*sb
  long long su, st, sb;
  const float4* band4;    // [S] (band0, band1, band2, bank_state as int bits)
  const float* init;      // [S]; the chunk modes: the carried frontier [S, B]
  const int* word_starts; // [R]
  const int* word_ends;   // [L]
  const float* eps_t;     // [L, R] the eps block, transposed
  const int* row_lo;      // [R] finite origin span of each eps row
  const int* row_hi;      // [R]
  const int* nf;          // [B]
  float* final_cost;      // [S, B]
  int8_t* bp8;            // [T, S, B] (K1, K8)
  void* eps_u;            // [T, R, B] int8 or int32
  int u_wide;
  int* eps_aux;           // [T, R, B]: K1's eps_prev, K10's eps_tau
  int* final_tau;         // [S, B] (K10)
  int* org_out;           // [S, B] the chunk modes' ancestor map, or null
  unsigned char* scratch; // per-stream work areas when not in shared memory
  long long* trace;       // [B, kPhases] cycles per phase, or null (off)
  int U, T, B, S, R, L, eps_depth;
  int tile, work_smem, tables, ring, kf;
  int mode, first;        // the C interface's mode number; chunk: frame 0 seeds
};

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) & ~(size_t)15; }

// Bytes of one stream's work area: the two padded cost rows and the codes of
// the frontier (K10: two padded tau rows instead of the codes), K17's two
// padded ancestor-map rows (modes 5, 6), the word-end snapshot (and K1's
// end(u) - d_end(u), the eps_prev of an arrival from u; K10's word-end
// taus; K17's word-end ancestors), and each row's last improving origin.
__host__ __device__ inline size_t work_bytes(int mode, int S, int R, int L) {
  const size_t row = r16((size_t)(S + kPad) * 4);
  const int base = base_mode(mode), org = org_mode(mode);
  return (base == kWordTrace ? 4 * row : 2 * row + r16((size_t)S)) + (org ? 2 * row : 0) +
         r16((size_t)L * 4) * ((base == kGeneral ? 1 : 2) + org) + r16((size_t)R * 4);
}

__host__ __device__ inline size_t ring_bytes(int U) { return r16((size_t)kRing * U * 4); }

// Bytes of one frame of the CTA's plane staging: the bp8 rows (not K10's)
// and the int32 eps rows (eps_u, and K1's eps_prev or K10's eps_tau).
__host__ __device__ inline size_t stage_bp_bytes(int mode, int S, int tile) {
  return base_mode(mode) == kWordTrace ? 0 : r16((size_t)S * tile);
}
__host__ __device__ inline size_t stage_frame_bytes(int mode, int S, int R, int tile) {
  return stage_bp_bytes(mode, S, tile) +
         (base_mode(mode) == kGeneral ? 1 : 2) * r16((size_t)R * tile * 4);
}

// Bytes of the CTA's double-buffered plane staging for kf frames.
__host__ __device__ inline size_t stage_bytes(int mode, int S, int R, int tile, int kf) {
  return (size_t)kf * 2 * stage_frame_bytes(mode, S, R, tile);
}

// Bytes of the CTA's copy of the graph tables: band4, word starts, row
// spans, word ends and the transposed eps block.
__host__ __device__ inline size_t table_bytes(int S, int R, int L) {
  return r16((size_t)S * 16) + 3 * r16((size_t)R * 4) + r16((size_t)L * 4) +
         r16((size_t)L * R * 4);
}

__host__ __device__ inline size_t smem_bytes(int mode, int U, int S, int R, int L, int tile,
                                             int work_smem, int tables, int ring, int kf) {
  const size_t per_stream = (work_smem ? work_bytes(mode, S, R, L) : 0) +
                            (ring ? ring_bytes(U) : 0);
  return per_stream * tile + stage_bytes(mode, S, R, tile, kf) +
         (tables ? table_bytes(S, R, L) : 0);
}

// A table read: from the CTA's shared-memory copy, or through L1.
template <bool kShared, typename T>
__device__ __forceinline__ T ldt(const T* p) {
  if constexpr (kShared)
    return *p;
  else
    return __ldg(p);
}

// Named CTA barriers between the compute warps and the writer warp, and
// one per stream between its warps.
constexpr int kBarFull = 1;   // a staged block is ready to be written
constexpr int kBarEmpty = 2;  // a staging buffer has been written out
constexpr int kBarStream = 3; // + the stream's index in the CTA
constexpr int kBarCompute = kBarStream + kMaxTile;  // every compute warp of the CTA
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// bar.sync that also returns whether any participating thread passed true
__device__ __forceinline__ bool bar_any(int id, int n, bool v) {
  int r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n"
      " bar.red.or.pred q, %2, %3, p;\n selp.u32 %0, 1, 0, q;\n}"
      : "=r"(r)
      : "r"((int)v), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Band select of one state from its three candidates.
template <int kMode>
__device__ __forceinline__ float band_select(float c0, float c1, float c2, int& d) {
  if (kMode != kGeneral) {  // min-chain, the largest d wins ties
    const float best = fminf(fminf(c0, c1), c2);
    d = (c2 == best) ? 2 : ((c1 == best) ? 1 : 0);
    return best;
  }
  float best = SRT_POS_INF;  // _select_band: replace on <=
  d = 0;
  if (c0 <= best) { best = c0; d = 0; }
  if (c1 <= best) { best = c1; d = 1; }
  if (c2 <= best) { best = c2; d = 2; }
  return best;
}

// kWorkSmem: the work area is in shared memory (so the compiler emits
// shared-memory accesses), else in the device scratch.  kTables: the CTA's
// copy of the graph tables in shared memory, else they are read through
// L1.  kRingOn: emissions from the cp.async ring, else straight from
// device memory.
constexpr int kMaxThreads = (kMaxTile * kWps + 1) * kWarp;

template <int kMode, bool kWorkSmem, bool kTables, bool kRingOn>
__device__ __forceinline__ void banded_forward_body(const Params& p) {
  constexpr int kBase = base_mode(kMode);
  constexpr bool kChunk = chunk_mode(kMode);
  constexpr bool kK1 = kBase == kFused;
  constexpr bool kWT = kBase == kWordTrace;
  constexpr bool kAux = kBase != kGeneral;  // a second int32 eps plane
  const bool org = kChunk && org_mode(p.mode);  // K17's ancestor map
  extern __shared__ __align__(16) unsigned char smem[];
  // tile streams of kWps warps each; with staging a writer warp follows
  const int tile = p.tile;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int sw = min(warp / kWps, tile - 1);  // the stream within the CTA
  const int ln = threadIdx.x % kSL;           // the lane within the stream
  const int gw = blockIdx.x * tile + sw;      // the stream (padded)
  const bool live = gw < p.B;
  const int b = live ? gw : p.B - 1;        // padding warps compute a copy
  const int S = p.S, R = p.R, L = p.L, T = p.T;
  const int nf = live ? p.nf[b] : 0;

  // ---- shared memory / scratch carve-up --------------------------------
  const size_t wk = work_bytes(p.mode, S, R, L);
  const size_t rg = kRingOn ? ring_bytes(p.U) : 0;
  unsigned char* mine = smem + (size_t)sw * ((kWorkSmem ? wk : 0) + rg);
  unsigned char* work = kWorkSmem ? mine : p.scratch + (size_t)gw * wk;
  float* ring = reinterpret_cast<float*>(mine + (kWorkSmem ? wk : 0));
  const size_t row = r16((size_t)(S + kPad) * 4);
  float* cur = reinterpret_cast<float*>(work) + kPad;                  // [S]
  float* nxt = reinterpret_cast<float*>(work + row) + kPad;            // [S]
  unsigned char* q = work + 2 * row;
  int* tcur = reinterpret_cast<int*>(q) + kPad;                        // [S] (K10)
  int* tnxt = reinterpret_cast<int*>(q + row) + kPad;                  // [S] (K10)
  int8_t* wcode = reinterpret_cast<int8_t*>(q);                        // [S] (K1, K8)
  q += kWT ? 2 * row : r16((size_t)S);
  int* ocur = reinterpret_cast<int*>(q) + kPad;                        // [S] (K17 org)
  int* onxt = reinterpret_cast<int*>(q + row) + kPad;                  // [S] (K17 org)
  q += org ? 2 * row : 0;
  float* ends = reinterpret_cast<float*>(q);                           // [L]
  q += r16((size_t)L * 4);
  int* endpp = reinterpret_cast<int*>(q);  // [L] K1: end - d_end; K10: tau of the end
  q += kAux ? r16((size_t)L * 4) : 0;
  int* endorg = reinterpret_cast<int*>(q);                             // [L] (K17 org)
  q += org ? r16((size_t)L * 4) : 0;
  int* eu = reinterpret_cast<int*>(q);                                 // [R]
  unsigned char* stage = smem + (size_t)tile * ((kWorkSmem ? wk : 0) + rg);
  const size_t st_bp = stage_bp_bytes(kMode, S, tile), st_row = r16((size_t)R * tile * 4);
  const size_t st_frame = stage_frame_bytes(kMode, S, R, tile);

  // ---- graph tables ---------------------------------------------------------
  const float4* band4 = p.band4;
  const int* word_starts = p.word_starts;
  const int* word_ends = p.word_ends;
  const int* row_lo = p.row_lo;
  const int* row_hi = p.row_hi;
  const float* eps_t = p.eps_t;
  if constexpr (kTables) {
    unsigned char* tb = stage + stage_bytes(kMode, S, R, tile, p.kf);
    float4* b4 = reinterpret_cast<float4*>(tb);
    for (int i = threadIdx.x; i < S; i += blockDim.x) b4[i] = __ldg(p.band4 + i);
    tb += r16((size_t)S * 16);
    int* ws = reinterpret_cast<int*>(tb);
    int* lo = ws + r16((size_t)R * 4) / 4;
    int* hi = lo + r16((size_t)R * 4) / 4;
    int* we = hi + r16((size_t)R * 4) / 4;
    float* et = reinterpret_cast<float*>(we + r16((size_t)L * 4) / 4);
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
      ws[i] = __ldg(p.word_starts + i);
      lo[i] = __ldg(p.row_lo + i);
      hi[i] = __ldg(p.row_hi + i);
    }
    for (int i = threadIdx.x; i < L; i += blockDim.x) we[i] = __ldg(p.word_ends + i);
    for (size_t i = threadIdx.x; i < (size_t)L * R; i += blockDim.x) et[i] = __ldg(p.eps_t + i);
    band4 = b4;
    word_starts = ws;
    row_lo = lo;
    row_hi = hi;
    word_ends = we;
    eps_t = et;
    __syncthreads();
  }
  auto bank_of = [&](int s) { return __float_as_int(ldt<kTables>(&band4[s].w)); };

  // ---- the writer warp: writes each staged block of kf frames out as
  // [S, streams-per-CTA] segments while the compute warps fill the other
  // buffer ----------------------------------------------------------------
  const int n_all = (tile * kWps + (p.kf ? 1 : 0)) * kWarp;
  if (p.kf && warp == tile * kWps) {
    const int b0 = blockIdx.x * tile;
    const int nb_ = min(tile, p.B - b0);
    // whole 4-stream segments go out as one 4-byte (int8) or 16-byte
    // (int32) store
    const bool words = tile == 4 && nb_ == 4 && (p.B & 3) == 0;
    for (int t0 = 0, j = 0; t0 < T; t0 += p.kf, ++j) {
      bar_sync(kBarFull, n_all);
      const unsigned char* base = stage + (size_t)(j & 1) * p.kf * st_frame;
      for (int ff = 0; ff < min(p.kf, T - t0); ++ff) {
        const unsigned char* fr = base + (size_t)ff * st_frame;
        if (!kWT) {
          int8_t* dst = p.bp8 + (size_t)(t0 + ff) * S * p.B + b0;
          for (int s = lane; s < S; s += kWarp) {
            const int8_t* src = reinterpret_cast<const int8_t*>(fr) + s * tile;
            if (words)
              *reinterpret_cast<int*>(dst + (size_t)s * p.B) = *reinterpret_cast<const int*>(src);
            else
              for (int k = 0; k < nb_; ++k) dst[(size_t)s * p.B + k] = src[k];
          }
        }
        for (int r = lane; r < R; r += kWarp) {
          const int* su_ = reinterpret_cast<const int*>(fr + st_bp) + r * tile;
          const int* sp_ = reinterpret_cast<const int*>(fr + st_bp + st_row) + r * tile;
          const size_t o = ((size_t)(t0 + ff) * R + r) * p.B + b0;
          if (words) {
            const int4 uv = *reinterpret_cast<const int4*>(su_);
            if (p.u_wide)
              *reinterpret_cast<int4*>(static_cast<int*>(p.eps_u) + o) = uv;
            else
              *reinterpret_cast<char4*>(static_cast<int8_t*>(p.eps_u) + o) =
                  make_char4((char)uv.x, (char)uv.y, (char)uv.z, (char)uv.w);
            if (kAux)
              *reinterpret_cast<int4*>(p.eps_aux + o) = *reinterpret_cast<const int4*>(sp_);
          } else {
            for (int k = 0; k < nb_; ++k) {
              if (p.u_wide)
                static_cast<int*>(p.eps_u)[o + k] = su_[k];
              else
                static_cast<int8_t*>(p.eps_u)[o + k] = (int8_t)su_[k];
              if (kAux) p.eps_aux[o + k] = sp_[k];
            }
          }
        }
      }
      bar_arrive(kBarEmpty, n_all);
    }
    return;
  }

  // the stream's warps meet at their own named barrier
  auto stream_sync = [&]() { bar_sync(kBarStream + sw, kSL); };

  // ---- emission ring ------------------------------------------------------
  const float* nb = p.nll + (size_t)b * p.sb;
  auto prefetch = [&](int tf) {
    if (tf < T) {
      float* dst = ring + (tf % kRing) * p.U;
      const float* src = nb + (size_t)tf * p.st;
      for (int u = ln; u < p.U; u += kSL) cp_async4(dst + u, src + (size_t)u * p.su);
    }
    cp_async_commit();  // an empty group keeps the group count per frame fixed
  };
  if (kRingOn)
    for (int tf = 0; tf < kRing - 1; ++tf) prefetch(tf);

  for (int i = ln; i < S + kPad; i += kSL) {
    // the chunk modes start from the stream's carried frontier
    cur[i - kPad] = (kChunk && i >= kPad) ? __ldg(p.init + (size_t)(i - kPad) * p.B + b)
                                          : SRT_POS_INF;
    nxt[i - kPad] = SRT_POS_INF;
    if (kWT) {  // tau 0 in front of the rows and before frame 0
      tcur[i - kPad] = 0;
      tnxt[i - kPad] = 0;
    }
    if (org) {  // 0 in front of the rows; each state its own ancestor
      ocur[i - kPad] = i >= kPad ? i - kPad : 0;
      onxt[i - kPad] = 0;
    }
  }
  for (int r = ln; r < R; r += kSL) eu[r] = -1;  // -1: not entered by eps
  stream_sync();

  // the optional trace: lane 0 of each stream sums clock64() deltas per phase
  long long tr[kPhases] = {0, 0, 0, 0, 0, 0};
  long long tc = clock64();
  auto mark = [&](int ph) {
    if (p.trace) {
      const long long now = clock64();
      tr[ph] += now - tc;
      tc = now;
    }
  };

  int buf = 0, f = 0;  // staging buffer and frame within it
  for (int t = 0; t < T; ++t) {
    const float* er = ring + (t % kRing) * p.U;
    if (kRingOn) {
      prefetch(t + kRing - 1);
      cp_async_wait<kRing - 1>();
      stream_sync();
    }
    const float* eg = nb + (size_t)t * p.st;
    auto emis = [&](int u) {
      const float e = kRingOn ? er[u] : __ldg(eg + (size_t)u * p.su);
      return kAux ? e : fminf(e, SRT_POS_INF);
    };
    // a block of kf frames reuses the buffer of the block before last:
    // wait until the writer warp has written that one out
    if (p.kf && f == 0 && t >= 2 * p.kf) bar_sync(kBarEmpty, n_all);
    // this frame's codes: written straight into the staging slot (its bp8
    // row) when planes are staged, else into the work area (K10 keeps none)
    unsigned char* fb = stage + (size_t)(buf * p.kf + f) * st_frame;
    int8_t* code = p.kf ? reinterpret_cast<int8_t*>(fb) + sw : wcode;
    const int cs = p.kf ? tile : 1;  // code stride
    mark(0);

    // (a) band relaxation + emission; frame 0 seeds from init (code 0), a
    // chunk's from the carried frontier, or (a later chunk) relaxes from it
    if (t == 0 && (!kChunk || p.first)) {
      for (int s = ln; s < S; s += kSL) {
        nxt[s] = fminf((kChunk ? cur[s] : __ldg(p.init + s)) + emis(bank_of(s)), SRT_POS_INF);
        if (kWT)
          tnxt[s] = 0;
        else
          code[s * cs] = 0;
        if (org) onxt[s] = s;
      }
    } else {
      // kBatch states per lane at a time: every load of a batch is issued
      // before its first store (the stores could alias the loads)
      for (int sb = ln; sb < S; sb += kBatch * kSL) {
        float4 bd[kBatch];
        float c0[kBatch], c1[kBatch], c2[kBatch], e[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int s = min(sb + k * kSL, S - 1);  // past S: a copy, not written
          bd[k] = ldt<kTables>(band4 + s);
          c0[k] = cur[s];
          c1[k] = cur[s - 1];  // POS_INF in front of the row
          c2[k] = cur[s - 2];
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) e[k] = emis(__float_as_int(bd[k].w));
        if constexpr (kWT) {
          // the entry time follows the band winner (0 in front of the row);
          // its loads, like the others, come before the batch's stores
          int d[kBatch], tau[kBatch];
          float best[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            best[k] = band_select<kBase>(bd[k].x + c0[k], bd[k].y + c1[k], bd[k].z + c2[k],
                                         d[k]);
#pragma unroll
          for (int k = 0; k < kBatch; ++k) tau[k] = tcur[min(sb + k * kSL, S - 1) - d[k]];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int s = sb + k * kSL;
            if (s < S) {
              nxt[s] = fminf(best[k] + e[k], SRT_POS_INF);
              tnxt[s] = tau[k];
            }
          }
        } else if (org) {
          // the ancestor follows the band winner (0 in front of the row);
          // its loads, like the others, come before the batch's stores
          int d[kBatch], o[kBatch];
          float best[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            best[k] = band_select<kBase>(bd[k].x + c0[k], bd[k].y + c1[k], bd[k].z + c2[k],
                                         d[k]);
#pragma unroll
          for (int k = 0; k < kBatch; ++k) o[k] = ocur[min(sb + k * kSL, S - 1) - d[k]];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int s = sb + k * kSL;
            if (s < S) {
              nxt[s] = fminf(best[k] + e[k], SRT_POS_INF);
              code[s * cs] = (int8_t)d[k];
              onxt[s] = o[k];
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int s = sb + k * kSL;
            if (s < S) {
              int d;
              const float best = band_select<kBase>(bd[k].x + c0[k], bd[k].y + c1[k],
                                                    bd[k].z + c2[k], d);
              nxt[s] = fminf(best + e[k], SRT_POS_INF);
              code[s * cs] = (int8_t)d;
            }
          }
        }
      }
    }
    stream_sync();
    mark(1);

    // (b) eps passes: snapshot the word-end costs; each lane computes its
    // rows' candidates from the snapshot (lanes take consecutive rows, so
    // the rows of one eps range read consecutive entries of the transposed
    // block and one word end per step) and applies each to the row's start
    for (int pass = 0; pass < p.eps_depth; ++pass) {
      for (int ub = ln; ub < L; ub += 4 * kSL) {
        int e[4], pe[4], oe[4];
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = ldt<kTables>(word_ends + min(ub + k * kSL, L - 1));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = nxt[e[k]];
          pe[k] = kK1 ? e[k] - code[e[k] * cs] : (kWT ? tnxt[e[k]] : 0);
          oe[k] = org ? onxt[e[k]] : 0;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (ub + k * kSL < L) {
            ends[ub + k * kSL] = v[k];
            if (kAux) endpp[ub + k * kSL] = pe[k];
            if (org) endorg[ub + k * kSL] = oe[k];
          }
      }
      stream_sync();
      bool improved = false;
      for (int r = ln; r < R; r += kSL) {
        const int lo = ldt<kTables>(row_lo + r), hi = ldt<kTables>(row_hi + r);
        const int st = ldt<kTables>(word_starts + r);
        const float es = emis(bank_of(st));
        const float old = nxt[st];  // the row's start is this lane's alone
        const float* ec = eps_t + r;
        float bm = SRT_POS_INF;
        int arg = 0;
        for (int u = lo; u < hi; u += 4) {  // four loads in flight per step
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)  // past the span: +inf, never a strict minimum
            v[k] = u + k < hi ? ldt<kTables>(ec + (size_t)(u + k) * R) + ends[u + k]
                              : INFINITY;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (v[k] < bm) {  // strict: first minimum in origin order
              bm = v[k];
              arg = u + k;
            }
        }
        const float cand = fminf(bm + es, SRT_POS_INF);
        if (cand < old) {  // strict improvement only
          nxt[st] = cand;
          if (kWT)
            tnxt[st] = t;
          else
            code[st * cs] = (int8_t)kEpsCode;
          if (org) onxt[st] = endorg[arg];
          eu[r] = arg;
          improved = true;
        }
      }
      // (this barrier also orders the applies before the next snapshot);
      // K8 stops once a pass improves nothing
      if (!bar_any(kBarStream + sw, kSL, improved)) break;
    }
    mark(2);

    // (c) planes of this frame: bp8 (already in the staging slot when
    // staged); eps_u (and K1's eps_prev, K10's eps_tau) per row from its
    // own lane: the last improving origin (and its snapshot entry), 0 when
    // no pass improved the row's start
    if (!kWT && !p.kf && live)
      for (int s = ln; s < S; s += kSL) p.bp8[((size_t)t * S + s) * p.B + b] = code[s];
    int* st_u = reinterpret_cast<int*>(fb + st_bp) + sw;
    for (int r = ln; r < R; r += kSL) {
      const int uo = max(eu[r], 0);
      const int pp = (kAux && eu[r] >= 0) ? endpp[uo] : 0;
      eu[r] = -1;
      if (p.kf) {
        st_u[r * tile] = uo;
        if (kAux) reinterpret_cast<int*>(fb + st_bp + st_row)[r * tile + sw] = pp;
      } else if (live) {
        const size_t o = ((size_t)t * R + r) * p.B + b;
        if (p.u_wide)
          static_cast<int*>(p.eps_u)[o] = uo;
        else
          static_cast<int8_t*>(p.eps_u)[o] = (int8_t)uo;
        if (kAux) p.eps_aux[o] = pp;
      }
    }
    mark(3);

    // (d) length mask: the carry moves on only for active frames
    const bool frozen = (kAux || kChunk) ? t >= nf : (t >= 1 && t >= nf);
    if (!frozen) {
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (kWT) {
        int* ttmp = tcur;
        tcur = tnxt;
        tnxt = ttmp;
      }
      if (org) {
        int* otmp = ocur;
        ocur = onxt;
        onxt = otmp;
      }
    }
    stream_sync();  // the ring slot and the work area are reused next frame
    mark(4);

    // (e) every kf frames (and after the last) hand the block to the writer.
    // kBarFull counts arrivals, so a stream must not arrive for the next
    // block before every stream has arrived for this one: from the third
    // block on, the kBarEmpty wait keeps the CTA's streams within a block
    // of each other; before it, the compute warps meet here (a stream
    // whose frames run more eps passes, such as one frozen on its initial
    // frontier, otherwise fell a block behind and the writer sent its
    // half-written rows)
    if (p.kf && (f == p.kf - 1 || t == T - 1)) {
      if (t < 2 * p.kf) bar_sync(kBarCompute, tile * kSL);
      bar_arrive(kBarFull, n_all);
      buf ^= 1;
      f = 0;
    } else if (p.kf) {
      ++f;
    }
    mark(5);
  }
  if (kRingOn) cp_async_wait<0>();
  // the writer's last two blocks: keep the barrier generations balanced
  if (p.kf)
    for (int j = max((T + p.kf - 1) / p.kf - 2, 0); j < (T + p.kf - 1) / p.kf; ++j)
      bar_sync(kBarEmpty, n_all);

  if (!live) return;
  if (p.trace && ln == 0)
    for (int k = 0; k < kPhases; ++k) p.trace[(size_t)b * kPhases + k] = tr[k];
  const bool has_final = kAux || kChunk || (nf >= 1 && nf <= T);
  for (int s = ln; s < S; s += kSL) {
    p.final_cost[(size_t)s * p.B + b] = has_final ? cur[s] : SRT_POS_INF;
    if (kWT) p.final_tau[(size_t)s * p.B + b] = tcur[s];
    if (org) p.org_out[(size_t)s * p.B + b] = ocur[s];
  }
}

// K1 and K8.  The word-trace mode has a kernel of its own that declares
// one CTA per SM: without that, ptxas held its instances that read the
// tables through L1 to 56 registers and spilled (the 7,500-state loop at
// 64 x 100: 250.8 ms against 110.9), while the same declaration slowed K8
// on the 7,000-state loop from 195.6 to 249.7 ms
// (scripts/exp_r8_emission.py --lab --big).
template <int kMode, bool kWorkSmem, bool kTables, bool kRingOn>
__global__ void __launch_bounds__(kMaxThreads) banded_forward_kernel(Params p) {
  banded_forward_body<kMode, kWorkSmem, kTables, kRingOn>(p);
}
template <bool kWorkSmem, bool kTables, bool kRingOn>
__global__ void __launch_bounds__(kMaxThreads, 1) wordtrace_forward_kernel(Params p) {
  banded_forward_body<kWordTrace, kWorkSmem, kTables, kRingOn>(p);
}

template <int kMode, bool kWorkSmem, bool kTables, bool kRingOn>
int launch(const Params& p, int tile, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.mode, p.U, p.S, p.R, p.L, tile, p.work_smem, p.tables,
                                 p.ring, p.kf);
  void (*kernel)(Params);
  if constexpr (kMode == kWordTrace)
    kernel = wordtrace_forward_kernel<kWorkSmem, kTables, kRingOn>;
  else
    kernel = banded_forward_kernel<kMode, kWorkSmem, kTables, kRingOn>;
  SRT_SET_SMEM(kernel, smem);
  // carve out the shared memory of the CTAs an SM holds at once, no more:
  // the rest of its 256 KB stays L1, which serves the tables read through it
  const int grid = (p.B + tile - 1) / tile;
  int dev = 0, n_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const size_t per_sm = smem * (size_t)((grid + n_sm - 1) / n_sm);
  const int pct = (int)((per_sm * 100 + SRT_MAX_SMEM - 1) / SRT_MAX_SMEM);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct < 100 ? pct : 100);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, (tile * kWps + (p.kf ? 1 : 0)) * kWarp, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int kMode, bool kWorkSmem, bool kTables>
int launch_ring(const Params& p, int tile, cudaStream_t s) {
  return p.ring ? launch<kMode, kWorkSmem, kTables, true>(p, tile, s)
                : launch<kMode, kWorkSmem, kTables, false>(p, tile, s);
}

template <int kMode>
int launch_mode(const Params& p, int tile, cudaStream_t s) {
  if (p.work_smem)
    return p.tables ? launch_ring<kMode, true, true>(p, tile, s)
                    : launch_ring<kMode, true, false>(p, tile, s);
  return p.tables ? launch_ring<kMode, false, true>(p, tile, s)
                  : launch_ring<kMode, false, false>(p, tile, s);
}

}  // namespace

// Modes of the C interface: 0 K1 (uniform graphs, eps_prev), 1 K8 (any
// banded graph), 2 K10 (uniform graphs, entry times), 3 and 4 K17 (the chunk
// step on K1's or K8's DP), 5 and 6 the same with the ancestor map.
inline bool valid_mode(int mode) { return mode >= kFused && mode <= 6; }

// Shared memory of one CTA for a plan (the wrapper's banded_plan computes
// the same sum; the card tests hold the two equal).
extern "C" int banded_forward_smem_bytes(int mode, int U, int S, int R, int L, int tile,
                                         int work_smem, int tables, int ring, int kf) {
  if (!valid_mode(mode)) return -1;
  const size_t n = smem_bytes(mode, U, S, R, L, tile, work_smem, tables, ring, kf);
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
}

// Bytes of one stream's work area (the scratch holds one per padded stream).
extern "C" long long banded_forward_work_bytes(int mode, int S, int R, int L) {
  return valid_mode(mode) ? (long long)work_bytes(mode, S, R, L) : -1;
}

// nll: emission (u, t, b) at u*su + t*st + b*sb; band4 [S] float4 (band0,
// band1, band2, bank_state's int bits); init [S] (K17: the carried frontier
// [S, B], and `first`: frame 0 seeds from it); word_starts [R];
// word_ends [L]; eps_t [L, R]; row_lo / row_hi [R]; nf [B] -> final [S, B],
// eps_u [T, R, B]; K1, K8 and K17: bp8 [T, S, B]; K1 and K17 on K1's DP:
// eps_aux = eps_prev [T, R, B]; K10: eps_aux = eps_tau [T, R, B] and
// final_tau [S, B]; K17 with the ancestor map (modes 5, 6): org [S, B].
// scratch: (B rounded up to the tile) work areas when work_smem is 0.
// trace: null, or [B, 6] int64 that receives each stream's cycles per phase
// of the frame steps (emission wait, band, eps passes, plane rows, mask,
// flush; scripts/exp_r6_dp_plan.py and scripts/exp_r8_emission.py read it).
extern "C" int banded_forward_launch(
    int mode, const float* nll, long long su, long long st, long long sb,
    const void* band4, const float* init, const int* word_starts, const int* word_ends,
    const float* eps_t, const int* row_lo, const int* row_hi, const int* nf, int first,
    float* final_cost, int8_t* bp8, void* eps_u, int u_wide, int* eps_aux, int* final_tau,
    int* org_out, void* scratch, int U, int T, int B, int S, int R, int L, int eps_depth,
    int tile, int work_smem, int tables, int ring, int kf, long long* trace, void* stream) {
  const int base = valid_mode(mode) ? base_mode(mode) : -1;
  if (base < 0 || U < 1 || S < 1 || R < 1 || L < 1 || eps_depth < 1 || B <= 0 ||
      T <= 0 || tile < 1 || tile > kMaxTile || kf < 0 || (!work_smem && scratch == nullptr) ||
      (base != kWordTrace && bp8 == nullptr) ||
      (base != kGeneral && (eps_depth != 1 || eps_aux == nullptr)) ||
      (base == kWordTrace && final_tau == nullptr) || (org_mode(mode) != (org_out != nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.nll = nll; p.su = su; p.st = st; p.sb = sb;
  p.band4 = static_cast<const float4*>(band4); p.init = init;
  p.word_starts = word_starts; p.word_ends = word_ends; p.eps_t = eps_t;
  p.row_lo = row_lo; p.row_hi = row_hi;
  p.nf = nf; p.final_cost = final_cost; p.bp8 = bp8; p.eps_u = eps_u;
  p.u_wide = u_wide; p.eps_aux = eps_aux; p.final_tau = final_tau; p.org_out = org_out;
  p.mode = mode; p.first = first;
  p.scratch = static_cast<unsigned char*>(scratch);
  p.U = U; p.T = T; p.B = B; p.S = S; p.R = R; p.L = L; p.eps_depth = eps_depth;
  p.tile = tile; p.work_smem = work_smem; p.tables = tables; p.ring = ring; p.kf = kf;
  p.trace = trace;
  const cudaStream_t s = (cudaStream_t)stream;
  if (chunk_mode(mode))
    return base == kFused ? launch_mode<kFusedChunk>(p, tile, s)
                          : launch_mode<kGeneralChunk>(p, tile, s);
  switch (mode) {
    case kFused: return launch_mode<kFused>(p, tile, s);
    case kGeneral: return launch_mode<kGeneral>(p, tile, s);
    default: return launch_mode<kWordTrace>(p, tile, s);
  }
}
