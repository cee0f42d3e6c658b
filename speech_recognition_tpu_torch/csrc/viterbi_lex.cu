// K4: banded Viterbi forward over a lexical tree (trie of unit HMMs).
//
// Replaces the TPU kernels speech_recognition_tpu/ops/viterbi_lex_pallas.py
// _lex_kernel with emit_eps_prev=True (viterbi_lex_pallas) and its
// lane-major twin _lex_kernel_wide (viterbi_lex_pallas_wide), which the JAX
// package takes above ~25k states.  Both are one kernel here, in the
// graph's own state numbering: the Pallas SoA rows, BFS-level one-hot
// selectors, bf16 x 3 splits and 8/128 padding exist to turn gathers into
// MXU work, and on this card a gather is an indexed load.
//
// Per stream b and frame t < nf[b] (the rules of the plain version,
// ops/viterbi_banded.viterbi_banded_tb, which the tests hold bit-exact):
//   band     best over d = 0, 1, 2 of band[d,v] + prev[v-d], starting from
//            POS_INF and taking on <=, so the largest d wins ties
//            (_select_band; the Pallas min-chain at viterbi_lex_pallas.py
//            :655-661 gives the same code wherever the min is <= POS_INF)
//   cross    cand = min(prev[cross_src[v]] + cross_cost[v], POS_INF) from
//            the PREVIOUS frontier, after the band select; it wins ties
//            (take on <=; viterbi_lex_pallas.py:682-693) -> code 3
//   frame 0  seeds from init_cost with code 0 and no band or cross step
//   emission cost = min(base + nll[bank_state[v], t, b], POS_INF) after
//            band/cross (nll clamped to POS_INF first)
//   eps      on the CURRENT frame's leaf-end costs: per root r the first
//            minimum over leaf slots l of fl(eps[r,l] + cost[word_ends[l]])
//            (unclamped, as the XLA scan; the Pallas row-constant shortcut
//            is not carried over: it can pick another origin on a rounding
//            tie); the root start takes cand = min(min + nll[start], POS_INF)
//            only on strict improvement, code 4; eps_u = l*, eps_prev =
//            word_ends[l*] - code(word_ends[l*]), the code written before
//            the eps pass.  The eps pass also runs at frame 0.
//   length   frames t >= nf[b] are not computed (one CTA per stream, so the
//            test is uniform); final = the frontier after frame nf-1, POS_INF
//            when nf = 0.  Plane entries at t >= nf are not written.
// Outputs: final [B,S] f32, bp8 [T,B,S] i8, eps_u [T,B,R] (i8, i32 when
// L > 127), eps_prev [T,B,R] i32.
//
// K6, the lattice mode (template argument kLattice), replaces
// _lex_kernel(emit_lattice=True) (viterbi_lex_pallas_lattice) and
// _lex_kernel_wide(emit_lattice=True) (viterbi_lex_pallas_wide_lattice):
// the same band, cross and eps rules with an int32 entry-time frontier tau
// double-buffered beside the costs, following the plain version
// ops/lattice.viterbi_lattice_tb (the reference's XLA scan):
//   tau      the band winner's tau[v-d]; then tau[cross_src[v]] where the
//            cross edge wins (so a dead state, whose band candidates are
//            all above POS_INF, takes its cross source's tau, as the scan
//            does); then t where the re-entry strictly improves a root
//            start; frame 0 seeds tau = 0 and still runs the eps pass
//   length   frame 0 runs for every stream, nf = 0 included; frames
//            t >= max(nf, 1) repeat the last computed frame, so every row
//            t < T of the planes is written; final = the frontier after
//            frame nf-1 for 1 <= nf <= T, else POS_INF
// Outputs: final [B,S] f32, ends_cost [T,B,L] f32 and ends_tau [T,B,L] i32
// (leaf-slot order); no bp8 or eps planes.
//
// What bounds it on the H100: the latency of T dependent frame steps per
// stream; the bytes (the emission rows, the planes) and the operations
// (~11 per state and frame) are far below the card's rates.  One CTA owns
// one stream, so a frame step is one SM's work: with the graph on chip, the
// instructions and shared-memory wavefronts of its ~10k state updates.
//
// What the design does about it:
//   tables   the wrapper packs the graph once (ops/viterbi_lex_kernels
//            lex_pack): the band factorises over bank rows (band[d,v] ==
//            rows[bank_state[v]][d] for every trie build_lex_graph makes),
//            so per state one 32-bit record is read: the bank row in the
//            low `shift` bits, above it a link, either the state's entry in
//            a compact (source, cost) cross table (entry 0 the default pair
//            that most states carry, then only the states whose pair
//            differs, so every state reads a pair and no branch diverges)
//            or, with bit 31 set, the state's leaf slot.  Where the bank
//            rows and the links do not fit 31 bits together, the wide
//            records (template argument kWide) hold two words per state,
//            the bank row and the link, read through L1.  A graph whose
//            band does not factorise runs the general mode, which reads
//            per-state band rows (band_s) through L1.  Records, cross table
//            and eps block (one value per root where its row is constant)
//            are staged into shared memory once per CTA with cp.async where
//            the plan finds room, else read through L1.
//   frontier the two cost rows (and K6's two tau rows) live in shared
//            memory where they fit, else in a [B, 2, S + 4] device scratch;
//            each row has POS_INF (tau: 0) in front, so v-1 and v-2 need no
//            test.  With the frontier on chip K4's codes are staged there
//            too and copied out, a word at a time, during the next frame;
//            the CTA has 512 threads (128 registers each; the step is bound
//            by the instructions it issues), else 1,024 (to hide the
//            device-memory latency).  The plan (lex_plan) is chosen by the
//            wrapper from the sizes: the 1k trie on chip, the 86,520-state
//            trie in device memory.
//   emission the next frame's bank rows are copied with cp.async into the
//            .w lane of a per-frame row table (band costs in .xyz), so one
//            16-byte load gives a state its band costs and its emission;
//            each row is kept eight times, so the eight lanes of a quarter
//            warp read eight different bank groups.  Where not even the two
//            row tables fit (over ~7,000 bank rows), the plan keeps none
//            (rep 0, template argument kRowsDev): the band phase reads each
//            state's band costs and its emission nll[row, t, b] through L1
//            where it needs them, and the frontier and tables live in
//            device memory, so no bank size is refused.
//   eps      the band phase writes each leaf end's cost (and K4's eps_prev
//            or K6's entry time) into its leaf slot, so the frame's
//            leaf-end costs are gathered once; each root's first minimum is
//            one warp's (value, index) scan and shuffle reduction, applied
//            by the same warp, so a frame step has two block barriers
//            (after the band phase, after the eps pass).  A graph whose word
//            ends repeat, or whose leaf ends carry their own cross pair,
//            runs the gather mode instead: each root's warp reads
//            cost[word_ends[l]] itself.
// K18, the chunk mode (template argument kChunk, the C interface's modes 2
// and 3), is one chunk of a streaming decode over the trie
// (decode/streaming.StreamingDecoder).  It replaces no Pallas kernel: the
// JAX package runs the chunk step as a lax.scan
// (speech_recognition_tpu/decode/streaming.py:86 _chunk_step).  Against K4
// (its plain version is ops/viterbi_lex_kernels.viterbi_lex_chunk_ref):
//   carry    each stream starts from its carried frontier [B, S]; with
//            `first` frame 0 seeds from it (code 0), else frame 0 runs the
//            band and cross step from it like any later frame
//   length   all T frames run; frames t >= nf (0 allowed) compute and write
//            their planes from the frozen carry, which moves on only for
//            t < nf; final = the carry
//   org      (mode 3) an int32 ancestor map in the rows K6 keeps tau in: v
//            at the chunk start, the band winner's org[v-d] (0 for v < d) or
//            the cross source's org, and on a re-entry the leaf end's org
//            (starts and ends are disjoint, so the eps pass never writes
//            what it reads); written out as org [B, S]
//
// An optional per-phase clock64 trace (kPhases) is written when a pointer
// is passed (scripts/exp_r7_lex_plan.py reads it).

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

// threads per CTA: with the frontier on chip a frame step is bound by the
// instructions it issues, and 512 threads leave each 128 registers; with
// it in device memory it waits on loads, and 1,024 threads hide more
template <bool kFront>
__host__ __device__ constexpr int threads_for() {
  return kFront ? 512 : 1024;
}
constexpr int kCrossCode = 3;
constexpr int kEpsCode = 4;
constexpr int kPad = 4;          // POS_INF (tau: 0) entries in front of a row
// phases of a frame step that the optional trace separates: band, barrier
// A, (K6's planes and) the eps scan, its warp reduction, the apply, barrier
// B
constexpr int kPhases = 6;
constexpr unsigned kLeaf = 0x80000000u;

// The kernel's modes (its first template argument), numbered as in the C
// interface: K18 without and with the ancestor map are instances of their
// own, so that K18's frame step carries no test of a map it does not keep.
enum LexMode { kLexFwd = 0, kLatticeMode = 1, kChunkMode = 2, kChunkOrgMode = 3 };
// The C interface's modes that keep a second int32 frontier (K6's tau, K18's
// ancestor map) and that stage K4's codes (all but K6)
__host__ __device__ inline bool has_tau(int mode) { return mode == 1 || mode == 3; }

struct Params {
  const float* nll;         // [U, T, B] bank emissions
  const float* init;        // [S]; K18: the carried frontier [B, S]
  const unsigned* rec;      // [S] packed records
  const float4* rows;       // [n_rows] band costs per bank row (.w unused)
  const float4* band_s;     // [S] per-state band costs (general mode), or null
  const int2* cross;        // [n_cx] (source state, cost bits)
  const int* word_starts;   // [R]
  const int* word_ends;     // [L]
  const float* eps;         // [R, eps_ld]: [R, L], or [R] where every row is one value
  const int* nf;            // [B]
  float* scratch;           // [B, 2, S + kPad] cost frontier (not on chip)
  int* tau_scratch;         // [B, 2, S + kPad] tau / org frontier (K6, K18; not on chip)
  float* final_cost;        // [B, S]
  int8_t* bp8;              // [T, B, S]
  void* eps_u;              // [T, B, R] int8 or int32
  int u_wide;
  int* eps_prev;            // [T, B, R]
  float* ends_cost;         // [T, B, L] (K6)
  int* ends_tau;            // [T, B, L] (K6)
  int* org_out;             // [B, S] K18's ancestor map (mode 3), or null
  long long* trace;         // [B, kPhases] or null
  int U, T, B, S, R, L, n_rows, n_cx, shift, gather, eps_ld;
  int tau_smem, eps_smem, rep, rep_shift;
  int mode, first;          // the C interface's mode; K18: frame 0 seeds from the carry
};

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) & ~(size_t)15; }
__host__ __device__ inline size_t frontier_row(int S) { return r16((size_t)(S + kPad) * 4); }

// Offsets of the CTA's shared-memory regions (0 bytes where a region lives
// in device memory); the wrapper's lex_smem_bytes mirrors the total.
struct Layout {
  size_t front, tau, codes, rec, cross, eps, rows, ends, endx, total;
};
__host__ __device__ inline Layout layout(int mode, int S, int n_eps, int L, int n_rows,
                                         int n_cx, int front, int tau, int tables, int eps,
                                         int gather, int rep) {
  Layout y;
  size_t o = 0;
  y.front = o;
  o += front ? 2 * frontier_row(S) : 0;
  y.tau = o;
  o += (has_tau(mode) && tau) ? 2 * frontier_row(S) : 0;
  y.codes = o;  // K4's and K18's codes of two frames, staged with an on-chip frontier
  o += (front && mode != kLatticeMode) ? 2 * r16((size_t)S) : 0;
  y.rec = o;
  o += tables ? r16((size_t)S * 4) : 0;
  y.cross = o;
  o += tables ? r16((size_t)n_cx * 8) : 0;
  y.eps = o;
  o += eps ? r16((size_t)n_eps * 4) : 0;
  y.rows = o;  // two frames' row tables, each row `rep` times
  o += 2 * r16((size_t)n_rows * rep * 16);
  y.ends = o;  // leaf-slot costs, then K4's eps_prev or K6's taus: scatter mode
  o += gather ? 0 : r16((size_t)L * 4);
  y.endx = o;
  o += gather ? 0 : r16((size_t)L * 4);
  y.total = o;
  return y;
}

template <bool kShared, typename T>
__device__ __forceinline__ T ldt(const T* p) {
  if constexpr (kShared)
    return *p;
  else
    return __ldg(p);
}

// Copy `bytes` (a multiple of 4) from device to shared memory with cp.async,
// 16 bytes at a time where both ends allow it.
__device__ __forceinline__ void stage(void* dst, const void* src, size_t bytes) {
  const bool wide = ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) == 0;
  const size_t n16 = wide ? bytes / 16 : 0;
  for (size_t i = threadIdx.x; i < n16; i += blockDim.x)
    cp_async16(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i);
  for (size_t i = 4 * n16 + threadIdx.x; i < bytes / 4; i += blockDim.x)
    cp_async4(static_cast<char*>(dst) + 4 * i, static_cast<const char*>(src) + 4 * i);
}

// (value, leaf index) lexicographic min: the first minimum in leaf order.
__device__ __forceinline__ void argmin_merge(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// One lane's first minimum of eps[r, l] + leaf(l) over its leaves l = lane,
// lane + 32, ...: four leaves' loads in flight per step, compared in leaf
// order (strict <).  kConstRow: the eps row is one value (er[0]).
template <bool kConstRow, typename Leaf>
__device__ __forceinline__ void scan_leaves(const float* er, const Leaf& leaf, int L, int lane,
                                            float& bv, int& bi) {
  const float ec = kConstRow ? er[0] : 0.f;
  int l = lane;
  for (; l + 96 < L; l += 128) {
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = (kConstRow ? ec : er[l + 32 * k]) + leaf(l + 32 * k);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c[k] < bv) {
        bv = c[k];
        bi = l + 32 * k;
      }
  }
  for (; l < L; l += 32) {
    const float c = (kConstRow ? ec : er[l]) + leaf(l);
    if (c < bv) {
      bv = c;
      bi = l;
    }
  }
}

// Where the graph tables come from (the kernel's third template argument):
// records and cross table through L1, the same staged in shared memory, or
// the general mode (records through L1 and per-state band rows band_s).
enum Tables { kTabL1 = 0, kTabSmem = 1, kTabGeneral = 2 };

// kFront: the cost frontier in shared memory (and, for K4, the frame's
// codes, staged there and copied out during the next frame); else both in
// device memory.  K6's tau frontier follows p.tau_smem.  kWide: two-word
// state records.  kRowsDev: no row tables; band costs and emissions are
// read through L1.
template <int kMode, bool kFront, int kTab, bool kWide, bool kRowsDev>
__global__ void __launch_bounds__(threads_for<kFront>(), 1) viterbi_lex_kernel(Params p) {
  constexpr int kThreads = threads_for<kFront>(), kWarps = kThreads / 32;
  constexpr bool kTablesSmem = kTab == kTabSmem;
  constexpr bool kLattice = kMode == kLatticeMode;
  constexpr bool kChunk = kMode == kChunkMode || kMode == kChunkOrgMode;
  // K18's ancestor map lives where K6 keeps tau
  constexpr bool org = kMode == kChunkOrgMode;
  constexpr bool tauf = kLattice || org;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout y = layout(p.mode, p.S, p.R * max(p.eps_ld, 1), p.L, p.n_rows, p.n_cx,
                          kFront, p.tau_smem, kTablesSmem, p.eps_smem, p.gather, p.rep);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int S = p.S, R = p.R, L = p.L, T = p.T;
  const unsigned mask = (1u << p.shift) - 1u;
  const unsigned leaf_bit = p.gather ? 0u : kLeaf;  // leaf slots written in scatter mode
  const size_t rowf = frontier_row(S) / 4;            // entries per frontier row

  float* fr = kFront ? reinterpret_cast<float*>(smem + y.front) : p.scratch + (size_t)b * 2 * rowf;
  float* cur = fr + kPad;
  float* nxt = fr + rowf + kPad;
  int* tf = nullptr;
  if (tauf)
    tf = p.tau_smem ? reinterpret_cast<int*>(smem + y.tau) : p.tau_scratch + (size_t)b * 2 * rowf;
  int* tcur = tauf ? tf + kPad : nullptr;
  int* tnxt = tauf ? tf + rowf + kPad : nullptr;
  const unsigned* rec = kTablesSmem ? reinterpret_cast<const unsigned*>(smem + y.rec) : p.rec;
  const int2* cross = kTablesSmem ? reinterpret_cast<const int2*>(smem + y.cross) : p.cross;
  const float* eps = p.eps_smem ? reinterpret_cast<const float*>(smem + y.eps) : p.eps;
  // row tables: row u's copy k at (u << rep_shift) + k, so the eight lanes
  // of a quarter warp (lane & 7 = k) read eight different bank groups
  float4* rows = reinterpret_cast<float4*>(smem + y.rows);
  const int n_rep = kRowsDev ? 0 : p.n_rows << p.rep_shift;  // kRowsDev: no copies, no prefetch
  const size_t rows_n = r16((size_t)n_rep * 16) / 16;  // float4 per row table
  const unsigned lane_rep = lane & ((1u << p.rep_shift) - 1u);
  float* ends = reinterpret_cast<float*>(smem + y.ends);
  // per leaf slot: K4 the state before the end's band step (its eps_prev
  // should a root take it), K6 its entry time
  int* endx = reinterpret_cast<int*>(smem + y.endx);
  int8_t* codes = reinterpret_cast<int8_t*>(smem + y.codes);  // [2][S] (K4, kFront)
  const size_t codes_n = r16((size_t)S);
  // state v's record: its bank row, its link (cross entry or leaf slot)
  // and, in bit 31 of lf, the leaf mark
  struct Rec {
    unsigned row, link, lf;
  };
  const auto rec_at = [&](int v) -> Rec {
    if constexpr (kWide) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p.rec) + v);
      return {r.x, r.y & ~kLeaf, r.y};
    } else {
      const unsigned rc = ldt<kTablesSmem>(rec + v);
      return {rc & mask, (rc & ~kLeaf) >> p.shift, rc};
    }
  };
  // bank row u's band costs (.xyz) and frame t's emission (.w), from the
  // frame's row table rw, else read where they lie
  const auto row_at = [&](const float4* rw, unsigned u, int t) -> float4 {
    if constexpr (kRowsDev) {
      float4 v = __ldg(p.rows + u);
      v.w = fminf(__ldg(p.nll + ((size_t)u * T + t) * p.B + b), SRT_POS_INF);
      return v;
    } else {
      return rw[(u << p.rep_shift) | lane_rep];
    }
  };

  // ---- set-up: tables, row tables, frontier padding, frame 0's emissions
  if (kTablesSmem) {
    stage(smem + y.rec, p.rec, (size_t)S * 4);
    stage(smem + y.cross, p.cross, (size_t)p.n_cx * 8);
  }
  if (p.eps_smem) stage(smem + y.eps, p.eps, (size_t)R * max(p.eps_ld, 1) * 4);
  for (int i = tid; i < n_rep; i += kThreads) {
    const float4 v = __ldg(p.rows + (i >> p.rep_shift));
    for (int k = 0; k < 2; ++k) {  // .w is the emission slot, written by cp.async
      rows[k * rows_n + i].x = v.x;
      rows[k * rows_n + i].y = v.y;
      rows[k * rows_n + i].z = v.z;
    }
  }
  for (int i = tid; i < kPad; i += kThreads) {
    fr[i] = SRT_POS_INF;
    fr[rowf + i] = SRT_POS_INF;
    if (tauf) {
      tf[i] = 0;
      tf[rowf + i] = 0;
    }
  }
  if (kChunk)  // the carried frontier, and each state its own ancestor
    for (int v = tid; v < S; v += kThreads) {
      cur[v] = __ldg(p.init + (size_t)b * S + v);
      if (org) tcur[v] = v;
    }
  // frame t's emissions -> the .w lanes of row table t & 1; each thread
  // clamps its own rows to POS_INF once they have landed
  auto prefetch = [&](int t) {
    float* dst = reinterpret_cast<float*>(rows + (t & 1) * rows_n);
    for (int i = tid; i < n_rep; i += kThreads)
      cp_async4(dst + 4 * i + 3, p.nll + ((size_t)(i >> p.rep_shift) * T + t) * p.B + b);
    cp_async_commit();
  };
  auto landed = [&](int t) {
    cp_async_wait_all();
    float* dst = reinterpret_cast<float*>(rows + (t & 1) * rows_n);
    for (int i = tid; i < n_rep; i += kThreads)
      dst[4 * i + 3] = fminf(dst[4 * i + 3], SRT_POS_INF);
  };
  // K4 with the codes staged: frame t's codes row -> bp8, in words of the
  // widest size that divides S (every row then starts aligned)
  auto flush_codes = [&](int t) {
    const int8_t* src = codes + (t & 1) * codes_n;
    int8_t* dst = p.bp8 + ((size_t)t * p.B + b) * S;
    if ((S & 15) == 0) {
      for (int i = tid; i < S / 16; i += kThreads)
        reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    } else if ((S & 3) == 0) {
      for (int i = tid; i < S / 4; i += kThreads)
        reinterpret_cast<int*>(dst)[i] = reinterpret_cast<const int*>(src)[i];
    } else {
      for (int i = tid; i < S; i += kThreads) dst[i] = src[i];
    }
  };
  constexpr bool kStaged = kFront && !kLattice;
  const int nfb = p.nf[b];
  // K4 stops at the stream's length; the lattice runs frame 0 always; K18
  // runs every frame (the carry freezes at t >= nf)
  const int n = kChunk ? T : (kLattice ? max(min(nfb, T), 1) : min(nfb, T));
  if (n > 0) prefetch(0);
  landed(0);
  __syncthreads();
  // the start state and bank row of this warp's first root (each warp
  // keeps its roots for every frame)
  const int start0 = warp < R ? __ldg(p.word_starts + warp) : 0;
  const unsigned row0 = rec_at(start0).row;

  long long tr[kPhases] = {0, 0, 0, 0, 0, 0};
  long long tc = clock64();
  auto mark = [&](int ph) {
    if (p.trace) {
      const long long now = clock64();
      tr[ph] += now - tc;
      tc = now;
    }
  };

  for (int t = 0; t < n; ++t) {
    if (t + 1 < n) prefetch(t + 1);  // lands while this frame computes
    if (kStaged && t > 0) flush_codes(t - 1);
    const float4* rw = rows + (t & 1) * rows_n;
    int8_t* code = kStaged ? codes + (t & 1) * codes_n
                           : (kLattice ? nullptr : p.bp8 + ((size_t)t * p.B + b) * S);

    // (a) band select, cross edge, emission; leaf ends into their slots;
    // frame 0 seeds from init (K18: from the carry, or runs the band step)
    if (t == 0 && (!kChunk || p.first)) {
      for (int v = tid; v < S; v += kThreads) {
        const Rec rc = rec_at(v);
        const float val =
            fminf((kChunk ? cur[v] : __ldg(p.init + v)) + row_at(rw, rc.row, t).w, SRT_POS_INF);
        nxt[v] = val;
        if (kLattice)
          tnxt[v] = 0;
        else
          code[v] = 0;
        if (org) tnxt[v] = v;
        if (rc.lf & leaf_bit) {
          ends[rc.link] = val;
          endx[rc.link] = kLattice ? 0 : v;
        }
      }
    } else if constexpr (tauf) {
      // K6 and K18 with the map: one state a thread at a time (runs of four
      // measured slower for K6, 2.398 against 2.297 ms at 128 x 500 on the
      // 1k trie, scripts/exp_r16_chunk_dp.py --regress: a run's second
      // frontier is gathered a state at a time, tcur[from])
      for (int v = tid; v < S; v += kThreads) {
        const Rec rc = rec_at(v);
        float4 bd = row_at(rw, rc.row, t);
        if (kTab == kTabGeneral) {
          const float4 g = __ldg(p.band_s + v);
          bd.x = g.x;
          bd.y = g.y;
          bd.z = g.z;
        }
        const float a0 = bd.x + cur[v], a1 = bd.y + cur[v - 1], a2 = bd.z + cur[v - 2];
        float base = SRT_POS_INF;
        int d = 0;
        if (a0 <= base) { base = a0; d = 0; }
        if (a1 <= base) { base = a1; d = 1; }
        if (a2 <= base) { base = a2; d = 2; }
        // every state reads a cross pair: its own, else the default (entry
        // 0; a leaf slot's link is no cross entry), so no branch diverges
        const int2 e = ldt<kTablesSmem>(cross + ((rc.lf & kLeaf) ? 0u : rc.link));
        const int src = e.x;
        const float cc = fminf(cur[src] + __int_as_float(e.y), SRT_POS_INF);
        const bool crossed = cc <= base;
        const int from = crossed ? src : v - d;  // K6: whose entry time carries over
        if (crossed) {
          base = cc;
          d = kCrossCode;
        }
        const int tv = tcur[from];
        const float val = fminf(base + bd.w, SRT_POS_INF);
        nxt[v] = val;
        tnxt[v] = tv;
        if (!kLattice) code[v] = (int8_t)d;
        if (rc.lf & leaf_bit) {
          ends[rc.link] = val;
          endx[rc.link] = kLattice ? tv : v - d;
        }
      }
    } else {
      // K4 and K18 without the map: runs of four consecutive states a
      // thread.  One 16-byte load of the carried costs at v0..v0+3 and one
      // 8-byte load of v0-2, v0-1 (POS_INF in front of the row) give every
      // band candidate; the run's costs go out as one 16-byte store, the
      // staged codes as one word.  A row holds S rounded up to 4 entries, so
      // the last run stays inside it; its states past S read record 0 and
      // write only into that padding.
      for (int v0 = 4 * tid; v0 < S; v0 += 4 * kThreads) {
        const float4 c4 = *reinterpret_cast<const float4*>(cur + v0);
        const float2 h = *reinterpret_cast<const float2*>(cur + v0 - 2);
        const float cm[6] = {h.x, h.y, c4.x, c4.y, c4.z, c4.w};  // cur[v0 - 2 + i]
        Rec rcs[4];
        if constexpr (kTablesSmem) {
          if (v0 + 4 <= S) {  // the staged records: one 16-byte load
            const uint4 r4 = *reinterpret_cast<const uint4*>(rec + v0);
            const unsigned rr[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) rcs[k] = {rr[k] & mask, (rr[k] & ~kLeaf) >> p.shift, rr[k]};
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) rcs[k] = v0 + k < S ? rec_at(v0 + k) : Rec{0u, 0u, 0u};
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) rcs[k] = v0 + k < S ? rec_at(v0 + k) : Rec{0u, 0u, 0u};
        }
        float val[4];
        int dd[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int v = v0 + k;
          const Rec rc = rcs[k];
          float4 bd = row_at(rw, rc.row, t);
          if (kTab == kTabGeneral) {
            const float4 g = v < S ? __ldg(p.band_s + v) : make_float4(0.f, 0.f, 0.f, 0.f);
            bd.x = g.x;
            bd.y = g.y;
            bd.z = g.z;
          }
          const float a0 = bd.x + cm[k + 2], a1 = bd.y + cm[k + 1], a2 = bd.z + cm[k];
          float base = SRT_POS_INF;
          int d = 0;
          if (a0 <= base) { base = a0; d = 0; }
          if (a1 <= base) { base = a1; d = 1; }
          if (a2 <= base) { base = a2; d = 2; }
          // every state reads a cross pair: its own, else the default (entry
          // 0; a leaf slot's link is no cross entry), so no branch diverges
          const int2 e = ldt<kTablesSmem>(cross + ((rc.lf & kLeaf) ? 0u : rc.link));
          const int src = e.x;
          const float cc = fminf(cur[src] + __int_as_float(e.y), SRT_POS_INF);
          if (cc <= base) {
            base = cc;
            d = kCrossCode;
          }
          val[k] = fminf(base + bd.w, SRT_POS_INF);
          dd[k] = d;
          if (rc.lf & leaf_bit) {
            ends[rc.link] = val[k];
            endx[rc.link] = v - d;
          }
        }
        *reinterpret_cast<float4*>(nxt + v0) = make_float4(val[0], val[1], val[2], val[3]);
        if constexpr (kStaged) {  // the staged codes row holds S rounded up to 16
          *reinterpret_cast<unsigned*>(code + v0) =
              (unsigned)(dd[0] & 255) | ((unsigned)(dd[1] & 255) << 8) |
              ((unsigned)(dd[2] & 255) << 16) | ((unsigned)(dd[3] & 255) << 24);
        } else {  // straight to the plane: no byte past S
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (v0 + k < S) code[v0 + k] = (int8_t)dd[k];
        }
      }
    }
    mark(0);
    __syncthreads();  // barrier A: the band phase's frontier, codes and leaf slots
    mark(1);

    // (b) K6's planes: the leaf ends, which the eps pass does not change
    // (starts and ends are disjoint)
    if (kLattice) {
      const size_t o = ((size_t)t * p.B + b) * L;
      for (int l = tid; l < L; l += kThreads) {
        if (p.gather) {
          const int e = __ldg(p.word_ends + l);
          p.ends_cost[o + l] = nxt[e];
          p.ends_tau[o + l] = tnxt[e];
        } else {
          p.ends_cost[o + l] = ends[l];
          p.ends_tau[o + l] = endx[l];
        }
      }
    }
    // (c) leaf -> root re-entry: warp w reduces roots w, w + kWarps, ...
    // over every leaf and applies the result to the root's start
    for (int r = warp; r < R; r += kWarps) {
      const float* er = eps + (size_t)r * max(p.eps_ld, 1);
      float bv = INFINITY;
      int bi = INT_MAX;
      if (p.gather) {
        const auto leaf = [&](int l) { return nxt[__ldg(p.word_ends + l)]; };
        if (p.eps_ld)
          scan_leaves<false>(er, leaf, L, lane, bv, bi);
        else
          scan_leaves<true>(er, leaf, L, lane, bv, bi);
      } else {
        const auto leaf = [&](int l) { return ends[l]; };
        if (p.eps_ld)
          scan_leaves<false>(er, leaf, L, lane, bv, bi);
        else
          scan_leaves<true>(er, leaf, L, lane, bv, bi);
      }
      mark(2);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, bv, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
        argmin_merge(bv, bi, v2, i2);
      }
      mark(3);
      if (lane == 0) {
        const int start = r == warp ? start0 : __ldg(p.word_starts + r);
        const unsigned row = r == warp ? row0 : rec_at(start).row;
        const float cand = fminf(bv + row_at(rw, row, t).w, SRT_POS_INF);
        int uo = 0, pp = 0;
        if (cand < nxt[start]) {  // strict improvement only
          nxt[start] = cand;
          if (kLattice) {
            tnxt[start] = t;
          } else {
            uo = bi;
            if (p.gather) {
              const int end = __ldg(p.word_ends + bi);
              pp = end - code[end];  // the band code, written in (a)
            } else {
              pp = endx[bi];
            }
            code[start] = kEpsCode;
            if (org) tnxt[start] = tnxt[__ldg(p.word_ends + bi)];  // no start is an end
          }
        }
        if (!kLattice) {
          const size_t o = ((size_t)t * p.B + b) * R + r;
          if (p.u_wide)
            static_cast<int*>(p.eps_u)[o] = uo;
          else
            static_cast<int8_t*>(p.eps_u)[o] = (int8_t)uo;
          p.eps_prev[o] = pp;
        }
      }
    }
    mark(4);
    if (t + 1 < n) landed(t + 1);  // the next frame's emissions
    __syncthreads();               // barrier B: the applied starts, the next row table
    mark(5);

    if (!kChunk || t < nfb) {  // K18: the carry moves on only for valid frames
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (tauf) {
        int* ttmp = tcur;
        tcur = tnxt;
        tnxt = ttmp;
      }
    }
  }
  if (kStaged && n > 0) flush_codes(n - 1);
  bool has_final = n > 0;
  if (kLattice) {
    // frames past the stream's length repeat its last frame
    const size_t rest = (size_t)(T - n) * L;
    for (size_t i = tid; i < rest; i += kThreads) {
      const int t = n + (int)(i / L), l = (int)(i % L);
      const int e = __ldg(p.word_ends + l);
      const size_t o = ((size_t)t * p.B + b) * L + l;
      p.ends_cost[o] = cur[e];
      p.ends_tau[o] = tcur[e];
    }
    has_final = nfb >= 1 && nfb <= T;
  }
  if (kChunk) has_final = true;
  for (int v = tid; v < S; v += kThreads) {
    p.final_cost[(size_t)b * S + v] = has_final ? cur[v] : SRT_POS_INF;
    if (org) p.org_out[(size_t)b * S + v] = tcur[v];
  }
  if (p.trace && tid == 0)
    for (int k = 0; k < kPhases; ++k) p.trace[(size_t)b * kPhases + k] = tr[k];
}

template <int kMode, bool kFront, int kTab, bool kWide, bool kRowsDev>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  constexpr int kThreads = threads_for<kFront>();
  auto kernel = viterbi_lex_kernel<kMode, kFront, kTab, kWide, kRowsDev>;
  SRT_SET_SMEM(kernel, smem);
  // carve out the CTA's shared memory and no more: the rest of the SM's
  // 256 KB stays L1, which serves what is read from device memory
  const int pct = (int)((smem * 100 + SRT_MAX_SMEM - 1) / SRT_MAX_SMEM);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct < 100 ? pct : 100);
  if (e != cudaSuccess) return (int)e;
  kernel<<<p.B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The wide records and the plan without row tables read their tables
// through L1 (no kTabSmem instance) and keep the frontier in device memory.
template <int kMode, bool kFront, bool kWide, bool kRowsDev>
int launch_tables(const Params& p, int tab, size_t smem, cudaStream_t s) {
  if (tab == kTabGeneral) return launch<kMode, kFront, kTabGeneral, kWide, kRowsDev>(p, smem, s);
  if (tab == kTabSmem) {
    if constexpr (!kWide && !kRowsDev) return launch<kMode, kFront, kTabSmem, false, false>(p, smem, s);
    return (int)cudaErrorInvalidValue;
  }
  return launch<kMode, kFront, kTabL1, kWide, kRowsDev>(p, smem, s);
}

template <int kMode>
int launch_plan(const Params& p, int wide, int front, int tab, cudaStream_t s) {
  const size_t smem = layout(p.mode, p.S, p.R * max(p.eps_ld, 1), p.L, p.n_rows, p.n_cx,
                             front, p.tau_smem, tab == kTabSmem, p.eps_smem, p.gather,
                             p.rep).total;
  if (wide)
    return p.rep ? launch_tables<kMode, false, true, false>(p, tab, smem, s)
                 : launch_tables<kMode, false, true, true>(p, tab, smem, s);
  if (!p.rep) return launch_tables<kMode, false, false, true>(p, tab, smem, s);
  return front ? launch_tables<kMode, true, false, false>(p, tab, smem, s)
               : launch_tables<kMode, false, false, false>(p, tab, smem, s);
}

}  // namespace

// Shared memory of one CTA for a plan (the wrapper's lex_smem_bytes
// computes the same sum; the card tests hold the two equal).
extern "C" int viterbi_lex_smem_bytes(int mode, int S, int n_eps, int L, int n_rows,
                                      int n_cx, int front, int tau, int tables, int eps,
                                      int gather, int rep) {
  const size_t n =
      layout(mode, S, n_eps, L, n_rows, n_cx, front, tau, tables, eps, gather, rep).total;
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
}

// K4 (mode 0), K6 (mode 1) or K18 (mode 2; 3 with the ancestor map).
// nll [U, T, B]; init [S] (K18: the carried frontier [B, S], and `first`:
// frame 0 seeds from it); rec [S]
// packed records (wide: [S] uint2, bank row and link, shift 0); rows
// [n_rows] float4 band costs per bank row; band_s [S]
// float4 per-state band costs or null; cross [n_cx] int2 (source, cost
// bits), entry 0 the pair of every state without its own; word_starts
// [R]; word_ends [L]; eps [R, eps_ld] (eps_ld = L, or 0 where each row is
// one value, stored once); nf [B].  K4 writes
// final [B, S], bp8 [T, B, S], eps_u [T, B, R] (int32 when u_wide) and
// eps_prev [T, B, R]; K6 final, ends_cost and ends_tau [T, B, L]; K18 what K4
// writes (every frame's planes, final = the carry) and, in mode 3, org
// [B, S].  scratch / tau_scratch: [B, 2, S + 4] where the frontier / tau
// (K18: ancestor) frontier is not in shared memory (front / tau = 0).  trace: null, or [B, 6] int64 cycles per
// phase of the frame steps (band, barrier, eps scan, warp reduction, apply,
// barrier).  rep: copies of each bank row in the row tables (8 or 1), or 0
// for none (frontier and tables then in device memory).
extern "C" int viterbi_lex_launch(
    int mode, const float* nll, const float* init, const unsigned* rec, const void* rows,
    const void* band_s, const void* cross, const int* word_starts, const int* word_ends,
    const float* eps, const int* nf, int first, float* scratch, int* tau_scratch,
    float* final_cost, int8_t* bp8, void* eps_u, int u_wide, int* eps_prev, float* ends_cost,
    int* ends_tau, int* org_out, long long* trace, int U, int T, int B, int S, int R, int L,
    int n_rows, int n_cx, int shift, int wide, int eps_ld, int front, int tau, int tables,
    int eps_smem, int gather, int rep, void* stream) {
  const int lattice = mode == kLatticeMode;
  if (mode < 0 || mode > 3 || B <= 0 || T < 0 || S <= 0 || R <= 0 || L <= 0 || U <= 0 ||
      n_rows <= 0 || n_rows > U || n_cx < 1 || (wide ? shift != 0 : (shift < 1 || shift > 30)) ||
      (eps_ld != 0 && eps_ld != L) ||
      (!front && scratch == nullptr) || (lattice && T <= 0) ||
      (has_tau(mode) && !tau && tau_scratch == nullptr) || (band_s && tables) ||
      (rep != 0 && rep != 1 && rep != 8) || ((mode == 3) != (org_out != nullptr)) ||
      ((wide || rep == 0) && (front || tables)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.nll = nll; p.init = init; p.rec = rec;
  p.rows = static_cast<const float4*>(rows);
  p.band_s = static_cast<const float4*>(band_s);
  p.cross = static_cast<const int2*>(cross);
  p.word_starts = word_starts; p.word_ends = word_ends; p.eps = eps; p.nf = nf;
  p.scratch = scratch; p.tau_scratch = tau_scratch; p.final_cost = final_cost;
  p.bp8 = bp8; p.eps_u = eps_u; p.u_wide = u_wide; p.eps_prev = eps_prev;
  p.ends_cost = ends_cost; p.ends_tau = ends_tau; p.org_out = org_out; p.trace = trace;
  p.mode = mode; p.first = first;
  p.U = U; p.T = T; p.B = B; p.S = S; p.R = R; p.L = L;
  p.n_rows = n_rows; p.n_cx = n_cx; p.shift = shift; p.gather = gather; p.eps_ld = eps_ld;
  p.tau_smem = has_tau(mode) ? tau : 0; p.eps_smem = eps_smem; p.rep = rep;
  p.rep_shift = rep == 8 ? 3 : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tab = band_s ? kTabGeneral : (tables ? kTabSmem : kTabL1);
  if (mode == kChunkOrgMode) return launch_plan<kChunkOrgMode>(p, wide, front, tab, s);
  if (mode == kChunkMode) return launch_plan<kChunkMode>(p, wide, front, tab, s);
  return lattice ? launch_plan<kLatticeMode>(p, wide, front, tab, s)
                 : launch_plan<kLexFwd>(p, wide, front, tab, s);
}
