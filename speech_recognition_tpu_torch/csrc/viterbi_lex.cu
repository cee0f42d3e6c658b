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
//            word_ends[l*] - code(word_ends[l*]), the code read before the
//            eps pass (a leaf end never carries a cross or eps code: units
//            have >= 2 states).  The eps pass also runs at frame 0.
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
// (leaf-slot order); no bp8 or eps planes.  The eps pass keeps K4's
// reduction; the lattice needs only its minimum.
//
// What bounds K4 on the H100: latency of the serial frame loop.  One CTA
// owns one stream for all T frames (128 CTAs at B = 128 on 132 SMs, only
// __syncthreads between phases).  Per frame a CTA reads band (3S f32),
// bank_state, cross_src, cross_cost (S each) and the [R, L] eps block
// through L1/L2: ~270 KB per frame at 9.6k states, so L2 bandwidth per SM
// and three barriers per frame set the time; the FLOPs are negligible and
// the bp8 store (S bytes per frame and stream) is far below HBM bandwidth.
//
// What the design does about it: the frontier is double-buffered in a
// [B, 2, S] device-memory scratch that stays L2-resident (22 MB at 32 x 87k
// states), so one kernel serves every graph size (a shared-memory frontier
// timed the same on the 1k trie); the frame's U emissions are staged in
// shared memory; the per-root first-minimum is a warp-shuffle (value,
// index) reduction, 64 roots per pass.  Staging or packing the constant
// arrays is left to a later change.
//
// K6 has K4's bounds and design; it swaps the S-byte bp8 row for a 4S-byte
// tau row per frame in the scratch and writes 8L bytes of planes per
// frame and stream instead of S + 5R.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBand = 2;
constexpr int kCrossCode = kMaxBand + 1;
constexpr int kEpsCode = kMaxBand + 2;
constexpr int kRootChunk = 64;  // roots reduced per pass

struct Params {
  const float* nll;         // [U, T, B] bank emissions
  const float* band;        // [3, S]
  const float* init;        // [S]
  const int* bank_state;    // [S]
  const int* cross_src;     // [S]
  const float* cross_cost;  // [S] (POS_INF where no cross edge)
  const int* word_starts;   // [R]
  const int* word_ends;     // [L]
  const float* eps;         // [R, L]
  const int* nf;            // [B]
  float* scratch;           // [B, 2, S] double-buffered frontier
  float* final_cost;        // [B, S]
  int8_t* bp8;              // [T, B, S]
  void* eps_u;              // [T, B, R] int8 or int32
  int u_wide;
  int* eps_prev;            // [T, B, R]
  // lattice mode (K6)
  int* tau_scratch;         // [B, 2, S] double-buffered entry times
  float* ends_cost;         // [T, B, L]
  int* ends_tau;            // [T, B, L]
  int U, T, B, S, R, L;
};

// Dynamic shared memory of one CTA; the layout is the carve-up at the top
// of the kernel.
size_t smem_bytes(int U, int R) {
  const int rc = R < kRootChunk ? R : kRootChunk;
  return (size_t)U * sizeof(float) +
         (size_t)rc * kWarps * (sizeof(float) + sizeof(int));
}

// (value, leaf index) lexicographic min: the first minimum in leaf order.
__device__ __forceinline__ void argmin_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

template <bool kLattice>
__global__ void __launch_bounds__(kThreads, 1) viterbi_lex_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rc = p.R < kRootChunk ? p.R : kRootChunk;
  float* en = reinterpret_cast<float*>(smem_raw);  // [U] this frame
  float* red_v = en + p.U;                         // [rc][kWarps]
  int* red_i = reinterpret_cast<int*>(red_v + rc * kWarps);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  float* cur = p.scratch + (size_t)b * 2 * p.S;
  float* nxt = cur + p.S;
  int* tcur = kLattice ? p.tau_scratch + (size_t)b * 2 * p.S : nullptr;
  int* tnxt = kLattice ? tcur + p.S : nullptr;
  const int nf = p.nf[b];
  // K4 stops at the stream's length; the lattice runs frame 0 always
  const int n = kLattice ? max(min(nf, p.T), 1) : min(nf, p.T);

  for (int t = 0; t < n; ++t) {
    // (A) this frame's bank emissions
    for (int u = tid; u < p.U; u += kThreads)
      en[u] = fminf(__ldg(p.nll + ((size_t)u * p.T + t) * p.B + b),
                    SRT_POS_INF);
    __syncthreads();

    // (B) band select, cross edge, emission
    int8_t* bp_row = kLattice ? nullptr : p.bp8 + ((size_t)t * p.B + b) * p.S;
    for (int v = tid; v < p.S; v += kThreads) {
      float base;
      int8_t d = 0;
      int tv = 0;  // entry time (lattice mode)
      if (t == 0) {
        base = __ldg(p.init + v);
      } else {
        base = SRT_POS_INF;
#pragma unroll
        for (int dd = 0; dd <= kMaxBand; ++dd) {
          const float c = __ldg(p.band + dd * p.S + v) +
                          (v >= dd ? cur[v - dd] : SRT_POS_INF);
          if (c <= base) {
            base = c;
            d = dd;
          }
        }
        if (kLattice) tv = v >= d ? tcur[v - d] : 0;
        const int cs = __ldg(p.cross_src + v);
        const float cc = fminf(cur[cs] + __ldg(p.cross_cost + v), SRT_POS_INF);
        if (cc <= base) {
          base = cc;
          d = kCrossCode;
          if (kLattice) tv = tcur[cs];
        }
      }
      nxt[v] = fminf(base + en[__ldg(p.bank_state + v)], SRT_POS_INF);
      if (kLattice)
        tnxt[v] = tv;
      else
        bp_row[v] = d;
    }
    __syncthreads();

    // (C) leaf -> root epsilon re-entry, kRootChunk roots per pass (starts
    // and ends are disjoint, so reading ends and writing starts never race)
    for (int r0 = 0; r0 < p.R; r0 += kRootChunk) {
      const int rn = min(kRootChunk, p.R - r0);
      for (int rr = 0; rr < rn; ++rr) {
        const float* row = p.eps + (size_t)(r0 + rr) * p.L;
        float bv = INFINITY;
        int bi = INT_MAX;
        for (int l = tid; l < p.L; l += kThreads) {
          const float c = __ldg(row + l) + nxt[__ldg(p.word_ends + l)];
          if (c < bv) {  // strict: first minimum among this thread's leaves
            bv = c;
            bi = l;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float v2 = __shfl_xor_sync(0xffffffffu, bv, off);
          const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
          argmin_merge(bv, bi, v2, i2);
        }
        if (lane == 0) {
          red_v[rr * kWarps + warp] = bv;
          red_i[rr * kWarps + warp] = bi;
        }
      }
      __syncthreads();
      for (int rr = tid; rr < rn; rr += kThreads) {
        float bv = red_v[rr * kWarps];
        int bi = red_i[rr * kWarps];
        for (int w = 1; w < kWarps; ++w)
          argmin_merge(bv, bi, red_v[rr * kWarps + w], red_i[rr * kWarps + w]);
        const int r = r0 + rr;
        const int start = __ldg(p.word_starts + r);
        const float cand =
            fminf(bv + en[__ldg(p.bank_state + start)], SRT_POS_INF);
        int uo = 0, pp = 0;
        if (cand < nxt[start]) {  // strict improvement only
          nxt[start] = cand;
          if (kLattice) {
            tnxt[start] = t;
          } else {
            const int end = __ldg(p.word_ends + bi);
            uo = bi;
            pp = end - bp_row[end];  // band code, written in (B)
            bp_row[start] = kEpsCode;
          }
        }
        if (kLattice) continue;
        const size_t o = ((size_t)t * p.B + b) * p.R + r;
        if (p.u_wide)
          static_cast<int*>(p.eps_u)[o] = uo;
        else
          static_cast<int8_t*>(p.eps_u)[o] = (int8_t)uo;
        p.eps_prev[o] = pp;
      }
      __syncthreads();
    }

    // (D) lattice planes: the leaf ends after the eps pass (starts and
    // ends are disjoint, so the pass did not change them)
    if (kLattice) {
      const size_t o = ((size_t)t * p.B + b) * p.L;
      for (int l = tid; l < p.L; l += kThreads) {
        const int e = __ldg(p.word_ends + l);
        p.ends_cost[o + l] = nxt[e];
        p.ends_tau[o + l] = tnxt[e];
      }
      int* ttmp = tcur;
      tcur = tnxt;
      tnxt = ttmp;
    }

    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  bool has_final = n > 0;
  if (kLattice) {
    // frames past the stream's length repeat its last frame
    const size_t rest = (size_t)(p.T - n) * p.L;
    for (size_t i = tid; i < rest; i += kThreads) {
      const int t = n + (int)(i / p.L), l = (int)(i % p.L);
      const int e = __ldg(p.word_ends + l);
      const size_t o = ((size_t)t * p.B + b) * p.L + l;
      p.ends_cost[o] = cur[e];
      p.ends_tau[o] = tcur[e];
    }
    has_final = nf >= 1 && nf <= p.T;
  }
  for (int v = tid; v < p.S; v += kThreads)
    p.final_cost[(size_t)b * p.S + v] = has_final ? cur[v] : SRT_POS_INF;
}

}  // namespace

extern "C" int viterbi_lex_smem_bytes(int U, int R) {
  const size_t n = smem_bytes(U, R);
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
}

extern "C" int viterbi_lex_launch(
    const float* nll, const float* band, const float* init,
    const int* bank_state, const int* cross_src, const float* cross_cost,
    const int* word_starts, const int* word_ends, const float* eps,
    const int* nf, float* scratch, float* final_cost, int8_t* bp8,
    void* eps_u, int u_wide, int* eps_prev, int U, int T, int B, int S, int R,
    int L, void* stream) {
  if (B <= 0 || T < 0 || S <= 0 || R <= 0 || L <= 0 || U <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{nll, band, init, bank_state, cross_src, cross_cost, word_starts,
           word_ends, eps, nf, scratch, final_cost, bp8, eps_u, u_wide,
           eps_prev, nullptr, nullptr, nullptr, U, T, B, S, R, L};
  const size_t smem = smem_bytes(U, R);
  SRT_SET_SMEM(viterbi_lex_kernel<false>, smem);
  viterbi_lex_kernel<false><<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int viterbi_lattice_launch(
    const float* nll, const float* band, const float* init,
    const int* bank_state, const int* cross_src, const float* cross_cost,
    const int* word_starts, const int* word_ends, const float* eps,
    const int* nf, float* scratch, int* tau_scratch, float* final_cost,
    float* ends_cost, int* ends_tau, int U, int T, int B, int S, int R, int L,
    void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || R <= 0 || L <= 0 || U <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{nll, band, init, bank_state, cross_src, cross_cost, word_starts,
           word_ends, eps, nf, scratch, final_cost, nullptr, nullptr, 0,
           nullptr, tau_scratch, ends_cost, ends_tau, U, T, B, S, R, L};
  const size_t smem = smem_bytes(U, R);
  SRT_SET_SMEM(viterbi_lex_kernel<true>, smem);
  viterbi_lex_kernel<true><<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
