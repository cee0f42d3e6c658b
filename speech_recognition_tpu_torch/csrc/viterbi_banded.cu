// Banded Viterbi forward over composed word graphs, in three template modes
// of one kernel:
//
// K1 (kFused): fused GMM emission + banded Viterbi forward over a uniform
// composed word graph (V words of W states, slot-major; eps depth 1).
// Replaces the TPU kernel speech_recognition_tpu/ops/viterbi_banded_pallas.py
// _kernel with fuse_emission=True, emit_eps_prev=True (reached through
// viterbi_banded_tb_pallas from decode/connected._decode_banded_batch).
//
// K8 (kGeneral): the same forward on unit-bank emissions over ANY banded
// graph without cross edges, with any eps depth.  Replaces _kernel with
// bank_input=True, fuse_emission=False, emit_eps_prev=False (the form
// _decode_banded_batch takes for graphs the fused form refuses: 1-state
// words, words of different lengths, transcript graphs).
//
// K10 (kWordtrace): K1's fused emission and uniform graph with an int32
// entry-time frontier instead of the backpointer plane.  Replaces
// _kernel(emit_wordtrace=True) (viterbi_banded_wordtrace_pallas, the
// backend="wordtrace" decode).
//
// Per frame t and stream b:
//   emission   K1/K10: nll[u] = -(log sum_m exp(lw[u,m] - w[u,m,:] . xa[:,t,b]
//              - zmax) + zmax), mixtures in blocks of kMixChunk with a running
//              max; K8: nll[u] = min(nll_in[u,t,b], POS_INF)
//   band       best = min_d band[d,s] + cost[s-d] (d = 0, 1, 2; the largest d
//              wins ties); frame 0 seeds from init with d = 0.  K1/K10 take
//              the min-chain with the code read off afterwards; K8 takes the
//              plain version's _select_band (start at POS_INF, replace on
//              <=), which keeps d = 0 where every candidate is above POS_INF
//   emission   cost[s] = min(best + nll[bank_state[s]], POS_INF)
//   eps        per word r: first-minimum origin u of eps[r,u] + cost[end(u)]
//              over the row's finite span (strict <); the start state takes
//              it only if strictly better.  K1/K10: one pass, ends and
//              starts disjoint; K1 records eps_prev = end(u) - d_end(u).
//              K8: eps_depth passes, each reading the end costs the previous
//              pass left (a 1-state word's start is its end, so a state
//              entered in pass k is an origin in pass k+1); candidates are
//              computed for every word before any start is written; bp8
//              holds the eps code if any pass improved the state and eps_u
//              the origin of the last pass that did
//   word trace K10: tau follows the band winner (tau[s-d]; 0 at frame 0); an
//              eps improvement sets tau[start] = t and records the origin
//              end's tau (before the pass) into eps_tau
//   mask       K1/K10: t >= nf[b] freezes cost (and tau); frame 0 of an empty
//              stream gives POS_INF (tau 0); final = carry after the last
//              frame.  K8 (the plain version's scan): frame 0 is never
//              masked, frames t >= 1 with t >= nf freeze the carry, and
//              final = carry after frame nf-1 for 1 <= nf <= T, else POS_INF.
// Outputs in original state numbering: final [S,B] f32; K1/K8: bp8 [T,S,B] i8
// (band code or 4 = eps), eps_u [T,R,B] (i8, i32 when L > 127); K1: eps_prev
// [T,R,B] i32; K10: eps_u, eps_tau [T,R,B] i32, final_tau [S,B] i32.  Every
// frame's planes are written, frozen frames included.
//
// Arithmetic.  K10 rounds each product and each sum of the emission apart
// (__fmul_rn / __fadd_rn, also in the running logsumexp), in the order of
// its plain version, so that the plain version, which PyTorch runs one
// rounded operation at a time, is bit-identical to it.  K1 keeps fused
// multiply-adds (its plain version uses a GEMM and is held at rtol 1e-5).
// K8's costs are sums and minima only, so it is bit-identical to the plain
// scan on the same emissions.
//
// What bounds it on the H100: at B=512, T=500, S=385 the emission GEMM is
// ~8.9 GFLOP (~0.13 ms of f32 FMA) and the planes are ~280 MB of traffic
// (~0.08 ms at 3.35 TB/s), but the real bound is latency: T dependent
// frame steps, each a few barrier-separated passes over a tile of streams.
// K8 adds two barriers per eps pass (six passes on a 7-slot sausage of
// 1-state words); K10 a tau load and store per state.
//
// What the design does about it: one CTA owns a tile of TB streams for all
// T frames, so the whole recursion runs in one launch with the cost
// frontier double-buffered in shared memory (no device-memory round trip
// per frame); the [U,M,T,B] mixture intermediate never exists, each thread
// accumulating the mixture dot products of one (bank state, stream) pair in
// registers, kMixChunk mixtures at a time with a running logsumexp, against
// the [A, U*M] transposed weights.  Each CTA stages those weights in shared
// memory once when they fit beside the frontier (read through L1 instead,
// the weights cost an L2 round trip per load and that phase took 80% of the
// kernel's time on the H100); larger banks read them from device memory.
// K8 stages each frame's [U, TB] bank emissions instead (the graph reads
// them through bank_state, so the [T, S, B] gather never exists).
// The wrapper picks TB so the grid covers the SMs, and shrinks TB, then
// drops the staging, until the shared memory fits; only a frontier too wide
// for 4 streams per CTA is refused.  The TPU's 8-row word padding and
// one-hot MXU selects are not carried over: a word start/end here is an
// index expression (K1/K10) or an index table (K8).

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBand = 2;
constexpr int kEpsCode = kMaxBand + 2;
constexpr int kMixChunk = 8;  // mixtures per register block

enum Mode { kFused = 0, kGeneral = 1, kWordtrace = 2 };

struct Params {
  const float* xa;          // [A, T, B] augmented features [x^2, x, 1] (K1/K10)
  const float* wt;          // [A, U*M] emission weights, transposed (K1/K10)
  const float* lw;          // [U*M] log mixture weights (K1/K10)
  const float* nll;         // [U, T, B] bank emissions (K8)
  const float* band;        // [3, S]
  const float* init;        // [S]
  const int* bank_state;    // [S]
  const int* word_starts;   // [R] (K8)
  const int* word_ends;     // [L] (K8)
  const float* eps;         // [R, L]
  const int* row_lo;        // [R] finite origin span of each eps row
  const int* row_hi;        // [R]
  const int* nf;            // [B]
  float* final_cost;        // [S, B]
  int8_t* bp8;              // [T, S, B] (K1/K8)
  void* eps_u;              // [T, R, B] int8 or int32
  int u_wide;
  int* eps_prev;            // [T, R, B] (K1)
  int* eps_tau;             // [T, R, B] (K10)
  int* final_tau;           // [S, B] (K10)
  int A, T, B, U, M, S, R, L, W, eps_depth;
};

// Dynamic shared memory of one CTA; the layout is the carve-up at the top
// of the kernel.
size_t smem_bytes(int mode, int A, int U, int M, int S, int R, int TB,
                  bool stage_w) {
  const size_t um = mode == kGeneral ? 0 : (size_t)U * M;
  const size_t a = mode == kGeneral ? 0 : A;
  const size_t floats = (stage_w ? a * um : 0) + um +
                        (a + U + 2 * (size_t)S) * TB +
                        (mode == kGeneral ? (size_t)R * TB : 0);
  const size_t ints = TB + (mode == kGeneral ? 2 * (size_t)R * TB : 0) +
                      (mode == kWordtrace ? 2 * (size_t)S * TB : 0);
  return (floats + ints) * 4 + (size_t)S * TB;
}

template <int TB, int kMode, bool kStageW>
__global__ void __launch_bounds__(kThreads) viterbi_banded_kernel(Params p) {
  constexpr bool kGen = kMode == kGeneral;
  constexpr bool kTrace = kMode == kWordtrace;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int UM = kGen ? 0 : p.U * p.M;
  float* ws = reinterpret_cast<float*>(smem_raw);  // [A][U*M] if kStageW
  float* lws = ws + (kStageW ? p.A * UM : 0);      // [U*M] log weights
  float* xs = lws + UM;                            // [A][TB] (K1/K10)
  float* en = xs + (kGen ? 0 : p.A * TB);          // [U][TB] bank-state NLL
  float* cur = en + p.U * TB;                      // [S][TB]
  float* nxt = cur + p.S * TB;                     // [S][TB]
  float* ecand = nxt + p.S * TB;                   // [R][TB] (K8)
  int* nfs = reinterpret_cast<int*>(ecand + (kGen ? p.R * TB : 0));  // [TB]
  int* earg = nfs + TB;                            // [R][TB] (K8)
  int* eu = earg + (kGen ? p.R * TB : 0);          // [R][TB] (K8)
  int* tcur = eu + (kGen ? p.R * TB : 0);          // [S][TB] (K10)
  int* tnxt = tcur + (kTrace ? p.S * TB : 0);      // [S][TB] (K10)
  int8_t* dsel = reinterpret_cast<int8_t*>(tnxt + (kTrace ? p.S * TB : 0));

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int W = p.W;
  if (tid < TB) nfs[tid] = (b0 + tid < p.B) ? p.nf[b0 + tid] : 0;
  // the emission weights are read by every frame: stage them once
  if (kStageW)
    for (int i = tid; i < p.A * UM; i += kThreads) ws[i] = p.wt[i];
  for (int i = tid; i < UM; i += kThreads) lws[i] = p.lw[i];

  for (int t = 0; t < p.T; ++t) {
    if (kGen) {
      // (A) this frame's bank emissions
      for (int i = tid; i < p.U * TB; i += kThreads) {
        const int u = i / TB, gb = b0 + i % TB;
        en[i] = gb < p.B
                    ? fminf(__ldg(p.nll + ((size_t)u * p.T + t) * p.B + gb),
                            SRT_POS_INF)
                    : 0.f;
      }
    } else {
      // (A) this frame's augmented feature block
      for (int i = tid; i < p.A * TB; i += kThreads) {
        const int a = i / TB, gb = b0 + i % TB;
        xs[i] = gb < p.B ? p.xa[((size_t)a * p.T + t) * p.B + gb] : 0.f;
      }
      __syncthreads();

      // (B) bank emission: M dot products + mixture logsumexp per (u, b)
      for (int i = tid; i < p.U * TB; i += kThreads) {
        const int u = i / TB, bb = i % TB;
        float zmax = -INFINITY, sum = 0.f;
        for (int m0 = 0; m0 < p.M; m0 += kMixChunk) {
          // fully unrolled over kMixChunk so acc[] stays in registers
          float acc[kMixChunk];
#pragma unroll
          for (int m = 0; m < kMixChunk; ++m) acc[m] = 0.f;
          for (int a = 0; a < p.A; ++a) {
            const float x = xs[a * TB + bb];
            const size_t row = (size_t)a * UM + u * p.M + m0;
#pragma unroll
            for (int m = 0; m < kMixChunk; ++m)
              if (m0 + m < p.M) {
                const float wv = kStageW ? ws[row + m] : __ldg(p.wt + row + m);
                acc[m] = kTrace ? __fadd_rn(acc[m], __fmul_rn(wv, x))
                                : fmaf(wv, x, acc[m]);
              }
          }
          float cmax = -INFINITY;
#pragma unroll
          for (int m = 0; m < kMixChunk; ++m)
            if (m0 + m < p.M) {
              acc[m] = lws[u * p.M + m0 + m] - acc[m];
              cmax = fmaxf(cmax, acc[m]);
            }
          if (m0 == 0) {
            zmax = cmax;
          } else {  // running logsumexp across chunks
            const float nm = fmaxf(zmax, cmax);
            const float scale = expf(zmax - nm);
            sum = kTrace ? __fmul_rn(sum, scale) : sum * scale;
            zmax = nm;
          }
#pragma unroll
          for (int m = 0; m < kMixChunk; ++m)
            if (m0 + m < p.M) {
              const float e = expf(acc[m] - zmax);
              sum = kTrace ? __fadd_rn(sum, e) : sum + e;
            }
        }
        en[i] = -(logf(sum) + zmax);
      }
    }
    __syncthreads();

    // (C) band relaxation + emission (+ the entry-time carry)
    for (int i = tid; i < p.S * TB; i += kThreads) {
      const int s = i / TB, bb = i % TB;
      float best;
      int8_t d = 0;
      if (t == 0) {
        best = __ldg(p.init + s);
      } else if (kGen) {
        best = SRT_POS_INF;
#pragma unroll
        for (int dd = 0; dd <= kMaxBand; ++dd) {
          const float c = __ldg(p.band + dd * p.S + s) +
                          (s >= dd ? cur[i - dd * TB] : SRT_POS_INF);
          if (c <= best) {
            best = c;
            d = dd;
          }
        }
      } else {
        const float c0 = __ldg(p.band + s) + cur[i];
        const float c1 = __ldg(p.band + p.S + s) +
                         (s >= 1 ? cur[i - TB] : SRT_POS_INF);
        const float c2 = __ldg(p.band + 2 * p.S + s) +
                         (s >= 2 ? cur[i - 2 * TB] : SRT_POS_INF);
        best = fminf(fminf(c0, c1), c2);
        d = (c2 == best) ? 2 : ((c1 == best) ? 1 : 0);
      }
      nxt[i] = fminf(best + en[__ldg(p.bank_state + s) * TB + bb], SRT_POS_INF);
      dsel[i] = d;
      if (kTrace) tnxt[i] = (t > 0 && s >= d) ? tcur[i - d * TB] : 0;
    }
    if (kGen)
      for (int i = tid; i < p.R * TB; i += kThreads) eu[i] = 0;
    __syncthreads();

    if (kGen) {
      // (D) eps_depth re-entry passes over index tables
      for (int pass = 0; pass < p.eps_depth; ++pass) {
        for (int i = tid; i < p.R * TB; i += kThreads) {
          const int r = i / TB, bb = i % TB;
          const int lo = __ldg(p.row_lo + r), hi = __ldg(p.row_hi + r);
          float bmin = SRT_POS_INF;
          int arg = 0;
          for (int u = lo; u < hi; ++u) {
            const float c = __ldg(p.eps + (size_t)r * p.L + u) +
                            nxt[__ldg(p.word_ends + u) * TB + bb];
            if (c < bmin) {  // strict: first minimum in origin order
              bmin = c;
              arg = u;
            }
          }
          const int start = __ldg(p.word_starts + r);
          ecand[i] = fminf(bmin + en[__ldg(p.bank_state + start) * TB + bb],
                           SRT_POS_INF);
          earg[i] = arg;
        }
        __syncthreads();
        for (int i = tid; i < p.R * TB; i += kThreads) {
          const int j = __ldg(p.word_starts + i / TB) * TB + i % TB;
          if (ecand[i] < nxt[j]) {  // strict improvement only
            nxt[j] = ecand[i];
            dsel[j] = kEpsCode;
            eu[i] = earg[i];
          }
        }
        __syncthreads();
      }
    } else {
      // (D) epsilon re-entry at word starts (ends and starts are disjoint,
      // so one pass reads ends and writes starts without a race)
      for (int i = tid; i < p.R * TB; i += kThreads) {
        const int r = i / TB, bb = i % TB;
        const int lo = __ldg(p.row_lo + r), hi = __ldg(p.row_hi + r);
        float bmin = SRT_POS_INF;
        int arg = 0;
        for (int u = lo; u < hi; ++u) {
          const float c = __ldg(p.eps + (size_t)r * p.L + u) +
                          nxt[(u * W + W - 1) * TB + bb];
          if (c < bmin) {  // strict: first minimum in origin order
            bmin = c;
            arg = u;
          }
        }
        const int start = r * W;
        const float cand = fminf(
            bmin + en[__ldg(p.bank_state + start) * TB + bb], SRT_POS_INF);
        int uo = 0, pp = 0;
        if (cand < nxt[start * TB + bb]) {
          const int end_row = arg * W + W - 1;
          uo = arg;
          if (kTrace) {
            pp = tnxt[end_row * TB + bb];  // the origin word's entry time
            tnxt[start * TB + bb] = t;
          } else {
            pp = end_row - dsel[end_row * TB + bb];
            dsel[start * TB + bb] = kEpsCode;
          }
          nxt[start * TB + bb] = cand;
        }
        const int gb = b0 + bb;
        if (gb < p.B) {
          const size_t o = ((size_t)t * p.R + r) * p.B + gb;
          if (p.u_wide)
            static_cast<int*>(p.eps_u)[o] = uo;
          else
            static_cast<int8_t*>(p.eps_u)[o] = (int8_t)uo;
          (kTrace ? p.eps_tau : p.eps_prev)[o] = pp;
        }
      }
      __syncthreads();
    }

    // (E) length mask, planes, frontier swap
    for (int i = tid; i < p.S * TB; i += kThreads) {
      const int s = i / TB, bb = i % TB, gb = b0 + bb;
      if (kGen) {
        if (t > 0 && t >= nfs[bb]) nxt[i] = cur[i];
      } else if (t >= nfs[bb]) {
        nxt[i] = (t == 0) ? SRT_POS_INF : cur[i];
        if (kTrace) tnxt[i] = (t == 0) ? 0 : tcur[i];
      }
      if (!kTrace && gb < p.B) p.bp8[((size_t)t * p.S + s) * p.B + gb] = dsel[i];
    }
    if (kGen)
      for (int i = tid; i < p.R * TB; i += kThreads) {
        const int gb = b0 + i % TB;
        if (gb >= p.B) continue;
        const size_t o = ((size_t)t * p.R + i / TB) * p.B + gb;
        if (p.u_wide)
          static_cast<int*>(p.eps_u)[o] = eu[i];
        else
          static_cast<int8_t*>(p.eps_u)[o] = (int8_t)eu[i];
      }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    int* ttmp = tcur;
    tcur = tnxt;
    tnxt = ttmp;
    // the barrier after the next frame's (A) orders these writes
  }
  __syncthreads();
  for (int i = tid; i < p.S * TB; i += kThreads) {
    const int bb = i % TB, gb = b0 + bb;
    if (gb >= p.B) continue;
    const size_t o = (size_t)(i / TB) * p.B + gb;
    const bool has_final = !kGen || (nfs[bb] >= 1 && nfs[bb] <= p.T);
    p.final_cost[o] = has_final ? cur[i] : SRT_POS_INF;
    if (kTrace) p.final_tau[o] = tcur[i];
  }
}

template <int TB, int kMode, bool kStageW>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(kMode, p.A, p.U, p.M, p.S, p.R, TB, kStageW);
  auto kernel = viterbi_banded_kernel<TB, kMode, kStageW>;
  SRT_SET_SMEM(kernel, smem);
  const int grid = (p.B + TB - 1) / TB;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int TB, int kMode>
int launch(const Params& p, int stage_w, cudaStream_t stream) {
  if constexpr (kMode == kGeneral)
    return launch<TB, kMode, false>(p, stream);
  else
    return stage_w ? launch<TB, kMode, true>(p, stream)
                   : launch<TB, kMode, false>(p, stream);
}

template <int kMode>
int launch_tile(const Params& p, int tile, int stage_w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 4: return launch<4, kMode>(p, stage_w, s);
    case 8: return launch<8, kMode>(p, stage_w, s);
    case 16: return launch<16, kMode>(p, stage_w, s);
    case 32: return launch<32, kMode>(p, stage_w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int smem_int(int mode, int A, int U, int M, int S, int R, int tile,
             int stage_w) {
  const size_t n = smem_bytes(mode, A, U, M, S, R, tile, stage_w != 0);
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
}

}  // namespace

extern "C" int viterbi_banded_smem_bytes(int A, int U, int M, int S, int tile,
                                         int stage_w) {
  return smem_int(kFused, A, U, M, S, 0, tile, stage_w);
}

extern "C" int viterbi_wordtrace_smem_bytes(int A, int U, int M, int S,
                                            int tile, int stage_w) {
  return smem_int(kWordtrace, A, U, M, S, 0, tile, stage_w);
}

extern "C" int viterbi_banded_general_smem_bytes(int U, int S, int R,
                                                 int tile) {
  return smem_int(kGeneral, 0, U, 0, S, R, tile, 0);
}

// K1
extern "C" int viterbi_banded_launch(
    const float* xa, const float* wt, const float* lw, const float* band,
    const float* init, const int* bank_state, const float* eps,
    const int* row_lo, const int* row_hi, const int* nf, float* final_cost,
    int8_t* bp8, void* eps_u, int u_wide, int* eps_prev, int A, int T, int B,
    int U, int M, int S, int R, int L, int W, int tile, int stage_w,
    void* stream) {
  if (M < 1 || W < 2 || S != R * W || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.xa = xa; p.wt = wt; p.lw = lw; p.band = band; p.init = init;
  p.bank_state = bank_state; p.eps = eps; p.row_lo = row_lo;
  p.row_hi = row_hi; p.nf = nf; p.final_cost = final_cost; p.bp8 = bp8;
  p.eps_u = eps_u; p.u_wide = u_wide; p.eps_prev = eps_prev;
  p.A = A; p.T = T; p.B = B; p.U = U; p.M = M; p.S = S; p.R = R; p.L = L;
  p.W = W; p.eps_depth = 1;
  return launch_tile<kFused>(p, tile, stage_w, stream);
}

// K8
extern "C" int viterbi_banded_general_launch(
    const float* nll, const float* band, const float* init,
    const int* bank_state, const int* word_starts, const int* word_ends,
    const float* eps, const int* row_lo, const int* row_hi, const int* nf,
    float* final_cost, int8_t* bp8, void* eps_u, int u_wide, int U, int T,
    int B, int S, int R, int L, int eps_depth, int tile, void* stream) {
  if (U < 1 || S < 1 || R < 1 || L < 1 || eps_depth < 1 || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.nll = nll; p.band = band; p.init = init; p.bank_state = bank_state;
  p.word_starts = word_starts; p.word_ends = word_ends; p.eps = eps;
  p.row_lo = row_lo; p.row_hi = row_hi; p.nf = nf;
  p.final_cost = final_cost; p.bp8 = bp8; p.eps_u = eps_u;
  p.u_wide = u_wide;
  p.T = T; p.B = B; p.U = U; p.S = S; p.R = R; p.L = L;
  p.eps_depth = eps_depth;
  return launch_tile<kGeneral>(p, tile, 0, stream);
}

// K10
extern "C" int viterbi_wordtrace_launch(
    const float* xa, const float* wt, const float* lw, const float* band,
    const float* init, const int* bank_state, const float* eps,
    const int* row_lo, const int* row_hi, const int* nf, float* final_cost,
    void* eps_u, int u_wide, int* eps_tau, int* final_tau, int A, int T,
    int B, int U, int M, int S, int R, int L, int W, int tile, int stage_w,
    void* stream) {
  if (M < 1 || W < 2 || S != R * W || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.xa = xa; p.wt = wt; p.lw = lw; p.band = band; p.init = init;
  p.bank_state = bank_state; p.eps = eps; p.row_lo = row_lo;
  p.row_hi = row_hi; p.nf = nf; p.final_cost = final_cost;
  p.eps_u = eps_u; p.u_wide = u_wide; p.eps_tau = eps_tau;
  p.final_tau = final_tau;
  p.A = A; p.T = T; p.B = B; p.U = U; p.M = M; p.S = S; p.R = R; p.L = L;
  p.W = W; p.eps_depth = 1;
  return launch_tile<kWordtrace>(p, tile, stage_w, stream);
}
