// K10: fused GMM emission + banded Viterbi forward over a uniform composed
// word graph (V words of W states, slot-major; eps depth 1, disjoint word
// starts and ends) with an int32 entry-time frontier instead of a
// backpointer plane.  Replaces the TPU kernel
// speech_recognition_tpu/ops/viterbi_banded_pallas.py
// _kernel(emit_wordtrace=True) (viterbi_banded_wordtrace_pallas, the
// backend="wordtrace" decode).  K1 and K8, which shared this kernel as
// template modes, moved to csrc/bank_emission.cu + csrc/banded_forward.cu.
//
// Per frame t and stream b:
//   emission   nll[u] = -(log sum_m exp(lw[u,m] - w[u,m,:] . xa[:,t,b]
//              - zmax) + zmax), mixtures in blocks of kMixChunk with a running
//              max
//   band       best = min_d band[d,s] + cost[s-d] (d = 0, 1, 2; the largest d
//              wins ties, the min-chain with the code read off afterwards);
//              frame 0 seeds from init with d = 0
//   emission   cost[s] = min(best + nll[bank_state[s]], POS_INF)
//   eps        per word r: first-minimum origin u of eps[r,u] + cost[end(u)]
//              over the row's finite span (strict <); the start state takes
//              it only if strictly better (one pass, ends and starts disjoint)
//   word trace tau follows the band winner (tau[s-d]; 0 at frame 0); an
//              eps improvement sets tau[start] = t and records the origin
//              end's tau (before the pass) into eps_tau
//   mask       t >= nf[b] freezes cost and tau; frame 0 of an empty stream
//              gives POS_INF (tau 0); final = carry after the last frame.
// Outputs in original state numbering: final [S,B] f32, eps_u [T,R,B] (i8,
// i32 when L > 127), eps_tau [T,R,B] i32, final_tau [S,B] i32.  Every
// frame's planes are written, frozen frames included.
//
// Arithmetic: each product and each sum of the emission is rounded apart
// (__fmul_rn / __fadd_rn, also in the running logsumexp), in the order of
// its plain version, so that the plain version, which PyTorch runs one
// rounded operation at a time, is bit-identical to it.
//
// What bounds it on the H100: at B=512, T=500, S=385 the emission GEMM is
// ~8.9 GFLOP (~0.13 ms of f32 FMA) and the planes ~0.08 ms at 3.35 TB/s,
// but the real bound is latency: T dependent frame steps, each a few
// barrier-separated passes over a tile of streams, plus a tau load and
// store per state.
//
// What the design does about it: one CTA owns a tile of TB streams for all
// T frames, so the whole recursion runs in one launch with the cost and tau
// frontiers double-buffered in shared memory (no device-memory round trip
// per frame); the [U,M,T,B] mixture intermediate never exists, each thread
// accumulating the mixture dot products of one (bank state, stream) pair in
// registers, kMixChunk mixtures at a time with a running logsumexp, against
// the [A, U*M] transposed weights, which each CTA stages in shared memory
// once when they fit beside the frontier (else they are read from device
// memory).  The wrapper picks TB so the grid covers the SMs, and shrinks
// TB, then drops the staging, until the shared memory fits; a frontier too
// wide for 4 streams per CTA is refused (this kernel keeps its tile-per-CTA
// design until it moves onto the banded DP of csrc/banded_forward.cu).

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMixChunk = 8;  // mixtures per register block

struct Params {
  const float* xa;          // [A, T, B] augmented features [x^2, x, 1]
  const float* wt;          // [A, U*M] emission weights, transposed
  const float* lw;          // [U*M] log mixture weights
  const float* band;        // [3, S]
  const float* init;        // [S]
  const int* bank_state;    // [S]
  const float* eps;         // [R, L]
  const int* row_lo;        // [R] finite origin span of each eps row
  const int* row_hi;        // [R]
  const int* nf;            // [B]
  float* final_cost;        // [S, B]
  void* eps_u;              // [T, R, B] int8 or int32
  int u_wide;
  int* eps_tau;             // [T, R, B]
  int* final_tau;           // [S, B]
  int A, T, B, U, M, S, R, L, W;
};

// Dynamic shared memory of one CTA; the layout is the carve-up at the top
// of the kernel.
size_t smem_bytes(int A, int U, int M, int S, int TB, bool stage_w) {
  const size_t um = (size_t)U * M;
  const size_t floats = (stage_w ? (size_t)A * um : 0) + um +
                        ((size_t)A + U + 2 * (size_t)S) * TB;
  const size_t ints = TB + 2 * (size_t)S * TB;
  return (floats + ints) * 4 + (size_t)S * TB;
}

template <int TB, bool kStageW>
__global__ void __launch_bounds__(kThreads) viterbi_wordtrace_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int UM = p.U * p.M;
  float* ws = reinterpret_cast<float*>(smem_raw);  // [A][U*M] if kStageW
  float* lws = ws + (kStageW ? p.A * UM : 0);      // [U*M] log weights
  float* xs = lws + UM;                            // [A][TB]
  float* en = xs + p.A * TB;                       // [U][TB] bank-state NLL
  float* cur = en + p.U * TB;                      // [S][TB]
  float* nxt = cur + p.S * TB;                     // [S][TB]
  int* nfs = reinterpret_cast<int*>(nxt + p.S * TB);  // [TB]
  int* tcur = nfs + TB;                            // [S][TB]
  int* tnxt = tcur + p.S * TB;                     // [S][TB]
  int8_t* dsel = reinterpret_cast<int8_t*>(tnxt + p.S * TB);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int W = p.W;
  if (tid < TB) nfs[tid] = (b0 + tid < p.B) ? p.nf[b0 + tid] : 0;
  // the emission weights are read by every frame: stage them once
  if (kStageW)
    for (int i = tid; i < p.A * UM; i += kThreads) ws[i] = p.wt[i];
  for (int i = tid; i < UM; i += kThreads) lws[i] = p.lw[i];

  for (int t = 0; t < p.T; ++t) {
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
              acc[m] = __fadd_rn(acc[m], __fmul_rn(wv, x));
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
          sum = __fmul_rn(sum, scale);
          zmax = nm;
        }
#pragma unroll
        for (int m = 0; m < kMixChunk; ++m)
          if (m0 + m < p.M) {
            const float e = expf(acc[m] - zmax);
            sum = __fadd_rn(sum, e);
          }
      }
      en[i] = -(logf(sum) + zmax);
    }
    __syncthreads();

    // (C) band relaxation + emission + the entry-time carry
    for (int i = tid; i < p.S * TB; i += kThreads) {
      const int s = i / TB, bb = i % TB;
      float best;
      int8_t d = 0;
      if (t == 0) {
        best = __ldg(p.init + s);
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
      tnxt[i] = (t > 0 && s >= d) ? tcur[i - d * TB] : 0;
    }
    __syncthreads();

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
        pp = tnxt[end_row * TB + bb];  // the origin word's entry time
        tnxt[start * TB + bb] = t;
        nxt[start * TB + bb] = cand;
      }
      const int gb = b0 + bb;
      if (gb < p.B) {
        const size_t o = ((size_t)t * p.R + r) * p.B + gb;
        if (p.u_wide)
          static_cast<int*>(p.eps_u)[o] = uo;
        else
          static_cast<int8_t*>(p.eps_u)[o] = (int8_t)uo;
        p.eps_tau[o] = pp;
      }
    }
    __syncthreads();

    // (E) length mask, frontier swap
    for (int i = tid; i < p.S * TB; i += kThreads) {
      const int bb = i % TB;
      if (t >= nfs[bb]) {
        nxt[i] = (t == 0) ? SRT_POS_INF : cur[i];
        tnxt[i] = (t == 0) ? 0 : tcur[i];
      }
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
    p.final_cost[o] = cur[i];
    p.final_tau[o] = tcur[i];
  }
}

template <int TB, bool kStageW>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.A, p.U, p.M, p.S, TB, kStageW);
  auto kernel = viterbi_wordtrace_kernel<TB, kStageW>;
  SRT_SET_SMEM(kernel, smem);
  const int grid = (p.B + TB - 1) / TB;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int TB>
int launch(const Params& p, int stage_w, cudaStream_t stream) {
  return stage_w ? launch<TB, true>(p, stream) : launch<TB, false>(p, stream);
}

int launch_tile(const Params& p, int tile, int stage_w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 4: return launch<4>(p, stage_w, s);
    case 8: return launch<8>(p, stage_w, s);
    case 16: return launch<16>(p, stage_w, s);
    case 32: return launch<32>(p, stage_w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int viterbi_wordtrace_smem_bytes(int A, int U, int M, int S,
                                            int tile, int stage_w) {
  const size_t n = smem_bytes(A, U, M, S, tile, stage_w != 0);
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
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
  p.W = W;
  return launch_tile(p, tile, stage_w, stream);
}
