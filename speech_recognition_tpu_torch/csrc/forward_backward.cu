// K15 and K16: the log-space forward-backward (sum-product) pass, banded
// and dense, one CTA per utterance.
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
// takes.
//
// Layout shared by both: one CTA per utterance, so the forward and the
// backward of an item run one after the other with block barriers only.
// The forward writes every alpha row it computes to a [B, T, S] scratch
// plane; the backward computes beta on the fly, two or three [S] rows,
// and in the same loop writes gamma and adds up xi.  Each thread owns its
// states' (K16 band mode: origins'; dense mode: destination rows') xi
// sums, in shared memory where they fit, else in the output itself: no
// atomics, one fixed order, so runs repeat bit for bit.  Frames at and
// past nf are skipped (gamma written 0).
//
// K15 (fb_banded_kernel): a thread a state, strided past the block.  A
// frame is a 3-term LSE per state (+ the cross edge's logaddexp), then per
// eps pass: the end states' values gathered into shared memory, one warp
// per start row reducing its finite span of the eps block (lanes strided,
// xor-shuffle max and sum), a logaddexp per state.  The backward mirrors
// it: the start states' values gathered, one warp per end column, and the
// cross pullback through the inverse index of cross_src (CSR, destinations
// ascending) built on the host at each call.  Rows, the [R] + [L]
// vectors and the sums live in shared memory; the plan
// (ops/forward_backward_kernels.banded_plan) moves the sums to the outputs
// where they do not fit, and refuses a graph whose rows do not fit (past
// ~29k states, fewer with a large eps block).
//
// K16 (fb_dense_kernel): a thread a destination row (forward, dense xi) or
// origin (backward, band xi), strided past the block.  The item's score
// matrices (converted from costs once) sit in shared memory with an odd
// row stride, so a warp's row reads (thread v, column u) and column reads
// (thread u, row v) each hit 32 banks; where they do not fit
// (ops/forward_backward_kernels.dense_plan) the costs are read through L1
// and converted per read, and the dense xi sums go to the output.  The
// three rows stay in shared memory: the plan refuses S past ~19k.
//
// What bounds them on the H100: exp and log.  K16 at the soft-EM shape
// (419 x 319, S = 75, eps matrices) does 4 S^2 exps a frame (the frame
// edge and the eps pass, forward and backward): ~3e9 in all, 0.7 ms at the
// SFU's 16 a clock per SM (132 SMs, 1.98 GHz: ~4.2e12 a second), against
// ~0.2 GB of device memory (nll read twice, alpha written and read, gamma
// written), ~0.06 ms.  K15 at the confidence shape (256 x 500 on the
// 385-state sausage) does ~12 exps a state and frame: ~0.6e9, 0.15 ms by
// the SFU, ~0.8 GB of bytes, 0.24 ms.  Each frame is a chain of 4-10
// dependent block barriers, so with one CTA an item both are bound by
// latency at these batch sizes: a later redesign would split items over
// warps (K16: the probability-space matvec, FMAs instead of S^2 exps).

#include "common.cuh"

#include <math.h>

#define FB_NEG_INF (-1e30f)
#define FB_HALF_INF (0.5e30f)
#define FB_RED 64  // floats of block-reduction scratch

namespace {

__device__ __forceinline__ float score_of(float cost) {
  return cost >= FB_HALF_INF ? FB_NEG_INF : -cost;
}

__device__ __forceinline__ float emis_of(float nll) { return -fminf(nll, SRT_POS_INF); }

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

// jax.scipy.special.logsumexp of x[s] + e[s] over the block's states
__device__ float block_logsumexp(const float* x, const float* e, int S, float* red) {
  float m = -INFINITY;
  for (int s = threadIdx.x; s < S; s += blockDim.x) m = fmaxf(m, x[s] + e[s]);
  m = block_reduce<true>(m, red);
  const float ms = isfinite(m) ? m : 0.0f;
  float sum = 0.0f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) sum += expf((x[s] + e[s]) - ms);
  sum = block_reduce<false>(sum, red);
  return logf(fabsf(sum)) + ms;
}

// LSE over a finite span of the eps block, one warp: rows r (stride 1 in
// l) or columns l (stride L in r); NEG_INF for an empty span
__device__ __forceinline__ float warp_span_lse(const float* blk, int stride, int lo, int hi,
                                               const float* v) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int k = lo + lane; k < hi; k += 32) m = fmaxf(m, score_of(blk[(size_t)k * stride]) + v[k]);
  m = warp_max(m);
  if (lo >= hi || !isfinite(m)) return FB_NEG_INF;
  float sum = 0.0f;
  for (int k = lo + lane; k < hi; k += 32) sum += expf((score_of(blk[(size_t)k * stride]) + v[k]) - m);
  return logf(warp_sum(sum)) + m;
}

struct BandedArgs {
  const float* nll;             // [B, T, S]
  const float* band;            // [(B,) 3, S] costs, edge s - d -> s
  const float* init;            // [(B,) S] costs
  const float* blk;             // [(B,) R, L] costs
  const int* starts;            // [(B,) R]
  const int* ends;              // [(B,) L]
  const int* start_pos;         // [(B,) S]
  const unsigned char* is_start;  // [(B,) S]
  const int* end_pos;           // [(B,) S] last l with ends[l] == s, else -1
  const int* row_lo;            // [(B,) R] finite span of row r over l
  const int* row_hi;
  const int* col_lo;            // [(B,) L] finite span of column l over r
  const int* col_hi;
  const int* cross_src;         // [(B,) S] or null
  const float* cross_cost;      // [(B,) S] costs
  const int* inv_off;           // [(B,) S + 1] real cross edges by origin (CSR)
  const int* inv_dst;           // [(B,) S]
  const float* end_scores;      // [(B,) S]
  const int* n_frames;          // [B]
  float* alpha;                 // [B, T, S] scratch
  float* gamma;                 // [B, T, S]
  float* xi;                    // [B, 3, S]
  float* xi_cross;              // [B, S] or null
  float* log_z;                 // [B]
  int T, S, R, L;
  int graph_per_item, end_per_item, eps_depth, acc_smem;
};

size_t banded_smem_floats(int S, int R, int L, int has_cross, int acc_smem) {
  return FB_RED + R + L + 2 * (size_t)S + (acc_smem ? (3 + (has_cross ? 1 : 0)) * (size_t)S : 0);
}

__global__ void fb_banded_kernel(BandedArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  const int T = a.T, S = a.S, R = a.R, L = a.L;
  const size_t g = a.graph_per_item ? b : 0;
  const float* band = a.band + g * 3 * S;
  const float* init = a.init + g * S;
  const float* blk = a.blk + g * R * L;
  const int* starts = a.starts + g * R;
  const int* ends = a.ends + g * L;
  const int* start_pos = a.start_pos + g * S;
  const unsigned char* is_start = a.is_start + g * S;
  const int* end_pos = a.end_pos + g * S;
  const int* row_lo = a.row_lo + g * R;
  const int* row_hi = a.row_hi + g * R;
  const int* col_lo = a.col_lo + g * L;
  const int* col_hi = a.col_hi + g * L;
  const bool cross = a.cross_src != nullptr;
  const int* csrc = cross ? a.cross_src + g * S : nullptr;
  const float* ccost = cross ? a.cross_cost + g * S : nullptr;
  const int* ioff = cross ? a.inv_off + g * (S + 1) : nullptr;
  const int* idst = cross ? a.inv_dst + g * S : nullptr;
  const float* ends_sc = a.end_scores + (a.end_per_item ? (size_t)b * S : 0);
  const float* nll = a.nll + (size_t)b * T * S;
  float* alpha = a.alpha + (size_t)b * T * S;
  float* gamma = a.gamma + (size_t)b * T * S;
  const int nf = min(max(a.n_frames[b], 0), T);

  float* red = smem;
  float* vR = red + FB_RED;  // [R]: end-row candidates / start values
  float* vL = vR + R;        // [L]: end values / end-column pullbacks
  float* row0 = vL + L;
  float* row1 = row0 + S;
  float* p = row1 + S;
  float *acc, *accx;
  if (a.acc_smem) {
    acc = p;
    accx = p + 3 * S;
  } else {
    acc = a.xi + (size_t)b * 3 * S;
    accx = cross ? a.xi_cross + (size_t)b * S : nullptr;
  }
  for (int s = tid; s < 3 * S; s += nth) acc[s] = 0.0f;
  if (cross)
    for (int s = tid; s < S; s += nth) accx[s] = 0.0f;

  // one eps pass of the forward on row x at frame t (ends with a barrier)
  auto eps_fwd = [&](float* x, const float* e) {
    for (int pass = 0; pass < a.eps_depth; ++pass) {
      for (int l = tid; l < L; l += nth) vL[l] = x[ends[l]];
      __syncthreads();
      for (int r = warp; r < R; r += nw) {
        const float base = warp_span_lse(blk + (size_t)r * L, 1, row_lo[r], row_hi[r], vL);
        if (lane == 0) vR[r] = base + emis_of(e[starts[r]]);
      }
      __syncthreads();
      for (int s = tid; s < S; s += nth)
        x[s] = lae(x[s], is_start[s] ? vR[start_pos[s]] : FB_NEG_INF);
      __syncthreads();
    }
  };

  // ---- forward ----
  float* cur = row0;
  float* prv = row1;
  for (int s = tid; s < S; s += nth) cur[s] = score_of(init[s]) + emis_of(nll[s]);
  __syncthreads();
  eps_fwd(cur, nll);
  for (int s = tid; s < S; s += nth) alpha[s] = cur[s];
  for (int t = 1; t < nf; ++t) {
    float* tmp = cur;
    cur = prv;
    prv = tmp;
    const float* e = nll + (size_t)t * S;
    for (int s = tid; s < S; s += nth) {
      const float z0 = score_of(band[s]) + prv[s];
      const float z1 = score_of(band[S + s]) + (s >= 1 ? prv[s - 1] : FB_NEG_INF);
      const float z2 = score_of(band[2 * S + s]) + (s >= 2 ? prv[s - 2] : FB_NEG_INF);
      float base = lse3(z0, z1, z2);
      if (cross) base = lae(base, prv[csrc[s]] + score_of(ccost[s]));
      cur[s] = base + emis_of(e[s]);
    }
    __syncthreads();
    eps_fwd(cur, e);
    for (int s = tid; s < S; s += nth) alpha[(size_t)t * S + s] = cur[s];
  }
  const float logz = block_logsumexp(cur, ends_sc, S, red);
  if (tid == 0) a.log_z[b] = logz;

  // ---- backward: B = beta[t], W = the eps-passed copy, then y ----
  float* B = cur;
  float* W = prv;
  const int tl = max(nf, 1) - 1;
  for (int s = tid; s < S; s += nth) B[s] = ends_sc[s];
  for (size_t i = (size_t)nf * S + tid; i < (size_t)T * S; i += nth) gamma[i] = 0.0f;
  __syncthreads();
  for (int t = tl; t >= 0; --t) {
    const float* e = nll + (size_t)t * S;
    if (t < nf)
      for (int s = tid; s < S; s += nth)
        gamma[(size_t)t * S + s] =
            expf(fminf((alpha[(size_t)t * S + s] + B[s]) - logz, 50.0f));
    if (t >= 1 && t < nf) {
      const float* ap = alpha + (size_t)(t - 1) * S;
      for (int u = tid; u < S; u += nth) {
        const float au = ap[u];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int v = u + d;
          const float lb = v < S ? score_of(band[d * S + v]) : FB_NEG_INF;
          const float eb = v < S ? emis_of(e[v]) + B[v] : FB_NEG_INF;
          acc[d * S + u] += expf(fminf(((au + lb) + eb) - logz, 50.0f));
        }
        if (cross)
          accx[u] += expf(fminf(((ap[csrc[u]] + score_of(ccost[u])) + (emis_of(e[u]) + B[u]))
                                - logz, 50.0f));
      }
    }
    if (t == 0) break;
    for (int s = tid; s < S; s += nth) W[s] = B[s];
    __syncthreads();
    for (int pass = 0; pass < a.eps_depth; ++pass) {
      for (int r = tid; r < R; r += nth) vR[r] = W[starts[r]] + emis_of(e[starts[r]]);
      __syncthreads();
      for (int l = warp; l < L; l += nw) {
        const float c = warp_span_lse(blk + l, L, col_lo[l], col_hi[l], vR);
        if (lane == 0) vL[l] = c;
      }
      __syncthreads();
      for (int s = tid; s < S; s += nth) {
        const int ep = end_pos[s];
        W[s] = lae(W[s], ep >= 0 ? vL[ep] : FB_NEG_INF);
      }
      __syncthreads();
    }
    for (int s = tid; s < S; s += nth) W[s] = W[s] + emis_of(e[s]);
    __syncthreads();
    for (int u = tid; u < S; u += nth) {
      const float z0 = score_of(band[u]) + W[u];
      const float z1 = u + 1 < S ? score_of(band[S + u + 1]) + W[u + 1] : FB_NEG_INF;
      const float z2 = u + 2 < S ? score_of(band[2 * S + u + 2]) + W[u + 2] : FB_NEG_INF;
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
          const float v = score_of(ccost[i]) + W[i];
          tot += isfinite(v) ? expf(v - ms) : 0.0f;
        }
        nb = lae(nb, tot > 0.0f ? logf(tot) + ms : FB_NEG_INF);
      }
      B[u] = nb;
    }
    __syncthreads();
  }
  __syncthreads();
  if (a.acc_smem) {
    for (int s = tid; s < 3 * S; s += nth) a.xi[(size_t)b * 3 * S + s] = acc[s];
    if (cross)
      for (int s = tid; s < S; s += nth) a.xi_cross[(size_t)b * S + s] = accx[s];
  }
}

struct DenseArgs {
  const float* nll;         // [B, T, S]
  const float* trans;       // [(B,) S, S] costs, [to, from]
  const float* eps;         // [(B,) S, S] costs or null
  const float* init;        // [(B,) S] costs
  const float* end_scores;  // [(B,) S]
  const int* n_frames;      // [B]
  float* alpha;             // [B, T, S] scratch
  float* gamma;             // [B, T, S]
  float* xi;                // [B, 3, S] (band) or [B, S, S] (dense)
  float* log_z;             // [B]
  int T, S, ld;
  int mats_per_item, init_per_item, end_per_item, eps_depth, xi_dense;
  int mats_smem, acc_smem;
};

int dense_ld(int S) { return S | 1; }

size_t dense_smem_floats(int S, int use_eps, int xi_dense, int mats_smem, int acc_smem) {
  const size_t ld = dense_ld(S);
  return FB_RED + 3 * (size_t)S +
         (mats_smem ? (1 + (use_eps ? 1 : 0)) * (size_t)S * ld : 0) +
         (acc_smem ? (xi_dense ? (size_t)S * ld : 3 * (size_t)S) : 0);
}

// a score matrix, staged in shared memory (scores, row stride ld) or read
// from device memory (costs, row stride S, converted per read)
struct ScoreMat {
  const float* p;
  int ld;
  bool staged;
  __device__ __forceinline__ float operator()(int v, int u) const {
    const float x = p[(size_t)v * ld + u];
    return staged ? x : score_of(x);
  }
};

__global__ void fb_dense_kernel(DenseArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int T = a.T, S = a.S, ld = a.ld;
  const bool use_eps = a.eps != nullptr;
  const size_t g = a.mats_per_item ? b : 0;
  const float* trans_g = a.trans + g * S * S;
  const float* eps_g = use_eps ? a.eps + g * S * S : nullptr;
  const float* init = a.init + (a.init_per_item ? (size_t)b * S : 0);
  const float* ends_sc = a.end_scores + (a.end_per_item ? (size_t)b * S : 0);
  const float* nll = a.nll + (size_t)b * T * S;
  float* alpha = a.alpha + (size_t)b * T * S;
  float* gamma = a.gamma + (size_t)b * T * S;
  const int nf = min(max(a.n_frames[b], 0), T);

  float* red = smem;
  float* p = red + FB_RED;
  float* rw[3];
  for (int k = 0; k < 3; ++k) rw[k] = p + k * S;
  p += 3 * S;
  ScoreMat lt{trans_g, S, false}, le{eps_g, S, false};
  if (a.mats_smem) {
    float* mt = p;
    p += (size_t)S * ld;
    for (int i = tid; i < S * S; i += nth) mt[(i / S) * ld + i % S] = score_of(trans_g[i]);
    lt = ScoreMat{mt, ld, true};
    if (use_eps) {
      float* me = p;
      p += (size_t)S * ld;
      for (int i = tid; i < S * S; i += nth) me[(i / S) * ld + i % S] = score_of(eps_g[i]);
      le = ScoreMat{me, ld, true};
    }
  }
  float* acc;
  int acc_ld;
  if (a.acc_smem) {
    acc = p;
    acc_ld = a.xi_dense ? ld : S;
  } else {
    acc = a.xi + (size_t)b * (a.xi_dense ? (size_t)S * S : 3 * (size_t)S);
    acc_ld = S;
  }
  const int n_acc = a.xi_dense ? S : 3;
  for (int i = tid; i < n_acc * S; i += nth) acc[(i / S) * acc_ld + i % S] = 0.0f;
  __syncthreads();

  // LSE over u of m(v, u) + x[u] (forward, row v) or over v of m(v, u) +
  // x[v] (backward, column u)
  auto lse_row = [&](const ScoreMat& m, int v, const float* x) {
    float mx = -INFINITY;
    for (int u = 0; u < S; ++u) mx = fmaxf(mx, m(v, u) + x[u]);
    if (!isfinite(mx)) return FB_NEG_INF;
    float sum = 0.0f;
    for (int u = 0; u < S; ++u) sum += expf((m(v, u) + x[u]) - mx);
    return logf(sum) + mx;
  };
  auto lse_col = [&](const ScoreMat& m, int u, const float* x) {
    float mx = -INFINITY;
    for (int v = 0; v < S; ++v) mx = fmaxf(mx, m(v, u) + x[v]);
    if (!isfinite(mx)) return FB_NEG_INF;
    float sum = 0.0f;
    for (int v = 0; v < S; ++v) sum += expf((m(v, u) + x[v]) - mx);
    return logf(sum) + mx;
  };

  // ---- forward: eps passes write the third row, then swap ----
  float* cur = rw[0];
  float* prv = rw[1];
  float* nxt = rw[2];
  auto eps_fwd = [&](const float* e) {
    if (!use_eps) return;
    for (int pass = 0; pass < a.eps_depth; ++pass) {
      for (int v = tid; v < S; v += nth)
        nxt[v] = lae(cur[v], lse_row(le, v, cur) + emis_of(e[v]));
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  };
  for (int v = tid; v < S; v += nth) cur[v] = score_of(init[v]) + emis_of(nll[v]);
  __syncthreads();
  eps_fwd(nll);
  for (int v = tid; v < S; v += nth) alpha[v] = cur[v];
  for (int t = 1; t < nf; ++t) {
    float* tmp = prv;
    prv = cur;
    cur = tmp;
    const float* e = nll + (size_t)t * S;
    for (int v = tid; v < S; v += nth) cur[v] = lse_row(lt, v, prv) + emis_of(e[v]);
    __syncthreads();
    eps_fwd(e);
    for (int v = tid; v < S; v += nth) alpha[(size_t)t * S + v] = cur[v];
  }
  const float logz = block_logsumexp(cur, ends_sc, S, red);
  if (tid == 0) a.log_z[b] = logz;

  // ---- backward: Bt = beta[t], W = its eps-passed copy, Y = W + emis ----
  float* Bt = cur;
  float* W = prv;
  float* Y = nxt;
  const int tl = max(nf, 1) - 1;
  for (int s = tid; s < S; s += nth) Bt[s] = ends_sc[s];
  for (size_t i = (size_t)nf * S + tid; i < (size_t)T * S; i += nth) gamma[i] = 0.0f;
  __syncthreads();
  for (int t = tl; t >= 0; --t) {
    const float* e = nll + (size_t)t * S;
    if (t < nf)
      for (int s = tid; s < S; s += nth)
        gamma[(size_t)t * S + s] =
            expf(fminf((alpha[(size_t)t * S + s] + Bt[s]) - logz, 50.0f));
    if (t >= 1 && t < nf) {
      const float* ap = alpha + (size_t)(t - 1) * S;
      if (a.xi_dense) {
        for (int u = tid; u < S; u += nth) Y[u] = ap[u];
        __syncthreads();
        for (int v = tid; v < S; v += nth) {
          const float eb = emis_of(e[v]) + Bt[v];
          float* row = acc + (size_t)v * acc_ld;
          for (int u = 0; u < S; ++u)
            row[u] += expf(fminf(((Y[u] + lt(v, u)) + eb) - logz, 50.0f));
        }
      } else {
        for (int u = tid; u < S; u += nth) {
          const float au = ap[u];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const int v = u + d;
            const float lb = v < S ? lt(v, u) : FB_NEG_INF;
            const float eb = v < S ? emis_of(e[v]) + Bt[v] : FB_NEG_INF;
            acc[d * S + u] += expf(fminf(((au + lb) + eb) - logz, 50.0f));
          }
        }
      }
    }
    if (t == 0) break;
    __syncthreads();
    for (int s = tid; s < S; s += nth) W[s] = Bt[s];
    if (use_eps) {
      for (int pass = 0; pass < a.eps_depth; ++pass) {
        for (int v = tid; v < S; v += nth) Y[v] = W[v] + emis_of(e[v]);
        __syncthreads();
        for (int u = tid; u < S; u += nth) W[u] = lae(W[u], lse_col(le, u, Y));
        __syncthreads();
      }
    }
    for (int v = tid; v < S; v += nth) Y[v] = W[v] + emis_of(e[v]);
    __syncthreads();
    for (int u = tid; u < S; u += nth) Bt[u] = lse_col(lt, u, Y);
    __syncthreads();
  }
  __syncthreads();
  if (a.acc_smem) {
    float* out = a.xi + (size_t)b * n_acc * S;
    for (int i = tid; i < n_acc * S; i += nth) out[i] = acc[(i / S) * acc_ld + i % S];
  }
}

}  // namespace

extern "C" int fb_banded_smem_bytes(int S, int R, int L, int has_cross, int acc_smem) {
  const size_t n = 4 * banded_smem_floats(S, R, L, has_cross, acc_smem);
  return n > (size_t)1 << 30 ? 1 << 30 : (int)n;
}

extern "C" int fb_dense_smem_bytes(int S, int use_eps, int xi_dense, int mats_smem,
                                   int acc_smem) {
  const size_t n = 4 * dense_smem_floats(S, use_eps, xi_dense, mats_smem, acc_smem);
  return n > (size_t)1 << 30 ? 1 << 30 : (int)n;
}

extern "C" int fb_banded_launch(
    const float* nll, const float* band, const float* init, const float* blk, const int* starts,
    const int* ends, const int* start_pos, const unsigned char* is_start, const int* end_pos,
    const int* row_lo, const int* row_hi, const int* col_lo, const int* col_hi,
    const int* cross_src, const float* cross_cost, const int* inv_off, const int* inv_dst,
    const float* end_scores, const int* n_frames, float* alpha, float* gamma, float* xi,
    float* xi_cross, float* log_z, int B, int T, int S, int R, int L, int graph_per_item,
    int end_per_item, int eps_depth, int acc_smem, int threads, cudaStream_t stream) {
  if (B <= 0) return 0;
  BandedArgs a{nll,    band,       init,     blk,     starts,     ends,     start_pos,
               is_start, end_pos,  row_lo,   row_hi,  col_lo,     col_hi,   cross_src,
               cross_cost, inv_off, inv_dst, end_scores, n_frames, alpha,
               gamma,  xi,         xi_cross, log_z,   T,          S,        R,
               L,      graph_per_item, end_per_item, eps_depth, acc_smem};
  const size_t smem = 4 * banded_smem_floats(S, R, L, cross_src != nullptr, acc_smem);
  SRT_SET_SMEM(fb_banded_kernel, smem);
  fb_banded_kernel<<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int fb_dense_launch(const float* nll, const float* trans, const float* eps,
                               const float* init, const float* end_scores, const int* n_frames,
                               float* alpha, float* gamma, float* xi, float* log_z, int B,
                               int T, int S, int mats_per_item, int init_per_item,
                               int end_per_item, int eps_depth, int xi_dense, int mats_smem,
                               int acc_smem, int threads, cudaStream_t stream) {
  if (B <= 0) return 0;
  DenseArgs a{nll,       trans,         eps,
              init,      end_scores,    n_frames,
              alpha,     gamma,         xi,
              log_z,     T,             S,
              dense_ld(S), mats_per_item, init_per_item,
              end_per_item, eps_depth,  xi_dense,
              mats_smem, acc_smem};
  const size_t smem = 4 * dense_smem_floats(S, eps != nullptr, xi_dense, mats_smem, acc_smem);
  SRT_SET_SMEM(fb_dense_kernel, smem);
  fb_dense_kernel<<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
