// K24: Mahalanobis k-means of mixture splitting, and K25: diagonal-GMM EM.
// Each launch runs a batch of fits to convergence, one CTA a fit, over one
// shared frame buffer x [N, D] with a mask row per fit, and reads nothing
// back to the host.
//
// Neither replaces a TPU kernel: the JAX package runs each fit as one jitted
// lax.while_loop, K24 speech_recognition_tpu/train/kmeans.py kmeans (:50,
// its loop :91) and K25 speech_recognition_tpu/train/em.py em_fit (:57, its
// loop :95).  Their plain versions are train/kmeans.kmeans_ref and
// train/em.em_fit_ref, loops of tensor ops with a host read an iteration.
//
// K24, per fit: the initial assignment's ddof-1 statistics give the first
// variances (and, with kQuirk, cluster 0's variances for every distance and
// for the result); then each iteration assigns every frame of the fit to
// the cluster of least Gaussian NLL (the first minimum on a tie), takes
// counts, means and ddof-1 variances of the new assignment, keeps an empty
// cluster's centroid, and stops once the centroids pass allclose (rtol
// 1e-5, atol 1e-8) or at max_iters.  The frames outside the fit get their
// assignment in one last pass, from the last iteration's distances.
// K25, per fit: responsibilities by logsumexp of -nll + log w, the sums
// r, r x, r x^2 over the fit's frames, the M-step of em_update_from_stats
// (r clamped at 1e-10, variances floored, w = r / n_valid) and the stop on
// allclose of means, variances and weights (rtol / atol arguments).
//
// The NLL is the expanded quadratic form of ops/gmm.gmm_emission_weights:
// [x^2, x, 1] . [0.5 / var, -mu / var, const], so a kernel differs from the
// plain GEMM only in the order of its sums.  IEEE expf / logf, no fast math.
//
// What bounds them on the H100: an iteration is ~2 M D flops a frame twice
// (the distances, then the statistics) over a few hundred frames a fit, with
// a block barrier between the phases, so a fit is a chain of short
// latency-bound steps: a few microseconds an iteration against a bound of
// nanoseconds.  Design: a CTA a fit, so the fits of a batch (a word's
// states) run side by side; at the start the CTA compacts its fit's frame
// indices from its mask row with a block prefix sum and, where they fit
// (n_f <= cap, the plan's frame capacity), copies the frames into shared
// memory at an odd row stride (no bank conflicts a row a thread); a fit
// with more frames reads them from device memory (L2) each iteration and
// keeps its per-frame values in a device scratch.  The compacted indices
// and that scratch are rows of buffers shared by the launch: where no
// frame is in two fits (`disjoint`, as a word's states split one buffer)
// N rows, each fit's at the count of the frames in the mask rows before
// its own, which its CTA takes at the start; else F N rows, N a fit.
// The parameters and the
// partial sums live in shared memory, or in a device scratch a CTA where
// they do not fit (very wide features), through the same generic pointers.
// Sums over frames are per-thread partials over a fixed stride of frames
// (blocks of 32 summed plainly, the blocks' sums with Kahan's
// compensation), then added over the thread groups in a fixed order: no
// atomics, so two launches give the same bits.  The stop test is __syncthreads_or over each
// thread's "not close", one flag for the block.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// The parameter area of a fit with M mixtures (clusters) of D dimensions,
// in floats: the NLL weights w [M, 2D + 1], the means mu [M, D], the
// variances var [M, D], the weights or counts wt [M], log w [M], cluster
// 0's initial variances var0 [D], and the partial sums part [G, Q, 2] of
// the Q = M (D + 1) statistics (r x and r x^2 for each (m, d), then r for
// each m), G thread groups of QT threads each summing every G-th frame.
// ops/gmm_fit_kernels.py mirrors it (_param_floats).
struct Layout {
  int Dp, W, Q, QT, G;
  int w, mu, var, wt, lw, var0, part, fixed;
};

__host__ __device__ inline Layout fit_layout(int M, int D) {
  Layout L;
  L.Dp = D | 1;
  L.W = 2 * D + 1;
  L.Q = M * (D + 1);
  L.QT = L.Q < kThreads ? L.Q : kThreads;
  L.G = kThreads / L.QT;
  int o = 0;
  L.w = o;
  o += M * L.W;
  L.mu = o;
  o += M * D;
  L.var = o;
  o += M * D;
  L.wt = o;
  o += M;
  L.lw = o;
  o += M;
  L.var0 = o;
  o += D;
  L.part = o;
  o += 2 * L.G * L.Q;
  L.fixed = o;
  return L;
}

// One fit's frames: staged rows xs [n_f, Dp] in shared memory, or the rows
// of x [N, D] that idx names; val holds the per-frame values (the
// assignment, or M responsibilities).
struct Frames {
  const float* x;
  const int* idx;
  const float* xs;
  float* val;
  int nf, D, Dp;
  __device__ __forceinline__ const float* row(int j) const {
    return xs ? xs + (long long)j * Dp : x + (long long)idx[j] * D;
  }
};

// Exclusive prefix sum of v over the block; *total gets the block's sum.
__device__ int block_exclusive_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) wsum[lane] = s;
  }
  __syncthreads();
  *total = wsum[kWarps - 1];
  const int pre = (warp ? wsum[warp - 1] : 0) + x - v;
  __syncthreads();
  return pre;
}

// The nonzero bytes of masks[0, len) (bool bytes, 0 or 1), 16 at a load
// where aligned: the frames of the mask rows before a fit, its row offset
// in the scratch that disjoint fits share.
__device__ long long frames_before(const uint8_t* __restrict__ masks, long long len,
                                   int* wsum) {
  const long long head = min(len, (long long)((16 - ((uintptr_t)masks & 15)) & 15));
  const long long nv = (len - head) >> 4;
  const uint4* v = reinterpret_cast<const uint4*>(masks + head);
  int c = 0;
  for (long long e = threadIdx.x; e < head; e += kThreads) c += masks[e] != 0;
  for (long long e = threadIdx.x; e < nv; e += kThreads) {
    const uint4 u = v[e];
    c += __popc(u.x) + __popc(u.y) + __popc(u.z) + __popc(u.w);
  }
  for (long long e = head + (nv << 4) + threadIdx.x; e < len; e += kThreads)
    c += masks[e] != 0;
  int total;
  block_exclusive_scan(c, wsum, &total);
  return total;
}

// The fit's frame indices, in frame order, into idx where they are within
// its `room` rows; returns n_f.
__device__ int compact_frames(const uint8_t* __restrict__ mask, int N, int* idx, long long room,
                              int* wsum) {
  int nf = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int n = base + threadIdx.x;
    const int v = n < N && mask[n] != 0;
    int total;
    const int pos = nf + block_exclusive_scan(v, wsum, &total);
    if (v && pos < room) idx[pos] = n;
    nf += total;
  }
  __syncthreads();
  return nf;
}

// Compacts the fit's frames into idx (its `room` rows of the launch's
// index scratch) and stages them in `area` where n_f <= cap; else the
// frames stay in x and the values go to vals (its rows of the value
// scratch).  A fit of more than `room` frames is compacted only: the
// caller finds n_f > room and stops.
__device__ Frames fit_frames(const float* __restrict__ x, const uint8_t* mask, int N, int D,
                             int* idx, long long room, float* area, int cap, float* vals,
                             int* wsum) {
  Frames fr{x, idx, nullptr, nullptr, 0, D, D | 1};
  fr.nf = compact_frames(mask, N, idx, room, wsum);
  if (fr.nf > room) return fr;
  if (fr.nf <= cap) {
    float* xs = area;
    for (long long e = threadIdx.x; e < (long long)fr.nf * D; e += kThreads) {
      const int j = (int)(e / D), d = (int)(e % D);
      xs[(long long)j * fr.Dp + d] = x[(long long)idx[j] * D + d];
    }
    fr.xs = xs;
    fr.val = area + (long long)cap * fr.Dp;
  } else {
    fr.val = vals;
  }
  __syncthreads();
  return fr;
}

// w[m] = [0.5 / var, -mu / var, const] (ops/gmm.gmm_emission_weights with
// log_vars = log(var)); var row m is vsrc + m * vstride (vstride 0: one
// row for every mixture).  kRoundTrip: var is first taken through exp(log
// var), as em_step_stats hands it to pairwise_gaussian_nll.  A warp a
// mixture; the const's two sums over d are warp trees (fixed order).
template <bool kRoundTrip>
__device__ void build_weights(float* w, const float* mu, const float* vsrc, int vstride, int M,
                              int D, float dlog2pi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = 2 * D + 1;
  for (int m = warp; m < M; m += kWarps) {
    float s = 0.f, l = 0.f;
    for (int d = lane; d < D; d += 32) {
      float v = vsrc[m * vstride + d];
      if (kRoundTrip) v = expf(logf(v));
      const float lv = logf(v), iv = expf(-lv), u = mu[m * D + d];
      w[m * W + d] = 0.5f * iv;
      w[m * W + D + d] = -u * iv;
      s += u * u * iv;
      l += lv;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      l += __shfl_xor_sync(0xffffffffu, l, o);
    }
    if (lane == 0) w[m * W + 2 * D] = 0.5f * ((s + l) + dlog2pi);
  }
}

// The NLL of the frame row xr under mixture m of the weights w.
__device__ __forceinline__ float nll(const float* xr, const float* w, int m, int D) {
  const float* wm = w + m * (2 * D + 1);
  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    const float xv = xr[d];
    acc = fmaf(xv * xv, wm[d], acc);
    acc = fmaf(xv, wm[D + d], acc);
  }
  return acc + wm[2 * D];
}

// The cluster of least NLL (the first on a tie, as torch.argmin).
__device__ __forceinline__ int nearest(const float* xr, const float* w, int K, int D) {
  int best = 0;
  float bd = nll(xr, w, 0, D);
  for (int m = 1; m < K; ++m) {
    const float dm = nll(xr, w, m, D);
    if (dm < bd) {
      bd = dm;
      best = m;
    }
  }
  return best;
}

// s += v with Kahan's compensation c (no reassociation without fast math)
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c, t = s + y;
  c = (t - s) - y;
  s = t;
}

// Frames a thread sums plainly before it adds the block's sum to its
// compensated total: a fit of thousands of frames keeps the float error of
// a short sum, as the blocked GEMM of the plain version does.
constexpr int kSumBlock = 32;

// Per-fit statistics of the current values: part[0][q] = (sum r x, sum r
// x^2) for q = m D + d < M D, (sum r, -) for q = M D + m, where r is the
// responsibility (kEM) or [assignment == m].  Thread group g sums frames g,
// g + G, ... (kSumBlock of them at a time); the groups are then added in
// order g = 0, 1, ...
template <bool kEM>
__device__ void accumulate(const Frames& fr, float* part, const Layout& L, int M) {
  const int t = threadIdx.x, g = t / L.QT, D = fr.D, MD = M * D;
  if (g < L.G) {
    for (int q = t % L.QT; q < L.Q; q += L.QT) {
      const bool is_x = q < MD;
      const int m = is_x ? q / D : q - MD, d = is_x ? q % D : 0;
      float s1 = 0.f, s2 = 0.f, c1 = 0.f, c2 = 0.f;
      for (int j0 = g; j0 < fr.nf; j0 += kSumBlock * L.G) {
        const int j1 = min(fr.nf, j0 + kSumBlock * L.G);
        float b1 = 0.f, b2 = 0.f;
        for (int j = j0; j < j1; j += L.G) {
          const float r =
              kEM ? fr.val[(long long)j * M + m] : (fr.val[j] == (float)m ? 1.f : 0.f);
          if (is_x) {
            const float xv = fr.row(j)[d];
            b1 = fmaf(r, xv, b1);
            b2 = fmaf(r, xv * xv, b2);
          } else {
            b1 += r;
          }
        }
        kahan_add(s1, c1, b1);
        kahan_add(s2, c2, b2);
      }
      part[2 * (g * L.Q + q)] = s1;
      part[2 * (g * L.Q + q) + 1] = s2;
    }
  }
  __syncthreads();
  for (int q = t; q < L.Q; q += kThreads) {
    float s1 = part[2 * q], s2 = part[2 * q + 1];
    for (int h = 1; h < L.G; ++h) {
      s1 += part[2 * (h * L.Q + q)];
      s2 += part[2 * (h * L.Q + q) + 1];
    }
    part[2 * q] = s1;
    part[2 * q + 1] = s2;
  }
  __syncthreads();
}

__device__ __forceinline__ bool not_close(float a, float b, float rtol, float atol) {
  return !(fabsf(a - b) <= atol + rtol * fabsf(b));  // NaN is not close
}

// K-means' update from the statistics (train/kmeans.cluster_stats): counts,
// ddof-1 variances floored; with `first` (the initial assignment) the
// centroids stay, else they move to the means of non-empty clusters.
// Returns whether every centroid passed allclose (the same on every thread).
__device__ bool kmeans_update(float* P, const Layout& L, int K, int D, float var_floor,
                              bool first) {
  const float* part = P + L.part;
  int nc = 0;
  for (int q = threadIdx.x; q < L.Q; q += kThreads) {
    if (q < K * D) {
      const float c = part[2 * (K * D + q / D)];
      const float mean = part[2 * q] / fmaxf(c, 1.f);
      // the products rounded apart, as the plain version's (no contraction
      // into an FMA: a one-frame cluster's variance is then 0, so floored)
      const float v = (part[2 * q + 1] - __fmul_rn(__fmul_rn(c, mean), mean)) / fmaxf(c - 1.f, 1.f);
      P[L.var + q] = fmaxf(v, var_floor);
      if (!first) {
        const float old = P[L.mu + q], now = c > 0.f ? mean : old;
        nc |= not_close(now, old, 1e-5f, 1e-8f);
        P[L.mu + q] = now;
      }
    } else {
      P[L.wt + q - K * D] = part[2 * q];
    }
  }
  return !__syncthreads_or(nc);
}

// EM's M-step (train/em.em_update_from_stats) and its stop test.
__device__ bool em_update(float* P, const Layout& L, int M, int D, float n_valid, float rtol,
                          float atol, float var_floor) {
  const float* part = P + L.part;
  int nc = 0;
  for (int q = threadIdx.x; q < L.Q; q += kThreads) {
    if (q < M * D) {
      const float den = fmaxf(part[2 * (M * D + q / D)], 1e-10f);
      const float mean = part[2 * q] / den;
      const float v = fmaxf(part[2 * q + 1] / den - __fmul_rn(mean, mean), var_floor);
      nc |= not_close(mean, P[L.mu + q], rtol, atol) | not_close(v, P[L.var + q], rtol, atol);
      P[L.mu + q] = mean;
      P[L.var + q] = v;
    } else {
      const float wn = part[2 * q] / fmaxf(n_valid, 1e-10f);
      nc |= not_close(wn, P[L.wt + q - M * D], rtol, atol);
      P[L.wt + q - M * D] = wn;
    }
  }
  return !__syncthreads_or(nc);
}

// A fit's row offset in the launch's scratch and the rows left from it:
// with `disjoint`, the frames of the mask rows before its own, in N rows;
// else f N, in F N rows.
__device__ longlong2 fit_rows(const uint8_t* masks, int N, int disjoint, int* wsum) {
  const long long f = blockIdx.x;
  const long long off = disjoint ? frames_before(masks, f * N, wsum) : f * N;
  return make_longlong2(off, (disjoint ? (long long)N : (long long)gridDim.x * N) - off);
}

// A fit whose frames overrun the scratch rows left to it (fits that share
// frames launched as disjoint): every output NaN, its iteration count -1.
__device__ void overrun(float* a, long long na, float* b, long long nb, float* c,
                        long long nc, int* n_iters) {
  for (long long e = threadIdx.x; e < na; e += kThreads) a[e] = NAN;
  for (long long e = threadIdx.x; e < nb; e += kThreads) b[e] = NAN;
  for (long long e = threadIdx.x; e < nc; e += kThreads) c[e] = NAN;
  if (threadIdx.x == 0 && n_iters) n_iters[blockIdx.x] = -1;
}

// x [N, D] f32; masks [F, N] bool; c0 [F, K, D]; init [F, N] int64 ->
// assign [F, N] int64, cent / vars [F, K, D], counts [F, K], and each
// fit's iteration count into n_iters [F] int32 where given; idx [rows]
// int32 scratch; vscratch [rows] where a fit may pass cap frames;
// pscratch [F, fixed] where the parameters are not in shared memory;
// rows N with `disjoint`, else F N.
template <bool kQuirk>
__global__ void __launch_bounds__(kThreads) kmeans_fit_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ masks,
    const float* __restrict__ c0, const long long* __restrict__ init, long long* assign,
    float* cent, float* vars, float* counts, int* n_iters, int* idx, float* vscratch,
    float* pscratch, int N, int D, int K, int disjoint, int max_iters, float var_floor,
    float dlog2pi, int cap, int params_in_smem) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int wsum[kWarps];
  const int f = blockIdx.x, t = threadIdx.x;
  const Layout L = fit_layout(K, D);
  float* P = params_in_smem ? smem : pscratch + (long long)f * L.fixed;
  float* area = params_in_smem ? smem + L.fixed : smem;
  const uint8_t* mask = masks + (long long)f * N;
  const long long* finit = init + (long long)f * N;
  long long* fassign = assign + (long long)f * N;
  const long long KD = (long long)K * D;
  const longlong2 rows = fit_rows(masks, N, disjoint, wsum);
  const Frames fr = fit_frames(x, mask, N, D, idx + rows.x, rows.y, area, cap,
                               vscratch + rows.x, wsum);
  if (fr.nf > rows.y) {
    overrun(cent + f * KD, KD, vars + f * KD, KD, counts + (long long)f * K, K, n_iters);
    for (int n = t; n < N; n += kThreads) fassign[n] = -1;
    return;
  }
  for (int q = t; q < K * D; q += kThreads) P[L.mu + q] = c0[(long long)f * K * D + q];
  // the initial assignment's statistics: the first variances
  for (int j = t; j < fr.nf; j += kThreads) fr.val[j] = (float)finit[fr.idx[j]];
  __syncthreads();
  accumulate<false>(fr, P + L.part, L, K);
  kmeans_update(P, L, K, D, var_floor, true);
  for (int d = t; d < D; d += kThreads) P[L.var0 + d] = P[L.var + d];
  __syncthreads();
  int it = 0;
  while (it < max_iters) {
    build_weights<false>(P + L.w, P + L.mu, kQuirk ? P + L.var0 : P + L.var, kQuirk ? 0 : D, K,
                         D, dlog2pi);
    __syncthreads();
    for (int j = t; j < fr.nf; j += kThreads) {
      const int a = nearest(fr.row(j), P + L.w, K, D);
      fr.val[j] = (float)a;
      fassign[fr.idx[j]] = a;
    }
    __syncthreads();
    accumulate<false>(fr, P + L.part, L, K);
    const bool done = kmeans_update(P, L, K, D, var_floor, false);
    ++it;
    if (done) break;
  }
  // the frames outside the fit: the last iteration's distances (the
  // initial assignment where no iteration ran)
  for (int n = t; n < N; n += kThreads) {
    if (it == 0)
      fassign[n] = finit[n];
    else if (!mask[n])
      fassign[n] = nearest(x + (long long)n * D, P + L.w, K, D);
  }
  for (int q = t; q < K * D; q += kThreads) {
    cent[(long long)f * K * D + q] = P[L.mu + q];
    vars[(long long)f * K * D + q] = kQuirk ? P[L.var0 + q % D] : P[L.var + q];
  }
  for (int m = t; m < K; m += kThreads) counts[(long long)f * K + m] = P[L.wt + m];
  if (t == 0 && n_iters) n_iters[f] = it;
}

// x [N, D]; masks [F, N]; m0 / v0 [F, M, D]; w0 [F, M] -> means / vars
// [F, M, D], wts [F, M], n_iters [F] int32; scratch as K24's, vscratch
// [rows, M].
__global__ void __launch_bounds__(kThreads) em_fit_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ masks,
    const float* __restrict__ m0, const float* __restrict__ v0, const float* __restrict__ w0,
    float* means, float* vars, float* wts, int* n_iters, int* idx, float* vscratch,
    float* pscratch, int N, int D, int M, int disjoint, int max_iters, float rtol, float atol,
    float var_floor, float dlog2pi, int cap, int params_in_smem) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int wsum[kWarps];
  const int f = blockIdx.x, t = threadIdx.x;
  const Layout L = fit_layout(M, D);
  float* P = params_in_smem ? smem : pscratch + (long long)f * L.fixed;
  float* area = params_in_smem ? smem + L.fixed : smem;
  const long long MD = (long long)M * D;
  const longlong2 rows = fit_rows(masks, N, disjoint, wsum);
  const Frames fr = fit_frames(x, masks + (long long)f * N, N, D, idx + rows.x, rows.y, area,
                               cap, vscratch + rows.x * M, wsum);
  if (fr.nf > rows.y) {
    overrun(means + f * MD, MD, vars + f * MD, MD, wts + (long long)f * M, M, n_iters);
    return;
  }
  for (int q = t; q < M * D; q += kThreads) {
    P[L.mu + q] = m0[(long long)f * M * D + q];
    P[L.var + q] = v0[(long long)f * M * D + q];
  }
  for (int m = t; m < M; m += kThreads) P[L.wt + m] = w0[(long long)f * M + m];
  __syncthreads();
  const float n_valid = (float)fr.nf;
  int it = 0;
  while (it < max_iters) {
    build_weights<true>(P + L.w, P + L.mu, P + L.var, D, M, D, dlog2pi);
    for (int m = t; m < M; m += kThreads) P[L.lw + m] = logf(P[L.wt + m]);
    __syncthreads();
    // responsibilities: exp(lp - logsumexp(lp)), lp = -nll + log w (a
    // maximum of +-inf counts as 0, as torch.logsumexp takes it)
    for (int j = t; j < fr.nf; j += kThreads) {
      const float* xr = fr.row(j);
      float* r = fr.val + (long long)j * M;
      float mx = -INFINITY;
      for (int m = 0; m < M; ++m) {
        r[m] = -nll(xr, P + L.w, m, D) + P[L.lw + m];
        mx = fmaxf(mx, r[m]);
      }
      if (isinf(mx)) mx = 0.f;
      float s = 0.f;
      for (int m = 0; m < M; ++m) s += expf(r[m] - mx);
      const float lse = logf(s) + mx;
      for (int m = 0; m < M; ++m) r[m] = expf(r[m] - lse);
    }
    __syncthreads();
    accumulate<true>(fr, P + L.part, L, M);
    const bool done = em_update(P, L, M, D, n_valid, rtol, atol, var_floor);
    ++it;
    if (done) break;
  }
  for (int q = t; q < M * D; q += kThreads) {
    means[(long long)f * M * D + q] = P[L.mu + q];
    vars[(long long)f * M * D + q] = P[L.var + q];
  }
  for (int m = t; m < M; m += kThreads) wts[(long long)f * M + m] = P[L.wt + m];
  if (t == 0) n_iters[f] = it;
}

// The launch contract both launchers check: `smem` is the plan's dynamic
// shared memory, the parameter area (where params_in_smem) and cap frames
// of Dp + vstride floats.
int check_plan(int F, int N, int D, int M, int max_iters, int cap, int params_in_smem,
               long long smem, int vstride, const float* vscratch, const float* pscratch) {
  if (F <= 0 || N < 0 || D <= 0 || M <= 0 || max_iters < 0 || cap < 0 || cap > N)
    return (int)cudaErrorInvalidValue;
  const Layout L = fit_layout(M, D);
  const long long need =
      4LL * ((params_in_smem ? L.fixed : 0) + (long long)cap * (L.Dp + vstride));
  if (need != smem || (cap < N && !vscratch) || (!params_in_smem && !pscratch))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int kmeans_fit_launch(const float* x, const uint8_t* masks, const float* c0,
                                 const long long* init, long long* assign, float* cent,
                                 float* vars, float* counts, int* n_iters, int* idx,
                                 float* vscratch, float* pscratch, int F, int N, int D, int K,
                                 int disjoint, int max_iters, float var_floor, float dlog2pi,
                                 int quirk, int cap, int params_in_smem, long long smem,
                                 void* stream) {
  const int rc =
      check_plan(F, N, D, K, max_iters, cap, params_in_smem, smem, 1, vscratch, pscratch);
  if (rc) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  if (quirk) {
    SRT_SET_SMEM(kmeans_fit_kernel<true>, smem);
    kmeans_fit_kernel<true><<<F, kThreads, smem, st>>>(
        x, masks, c0, init, assign, cent, vars, counts, n_iters, idx, vscratch, pscratch, N, D, K,
        disjoint, max_iters, var_floor, dlog2pi, cap, params_in_smem);
  } else {
    SRT_SET_SMEM(kmeans_fit_kernel<false>, smem);
    kmeans_fit_kernel<false><<<F, kThreads, smem, st>>>(
        x, masks, c0, init, assign, cent, vars, counts, n_iters, idx, vscratch, pscratch, N, D, K,
        disjoint, max_iters, var_floor, dlog2pi, cap, params_in_smem);
  }
  return (int)cudaGetLastError();
}

extern "C" int em_fit_launch(const float* x, const uint8_t* masks, const float* m0,
                             const float* v0, const float* w0, float* means, float* vars,
                             float* wts, int* n_iters, int* idx, float* vscratch,
                             float* pscratch, int F, int N, int D, int M, int disjoint,
                             int max_iters, float rtol, float atol, float var_floor,
                             float dlog2pi, int cap, int params_in_smem, long long smem,
                             void* stream) {
  const int rc =
      check_plan(F, N, D, M, max_iters, cap, params_in_smem, smem, M, vscratch, pscratch);
  if (rc) return rc;
  SRT_SET_SMEM(em_fit_kernel, smem);
  em_fit_kernel<<<F, kThreads, smem, (cudaStream_t)stream>>>(
      x, masks, m0, v0, w0, means, vars, wts, n_iters, idx, vscratch, pscratch, N, D, M,
      disjoint, max_iters, rtol, atol, var_floor, dlog2pi, cap, params_in_smem);
  return (int)cudaGetLastError();
}
