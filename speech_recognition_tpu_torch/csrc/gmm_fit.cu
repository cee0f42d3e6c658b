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
// variances (and, with the quirk, cluster 0's variances for every distance
// and for the result); then each iteration assigns every frame of the fit
// to the cluster of least Gaussian NLL (the first minimum on a tie), takes
// counts, means and ddof-1 variances of the new assignment, keeps an empty
// cluster's centroid, and stops once the centroids pass allclose (rtol
// 1e-5, atol 1e-8) or at max_iters.  Every frame of the buffer gets its
// assignment in one last pass, from the last iteration's weights.
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
// (the distances, then the statistics) over a few hundred to a few thousand
// frames a fit, so a fit is a chain of short latency-bound steps, a few
// microseconds an iteration against a bound of nanoseconds; the serial
// floor of utils/roofline.gmm_fit_floor is the honest yardstick.  Design,
// a CTA a fit (the fits of a batch, a word's states, side by side):
//   - compile-time widths: an instance for D = 39 at M = 1, 2 and 4 (the
//     shapes training runs), so the loops unroll and no division is left
//     in them; one generic instance for any other D or M;
//   - the frames of a fit in shared memory, at a row stride of D rounded
//     up to an odd number of float4s (44 at D = 39: a quarter-warp's
//     16-byte loads of 8 rows hit 32 distinct banks): staged once where
//     they fit (n_f <= cap, ~1,000 at D = 39), else gathered once into a
//     compact device scratch in fit order and streamed through a ring of
//     shared-memory stages by bulk copies (cp.async.bulk, an mbarrier a
//     stage), so no phase issues a dependent L2 load a frame;
//   - one fused pass over a tile an iteration: a thread two frames
//     computes their M NLLs as independent chains from float4 loads of
//     the rows and broadcast float4 loads of the weights, each loaded once
//     for both frames (K25 also the responsibilities), a barrier, then a
//     thread a (4-dim block, frame group) adds the tile's statistics of
//     every mixture into registers, its row block loaded once;
//   - the groups' partial sums are added in a fixed tree by one or two
//     warps a mixture, which also take the M-step, the next iteration's
//     weights (two buffers, so K24's last pass reads the weights that gave
//     the final assignment) and the stop flag: with the tile's barrier,
//     three barriers an iteration for a staged fit;
//   - parameters and partial sums in shared memory (the instances' own
//     shared-memory accesses, no generic pointer in the loop), else, past
//     ~227 KB of them (D ~ 2,500 at M = 4) or 256 owners (4 mixtures x 4
//     dims: D ~ 1,000), the device instance: parameters, frames and
//     per-frame values in device scratch.
// The statistics are sums of r (x - ref) and r (x - ref)^2 about each
// mixture's start ref, so a variance keeps its digits where its mean is
// far from 0 (the plain version's raw sums lose ~1e-5 of a variance of 1
// at means ~5).  Sums over frames are per-thread blocks of 32 frames
// summed plainly, the blocks' sums with Kahan's compensation, then the
// groups added as a pairwise tree: no atomics, so two launches give the
// same bits.  The compacted indices and the frame scratch are rows of
// buffers shared by the launch: where no frame is in two fits
// (`disjoint`, as a word's states split one buffer) N rows, each fit's at
// the count of the frames in the mask rows before its own, which its CTA
// takes at the start; else F N rows, N a fit.  With a trace, thread 0
// counts each fit's cycles by phase (clock64).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
// Frames a thread sums plainly before it adds the block's sum to its
// compensated total: a fit of thousands of frames keeps the float error of
// a short sum, as the blocked GEMM of the plain version does.
constexpr int kSumBlock = 32;

enum Kind { kKmeans = 0, kKmeansQuirk = 1, kEm = 2 };

// Mixtures an owner of the statistics takes at most (all of them at the
// compile-time widths, M <= 4).
constexpr int kChunk = 4;

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }
// a staged row's floats: D rounded up to an odd number of float4s
__host__ __device__ constexpr int row_stride(int D) { return 4 * (((D + 3) / 4) | 1); }

// The parameter area of a fit with M mixtures (clusters) of D dimensions,
// in floats, each part a multiple of 4: two buffers of NLL weights (w1 =
// 0.5 / var and w2 = -mu / var [M, Dq], zero past D, and the constants
// [M]), the means mu, their start ref (the statistics' origin) and the
// variances var [M, D], the weights or counts wt
// [M], log w [M], cluster 0's initial variances var0 [D], and the groups'
// partial sums part [G, QS]: sum r x at m Dq + d, sum r x^2 at M Dq + m Dq
// + d, sum r at 2 M Dq + m.  O = ceil(M / 4) NB owners (up to 4 mixtures
// and a block of 4 dims) of G frame groups each (at most 32: the M-step's
// tree has 32 slots).  ops/gmm_fit_kernels.py mirrors it
// (_param_floats).
struct Layout {
  int Dq, NB, O, G, QS;
  int MDq, wbuf;  // M Dq; the floats of one buffer of weights (at i wbuf)
  int mu, ref, var, wt, lw, var0, part, fixed;
  __host__ __device__ int w1(int i) const { return i * wbuf; }
  __host__ __device__ int w2(int i) const { return i * wbuf + MDq; }
  __host__ __device__ int wc(int i) const { return i * wbuf + 2 * MDq; }
};

__host__ __device__ inline Layout fit_layout(int M, int D) {
  Layout L;
  L.Dq = row_stride(D);
  L.NB = (D + 3) / 4;
  L.O = (M + kChunk - 1) / kChunk * L.NB;
  L.G = L.O <= kThreads ? min(32, kThreads / L.O) : 1;
  L.QS = round4(2 * M * L.Dq + M);
  L.MDq = M * L.Dq;
  L.wbuf = 2 * L.MDq + round4(M);
  int o = 2 * L.wbuf;
  L.mu = o;
  o += round4(M * D);
  L.ref = o;
  o += round4(M * D);
  L.var = o;
  o += round4(M * D);
  L.wt = o;
  o += round4(M);
  L.lw = o;
  o += round4(M);
  L.var0 = o;
  o += round4(D);
  L.part = o;
  o += L.G * L.QS;
  L.fixed = o;
  return L;
}

// The dynamic shared memory of a launch in floats: the parameter area
// (shared tiers) and a frame area for `cap` staged frames or a ring of
// `stages` tiles of `tile` frames with two tiles of per-frame values (V
// floats a frame: K24's assignment, K25's M responsibilities).
__host__ __device__ inline long long smem_floats(const Layout& L, int cap, int tile, int stages,
                                                 int V) {
  const long long staged = (long long)cap * (L.Dq + V);
  const long long ring = (long long)stages * tile * L.Dq + 2LL * tile * V;
  return L.fixed + (staged > ring ? staged : ring);
}

struct FitArgs {
  const float* x;          // [N, D]
  const uint8_t* masks;    // [F, N]
  const float* p0;         // K24 centroids0 / K25 means0 [F, M, D]
  const float* v0;         // K25 variances0 [F, M, D]
  const float* w0;         // K25 weights0 [F, M]
  const long long* init;   // K24 draws [F, N]
  long long* assign;       // K24 [F, N]
  float* mu_out;           // [F, M, D]
  float* var_out;          // [F, M, D]
  float* w_out;            // K24 counts / K25 weights [F, M]
  int* n_iters;            // [F] (K24: may be null)
  int* idx;                // [rows] compacted frame indices
  float* frames;           // [rows, Dq] fits past cap (ring, device tier)
  float* vals;             // [rows, V] device tier
  float* pscratch;         // [F, fixed] device tier
  long long* trace;        // [F, 8] or null
  int N, D, M, disjoint, max_iters, cap, tile, stages;
  float var_floor, dlog2pi, rtol, atol;
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
  // eight 16-byte loads in flight a thread
  for (long long e0 = threadIdx.x; e0 < nv; e0 += 8 * kThreads) {
    uint4 u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      u[i] = e0 + i * kThreads < nv ? v[e0 + i * kThreads] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      c += __popc(u[i].x) + __popc(u[i].y) + __popc(u[i].z) + __popc(u[i].w);
  }
  for (long long e = head + (nv << 4) + threadIdx.x; e < len; e += kThreads)
    c += masks[e] != 0;
  int total;
  block_exclusive_scan(c, wsum, &total);
  return total;
}

// The fit's frame indices, in frame order, into idx where they are within
// its `room` rows (16 mask bytes a thread a block scan); returns n_f.
__device__ int compact_frames(const uint8_t* __restrict__ mask, int N, int* idx, long long room,
                              int* wsum) {
  int nf = 0;
  for (int base = 0; base < N; base += 16 * kThreads) {
    const int lo = base + 16 * threadIdx.x;
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (lo + i < N && mask[lo + i] != 0) bits |= 1u << i;
    int total;
    int pos = nf + block_exclusive_scan(__popc(bits), wsum, &total);
    for (; bits; bits &= bits - 1, ++pos)
      if (pos < room) idx[pos] = lo + __ffs((int)bits) - 1;
    nf += total;
  }
  __syncthreads();
  return nf;
}

// A fit's row offset in the launch's scratch and the rows left from it:
// with `disjoint`, the frames of the mask rows before its own, in N rows;
// else f N, in F N rows.
__device__ longlong2 fit_rows(const uint8_t* masks, int N, int disjoint, int* wsum) {
  const long long f = blockIdx.x;
  const long long off = disjoint ? frames_before(masks, f * N, wsum) : f * N;
  return make_longlong2(off, (disjoint ? (long long)N : (long long)gridDim.x * N) - off);
}

__device__ __forceinline__ bool not_close(float a, float b, float rtol, float atol) {
  return !(fabsf(a - b) <= atol + rtol * fabsf(b));  // NaN is not close
}

// s += v with Kahan's compensation c (no reassociation without fast math)
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c, t = s + y;
  c = (t - s) - y;
  s = t;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The NLLs of kF frames under every mixture at compile-time widths:
// get(f, k) gives frame f's float4 k (zero past D), the weights w1 / w2
// [M, Dq] and wc [M]; for each frame and mixture a chain of x^2 w1 and one
// of x w2, all side by side, each weight loaded once for the kF frames (a
// broadcast load costs a shared-memory cycle a float: kF frames a thread
// share it).
template <int kD, int kM, int kF, typename Get>
__device__ __forceinline__ void nlls_fixed(Get get, const float* w1, const float* w2,
                                           const float* wc, float (&nll)[kF][kM]) {
  constexpr int NB = (kD + 3) / 4, Dq = row_stride(kD);
  float a[kF][kM], b[kF][kM];
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int m = 0; m < kM; ++m) a[f][m] = b[f][m] = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float4 x[kF], x2[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      x[f] = get(f, k);
      x2[f] = make_float4(__fmul_rn(x[f].x, x[f].x), __fmul_rn(x[f].y, x[f].y),
                          __fmul_rn(x[f].z, x[f].z), __fmul_rn(x[f].w, x[f].w));
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float4 u = ld4(w1 + m * Dq + 4 * k), v = ld4(w2 + m * Dq + 4 * k);
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        a[f][m] = fmaf(x2[f].x, u.x, a[f][m]);
        a[f][m] = fmaf(x2[f].y, u.y, a[f][m]);
        a[f][m] = fmaf(x2[f].z, u.z, a[f][m]);
        a[f][m] = fmaf(x2[f].w, u.w, a[f][m]);
        b[f][m] = fmaf(x[f].x, v.x, b[f][m]);
        b[f][m] = fmaf(x[f].y, v.y, b[f][m]);
        b[f][m] = fmaf(x[f].z, v.z, b[f][m]);
        b[f][m] = fmaf(x[f].w, v.w, b[f][m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float c = wc[m];
#pragma unroll
    for (int f = 0; f < kF; ++f) nll[f][m] = (a[f][m] + b[f][m]) + c;
  }
}

// The NLL of the row xr (D floats) under mixture m at runtime widths.
__device__ __forceinline__ float nll_generic(const float* xr, const float* w1, const float* w2,
                                             const float* wc, int m, int D, int Dq) {
  float a = 0.f, b = 0.f;
  for (int d = 0; d < D; ++d) {
    const float x = xr[d];
    a = fmaf(__fmul_rn(x, x), w1[m * Dq + d], a);
    b = fmaf(x, w2[m * Dq + d], b);
  }
  return (a + b) + wc[m];
}

// The cluster of least NLL (the first on a tie, as torch.argmin).
template <int kM>
__device__ __forceinline__ int first_min(const float (&nll)[kM]) {
  int best = 0;
  float bd = nll[0];
#pragma unroll
  for (int m = 1; m < kM; ++m)
    if (nll[m] < bd) {
      bd = nll[m];
      best = m;
    }
  return best;
}

// Weights of one iteration: buffer `i` of the parameter area.
struct Weights {
  const float* w1;
  const float* w2;
  const float* wc;
};

__device__ __forceinline__ Weights weights(const float* P, const Layout& L, int i) {
  return Weights{P + L.w1(i), P + L.w2(i), P + L.wc(i)};
}

// Frames' values: K24 a frame's nearest cluster, K25 its M
// responsibilities exp(lp - logsumexp(lp)), lp = -nll + log w (a maximum
// of +-inf counts as 0, as torch.logsumexp takes it).  At compile-time
// widths kF frames at once from get(f, k) (zero past D) into val[f][0, V).
template <int kKind, int kD, int kM, int kF, typename Get>
__device__ __forceinline__ void values_fixed(Get get, const Weights& W, const float* lw,
                                             float (&val)[kF][kM]) {
  float nll[kF][kM];
  nlls_fixed<kD, kM, kF>(get, W.w1, W.w2, W.wc, nll);
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if constexpr (kKind != kEm) {
      val[f][0] = (float)first_min<kM>(nll[f]);
    } else {
      float lp[kM], mx = -INFINITY;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        lp[m] = -nll[f][m] + lw[m];
        mx = fmaxf(mx, lp[m]);
      }
      if (isinf(mx)) mx = 0.f;
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) s += expf(lp[m] - mx);
      const float lse = logf(s) + mx;
#pragma unroll
      for (int m = 0; m < kM; ++m) val[f][m] = expf(lp[m] - lse);
    }
  }
}

// ... at runtime widths one frame, its row row[0, D), into val[0, V).
template <int kKind>
__device__ __forceinline__ void value_generic(const float* row, const Weights& W, const float* lw,
                                              float* val, int D, int M, int Dq) {
  if constexpr (kKind != kEm) {
    int best = 0;
    float bd = nll_generic(row, W.w1, W.w2, W.wc, 0, D, Dq);
    for (int m = 1; m < M; ++m) {
      const float dm = nll_generic(row, W.w1, W.w2, W.wc, m, D, Dq);
      if (dm < bd) {
        bd = dm;
        best = m;
      }
    }
    val[0] = (float)best;
  } else {
    float mx = -INFINITY;
    for (int m = 0; m < M; ++m) {
      val[m] = -nll_generic(row, W.w1, W.w2, W.wc, m, D, Dq) + lw[m];
      mx = fmaxf(mx, val[m]);
    }
    if (isinf(mx)) mx = 0.f;
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += expf(val[m] - mx);
    const float lse = logf(s) + mx;
    for (int m = 0; m < M; ++m) val[m] = expf(val[m] - lse);
  }
}

// The values of a tile's nk rows (row stride Dq) into vals (V a frame):
// at compile-time widths a thread takes kF frames, j, j + H, ... (H =
// ceil(nk / kF), so the threads' loads of a frame f are of neighbouring
// rows).
template <int kKind, int kD, int kM, int kF>
__device__ __forceinline__ void tile_values(const float* rows, int nk, const Weights& W,
                                            const float* lw, float* vals, int D, int M, int Dq,
                                            int V) {
  if constexpr (kD != 0) {
    const int H = (nk + kF - 1) / kF;
    for (int j = threadIdx.x; j < H; j += kThreads) {
      float val[kF][kM];
      values_fixed<kKind, kD, kM, kF>(
          [&](int f, int c) { return ld4(rows + min(j + f * H, nk - 1) * Dq + 4 * c); }, W, lw,
          val);
#pragma unroll
      for (int f = 0; f < kF; ++f)
        if (j + f * H < nk)
#pragma unroll
          for (int m = 0; m < (kKind == kEm ? kM : 1); ++m) vals[(j + f * H) * V + m] = val[f][m];
    }
  } else {
    for (int j = threadIdx.x; j < nk; j += kThreads)
      value_generic<kKind>(rows + (long long)j * Dq, W, lw, vals + (long long)j * V, D, M, Dq);
  }
}

// One owner's running sums: mixtures m0 .. m0 + kMC - 1 (those below M)
// of a 4-dim block b, over its group g of frames; sum r x, sum r x^2 over
// the 4 dims and sum r, each with its Kahan compensation.
template <int kMC>
struct Acc {
  float s1[kMC][4], c1[kMC][4], s2[kMC][4], c2[kMC][4], sr[kMC], cr[kMC];
};

template <int kMC>
__device__ __forceinline__ void acc_zero(Acc<kMC>& A) {
#pragma unroll
  for (int i = 0; i < kMC; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) A.s1[i][c] = A.c1[i][c] = A.s2[i][c] = A.c2[i][c] = 0.f;
    A.sr[i] = A.cr[i] = 0.f;
  }
}

// The tile's frames g, g + G, ... into the owner's sums, kSumBlock of them
// at a time: r the responsibility (K25) or [assignment == m] (K24), the
// sums of r (x - ref) and r (x - ref)^2 with ref mixture m's mean at the
// fit's start (ref[i]: the owner's 4 dims of mixture m0 + i), so a
// variance keeps its digits where the mean is far from 0, and a pass over
// the same values gives the same sums (the stops of the plain version).  A frame's row
// block is loaded once for the owner's kMC mixtures; kAll: the owner takes
// every mixture (M = kMC at compile time), so K25's M responsibilities of
// a frame are one vector load.
template <bool kEM, int kMC, bool kAll>
__device__ __forceinline__ void accumulate(Acc<kMC>& A, const float* rows, const float* vals,
                                           const float4 (&ref)[kMC], int nk, int m0, int b, int g,
                                           int G, int M, int Dq) {
  for (int j0 = g; j0 < nk; j0 += kSumBlock * G) {
    const int j1 = min(nk, j0 + kSumBlock * G);
    float b1[kMC][4], b2[kMC][4], br[kMC];
#pragma unroll
    for (int i = 0; i < kMC; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) b1[i][c] = b2[i][c] = 0.f;
      br[i] = 0.f;
    }
#pragma unroll 2
    for (int j = j0; j < j1; j += G) {
      const float4 x = ld4(rows + j * Dq + 4 * b);
      float r[kMC];
      if constexpr (kEM && kAll && kMC == 4) {
        const float4 q = ld4(vals + j * 4);
        r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
      } else if constexpr (kEM && kAll && kMC == 2) {
        const float2 q = *reinterpret_cast<const float2*>(vals + j * 2);
        r[0] = q.x, r[1] = q.y;
      } else {
#pragma unroll
        for (int i = 0; i < kMC; ++i) {
          const int m = m0 + i;
          r[i] = kEM ? (m < M ? vals[j * M + m] : 0.f) : (vals[j] == (float)m ? 1.f : 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < kMC; ++i) {
        const float xs[4] = {x.x - ref[i].x, x.y - ref[i].y, x.z - ref[i].z, x.w - ref[i].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          b1[i][c] = fmaf(r[i], xs[c], b1[i][c]);
          b2[i][c] = fmaf(r[i], __fmul_rn(xs[c], xs[c]), b2[i][c]);
        }
        br[i] += r[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kMC; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kahan_add(A.s1[i][c], A.c1[i][c], b1[i][c]);
        kahan_add(A.s2[i][c], A.c2[i][c], b2[i][c]);
      }
      kahan_add(A.sr[i], A.cr[i], br[i]);
    }
  }
}

// The owner's sums into its group's row of the partial sums.
template <int kMC>
__device__ __forceinline__ void store_partials(const Acc<kMC>& A, float* part, const Layout& L,
                                               int M, int m0, int b, int g) {
#pragma unroll
  for (int i = 0; i < kMC; ++i) {
    const int m = m0 + i;
    if (m < M) {
      float* p = part + g * L.QS + m * L.Dq + 4 * b;
      *reinterpret_cast<float4*>(p) = make_float4(A.s1[i][0], A.s1[i][1], A.s1[i][2], A.s1[i][3]);
      *reinterpret_cast<float4*>(p + M * L.Dq) =
          make_float4(A.s2[i][0], A.s2[i][1], A.s2[i][2], A.s2[i][3]);
      if (b == 0) part[g * L.QS + 2 * M * L.Dq + m] = A.sr[i];
    }
  }
}

// The M-step's modes: weights of the start alone (K25), the initial
// assignment's statistics (K24: variances, counts; centroids stay), an
// iteration's update with its stop test.
enum Mode { kStart = 0, kFirst = 1, kIter = 2 };

// The groups' partials for statistic q added as a pairwise tree over 32
// slots (zero past G): ((g0 + g1) + (g2 + g3)) + ..., five adds deep and
// as accurate as a pairwise sum (tests/k24_k25_fit.py).
__device__ __forceinline__ float group_sum(const float* part, const Layout& L, int q) {
  float v[32];
#pragma unroll
  for (int g = 0; g < 32; ++g) v[g] = g < L.G ? part[g * L.QS + q] : 0.f;
#pragma unroll
  for (int g = 0; g < 16; ++g) v[g] = v[2 * g] + v[2 * g + 1];
#pragma unroll
  for (int g = 0; g < 8; ++g) v[g] = v[2 * g] + v[2 * g + 1];
#pragma unroll
  for (int g = 0; g < 4; ++g) v[g] = v[2 * g] + v[2 * g + 1];
  v[0] = v[0] + v[1];
  v[1] = v[2] + v[3];
  return v[0] + v[1];
}

// ddof-1 variance of a cluster from its sums about its start ref (sum r (x
// - ref), sum r (x - ref)^2; train/kmeans.cluster_stats about 0), its mean
// ref + *shift; the products rounded apart, as the plain version's: a
// one-frame cluster's variance is then 0, so floored
__device__ __forceinline__ float kmeans_var(float s1, float s2, float c, float var_floor,
                                            float* shift) {
  *shift = s1 / fmaxf(c, 1.f);
  const float v = (s2 - __fmul_rn(__fmul_rn(c, *shift), *shift)) / fmaxf(c - 1.f, 1.f);
  return fmaxf(v, var_floor);
}

// One or two warps a mixture: the groups' sums, the update of `mode`, the
// weights into buffer `wb` (w = [0.5 / v, -mu / v, const] with v the
// variance the distances take: K24's own or, with the quirk, cluster 0's
// initial one; K25's through exp(log v), as em_step_stats hands it to
// pairwise_gaussian_nll), the constants' two sums over d as warp trees
// (of two warps: the second's added to the first's; `pair` [2 M] floats of
// shared memory).
// Returns whether every parameter passed allclose (the same on every
// thread); the closing barrier publishes the parameters and weights.
template <int kKind>
__device__ __forceinline__ bool update(float* P, const Layout& L, int M, int D, int mode, int wb,
                                       float n_valid, float var_floor, float rtol, float atol,
                                       float dlog2pi, float* pair) {
  constexpr bool kEM = kKind == kEm, kQuirk = kKind == kKmeansQuirk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, Dq = L.Dq;
  const float* part = P + L.part;
  const int q_r = 2 * M * Dq;  // the sums of r
  // two warps a mixture where they are free and D passes a warp: the
  // second takes d = 32 + lane, 96 + lane, ... and hands its constant's
  // sums to the first over a barrier of the pair
  const int halves = 2 * M <= kWarps && D > 32 ? 2 : 1;
  int nc = 0;
  for (int w = warp; w < halves * M; w += kWarps) {
    const int m = w % M, h = w / M;
    const float c = mode == kStart ? 0.f : group_sum(part, L, q_r + m);
    float c0 = 0.f;
    if (kQuirk && mode == kFirst) c0 = group_sum(part, L, q_r);
    float s = 0.f, l = 0.f;
    for (int d = lane + 32 * h; d < D; d += 32 * halves) {
      const int q = m * D + d;
      float u = P[L.mu + q], v;
      if (mode == kStart) {
        v = P[L.var + q];
      } else {
        const float s1 = group_sum(part, L, m * Dq + d);
        const float s2 = group_sum(part, L, M * Dq + m * Dq + d);
        float sh;  // the mean less the start
        if constexpr (!kEM) {
          v = kmeans_var(s1, s2, c, var_floor, &sh);
          P[L.var + q] = v;
          if (mode == kIter) {
            const float now = c > 0.f ? P[L.ref + q] + sh : u;
            nc |= not_close(now, u, 1e-5f, 1e-8f);
            P[L.mu + q] = u = now;
          }
          if (kQuirk) {
            if (mode == kFirst) {
              float sh0;
              v = m == 0 ? v
                         : kmeans_var(group_sum(part, L, d), group_sum(part, L, M * Dq + d), c0,
                                      var_floor, &sh0);
              if (m == 0) P[L.var0 + d] = v;
            } else {
              v = P[L.var0 + d];
            }
          }
        } else {
          // the plain version's r x / den and r x^2 / den - mean^2 about the
          // start; k = 1 but where den is clamped (a component of no weight)
          const float den = fmaxf(c, 1e-10f), k = c / den, ref = P[L.ref + q];
          sh = s1 / den;
          const float mean = k == 1.f ? ref + sh : ref * k + sh;
          v = k == 1.f ? s2 / den - __fmul_rn(sh, sh)
                       : s2 / den + ref * (2.f * sh + ref * k) - __fmul_rn(mean, mean);
          v = fmaxf(v, var_floor);
          nc |= not_close(mean, u, rtol, atol) | not_close(v, P[L.var + q], rtol, atol);
          P[L.mu + q] = u = mean;
          P[L.var + q] = v;
        }
      }
      if (kEM) v = expf(logf(v));
      const float lv = logf(v), iv = expf(-lv);
      P[L.w1(wb) + m * Dq + d] = 0.5f * iv;
      P[L.w2(wb) + m * Dq + d] = -u * iv;
      s += u * u * iv;
      l += lv;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      l += __shfl_xor_sync(0xffffffffu, l, o);
    }
    if (halves == 2) {
      if (h == 1 && lane == 0) {
        pair[2 * m] = s;
        pair[2 * m + 1] = l;
      }
      asm volatile("bar.sync %0, 64;" ::"r"(1 + m) : "memory");
      if (h == 1) continue;
      s += pair[2 * m];
      l += pair[2 * m + 1];
    }
    if (lane == 0) {
      P[L.wc(wb) + m] = 0.5f * ((s + l) + dlog2pi);
      if (!kEM) {
        if (mode != kStart) P[L.wt + m] = c;
      } else {
        if (mode != kStart) {
          const float wn = c / fmaxf(n_valid, 1e-10f);
          nc |= not_close(wn, P[L.wt + m], rtol, atol);
          P[L.wt + m] = wn;
        }
        P[L.lw + m] = logf(P[L.wt + m]);
      }
    }
  }
  return !__syncthreads_or(nc);
}

// Thread 0: global tile v of the ring (the fit's tile v % n_tiles of R
// frames, whatever the pass) from the compact rows src into stage v % S,
// completing on that stage's mbarrier.
__device__ __forceinline__ void issue_tile(int v, unsigned bar0, float* area, const float* src,
                                           int S, int R, int nf, int n_tiles, int Dq) {
  const int st = v % S, j0 = (v % n_tiles) * R, nk = min(R, nf - j0);
  const unsigned bytes = 4u * (unsigned)(nk * Dq);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_arrive_expect(bar0 + 8u * st, bytes);
  bulk_copy((unsigned)__cvta_generic_to_shared(area + (long long)st * R * Dq),
            src + (long long)j0 * Dq, bytes, bar0 + 8u * st);
}

// A fit whose frames overrun the scratch rows left to it (fits that share
// frames launched as disjoint): every output NaN, its iteration count -1,
// K24's assignments -1.
__device__ __forceinline__ void overrun(const FitArgs& a, int M, int D) {
  const long long f = blockIdx.x, MD = (long long)M * D;
  for (long long e = threadIdx.x; e < MD; e += kThreads) {
    a.mu_out[f * MD + e] = NAN;
    a.var_out[f * MD + e] = NAN;
  }
  for (int m = threadIdx.x; m < M; m += kThreads) a.w_out[f * M + m] = NAN;
  if (a.assign)
    for (int n = threadIdx.x; n < a.N; n += kThreads) a.assign[f * a.N + n] = -1;
  if (threadIdx.x == 0 && a.n_iters) a.n_iters[f] = -1;
}

// x [N, D] f32; masks [F, N] bool.  K24 (kKind kKmeans, kKmeansQuirk): p0
// the centroids [F, K, D], init [F, N] int64 -> assign [F, N] int64,
// mu_out / var_out [F, K, D], w_out the counts [F, K], n_iters [F] int32
// where given.  K25 (kEm): p0 / v0 [F, M, D], w0 [F, M] -> mu_out, var_out,
// w_out the weights, n_iters.  kD, kM: compile-time widths (0: a.D, a.M);
// kDevice: parameters, frames and values in device scratch.
template <int kKind, int kD, int kM, bool kDevice>
__global__ void __launch_bounds__(kThreads) gmm_fit_kernel(const FitArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int wsum[kWarps];
  __shared__ __align__(8) unsigned long long bars[kMaxStages];
  __shared__ float pair[kWarps];  // the M-step's second warps' sums (M <= 4)
  constexpr bool kEM = kKind == kEm;
  const int f = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int D = kD ? kD : a.D, M = kM ? kM : a.M, N = a.N;
  const Layout L = fit_layout(M, D);
  const int Dq = kD ? row_stride(kD) : L.Dq, V = kEM ? M : 1;
  float* P = kDevice ? a.pscratch + (long long)f * L.fixed : smem;
  float* area = smem + L.fixed;
  // thread 0's cycles by phase (see the trace's layout at the launcher)
  const bool trace = a.trace != nullptr && t == 0;
  long long cyc[6] = {0, 0, 0, 0, 0, 0};
  const long long t_start = trace ? clock64() : 0;
  long long tick = t_start;
#define GMM_TICK(phase)               \
  if (trace) {                        \
    const long long now_ = clock64(); \
    cyc[phase] += now_ - tick;        \
    tick = now_;                      \
  }
  const uint8_t* mask = a.masks + (long long)f * N;
  const longlong2 rows = fit_rows(a.masks, N, a.disjoint, wsum);
  int* idx = a.idx + rows.x;
  const int nf = compact_frames(mask, N, idx, rows.y, wsum);
  if (nf > rows.y) {
    overrun(a, M, D);
    return;
  }
  // the fit's frames: staged in shared memory, or gathered into the
  // compact scratch rows (the ring's source, the device tier's frames)
  const bool staged = !kDevice && nf <= a.cap, ring = !kDevice && !staged;
  float* fr_g = a.frames + rows.x * Dq;
  {
    // a warp gathers 8 rows at a time, their loads in flight together
    constexpr int kRows = 8;
    float* dst = staged ? area : fr_g;
    for (int j0 = warp; j0 < nf; j0 += kRows * kWarps) {
      long long src[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int j = j0 + i * kWarps;
        src[i] = j < nf ? (long long)idx[j] * D : -1;
      }
      for (int d = lane; d < Dq; d += 32) {
        float v[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) v[i] = src[i] >= 0 && d < D ? __ldg(a.x + src[i] + d) : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (src[i] >= 0) dst[(long long)(j0 + i * kWarps) * Dq + d] = v[i];
      }
    }
  }
  if (ring) asm volatile("fence.proxy.async.global;" ::: "memory");
  // the start: parameters, zero weights (their pads stay 0)
  const long long MD = (long long)M * D;
  for (int e = t; e < L.mu; e += kThreads) P[e] = 0.f;
  for (int q = t; q < MD; q += kThreads) {
    P[L.mu + q] = P[L.ref + q] = a.p0[f * MD + q];
    if (kEM) P[L.var + q] = a.v0[f * MD + q];
  }
  if (kEM)
    for (int m = t; m < M; m += kThreads) P[L.wt + m] = a.w0[(long long)f * M + m];
  const int R = ring ? a.tile : 0, S = a.stages;
  const int n_tiles = ring ? (nf + R - 1) / R : 1;
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(bars);
  if (ring && t == 0) {
    for (int st = 0; st < S; ++st) mbar_init(bar0 + 8u * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  GMM_TICK(0)
  float* vbuf = area + (long long)S * R * Dq;  // the ring's two tiles of values
  if (ring && t == 0)
    for (int v = 0; v < S; ++v) issue_tile(v, bar0, area, fr_g, S, R, nf, n_tiles, Dq);
  int u = 0;  // the ring's next tile
  // the owners of the statistics: thread t is group g of owners t / G, t /
  // G + OR, ... (one owner a thread on the shared tiers)
  const int G = L.G, OR = kThreads / G, g = t % G;
  const bool owns = t < G * OR && t / G < L.O;
  const float n_valid = (float)nf;
  if (kEM) {
    update<kKind>(P, L, M, D, kStart, 0, n_valid, a.var_floor, a.rtol, a.atol, a.dlog2pi, pair);
    GMM_TICK(1)
  }
  // pass -1 (K24): the initial assignment's statistics; pass i >= 0: an
  // iteration with the weights of buffer i & 1.  Each pass: each tile's
  // values, a barrier, its statistics; the groups' partial sums, a
  // barrier; the update (its barrier publishes the next weights).
  int it = 0;
  for (int pi = kEM ? 0 : -1; pi < a.max_iters; ++pi) {
    const bool first = pi < 0;
    const Weights W = weights(P, L, pi & 1);
    constexpr int kMC = kM ? kM : kChunk;  // mixtures an owner takes
    Acc<kMC> A;
    acc_zero(A);
    // the owner's references: its mixtures' means at the fit's start; on
    // K24's first pass (a random assignment: each cluster's mean near the
    // fit's) their average for every cluster (a variance needs no more)
    float4 ref[kMC];
    auto load_ref = [&](int o) {
      const int m0 = o / L.NB * kMC, d0 = 4 * (o % L.NB);
#pragma unroll
      for (int i = 0; i < kMC; ++i) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = d0 + c;
          if (first && d < D) {
            float sum = 0.f;
            for (int m = 0; m < M; ++m) sum += P[L.ref + m * D + d];
            v[c] = sum / (float)M;
          } else {
            v[c] = m0 + i < M && d < D ? P[L.ref + (m0 + i) * D + d] : 0.f;
          }
        }
        ref[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    };
    if (!kDevice && owns) load_ref(t / G);
    for (int k = 0; k < n_tiles; ++k) {
      const float* rws;
      float* vls;
      int nk, j0;
      if (ring) {
        mbar_wait(bar0 + 8u * (u % S), (unsigned)(u / S) & 1u);
        rws = area + (long long)(u % S) * R * Dq;
        vls = vbuf + (long long)(u & 1) * R * V;
        j0 = k * R;
        nk = min(R, nf - j0);
      } else {
        rws = kDevice ? fr_g : area;
        vls = kDevice ? a.vals + rows.x * V : area + (long long)a.cap * Dq;
        j0 = 0;
        nk = nf;
      }
      if (first)
        for (int j = t; j < nk; j += kThreads)
          vls[j] = (float)a.init[(long long)f * N + idx[j0 + j]];
      else
        tile_values<kKind, kD, kM, 2>(rws, nk, W, P + L.lw, vls, D, M, Dq, V);
      __syncthreads();
      GMM_TICK(2)
      if (ring) {  // the stage of the tile before is free
        if (t == 0 && u > 0) issue_tile(u - 1 + S, bar0, area, fr_g, S, R, nf, n_tiles, Dq);
        ++u;
      }
      if (kDevice) {
        for (int o = t / G; owns && o < L.O; o += OR) {
          acc_zero(A);
          load_ref(o);
          accumulate<kEM, kMC, kM != 0>(A, rws, vls, ref, nk, (o / L.NB) * kMC, o % L.NB, g, G, M,
                                        Dq);
          store_partials(A, P + L.part, L, M, (o / L.NB) * kMC, o % L.NB, g);
        }
      } else if (owns) {
        accumulate<kEM, kMC, kM != 0>(A, rws, vls, ref, nk, (t / G) / L.NB * kMC, (t / G) % L.NB,
                                      g, G, M, Dq);
      }
      GMM_TICK(3)
    }
    if (!kDevice && owns)
      store_partials(A, P + L.part, L, M, (t / G) / L.NB * kMC, (t / G) % L.NB, g);
    __syncthreads();
    GMM_TICK(3)
    const bool done = update<kKind>(P, L, M, D, first ? kFirst : kIter, (pi + 1) & 1, n_valid,
                                    a.var_floor, a.rtol, a.atol, a.dlog2pi, pair);
    GMM_TICK(4)
    if (!first) {
      it = pi + 1;
      if (done) break;
    }
  }
  if (ring)  // the tiles still in flight: S at the start, one more a tile after the first
    for (int v = u; v < S + max(u - 1, 0); ++v)
      mbar_wait(bar0 + 8u * (v % S), (unsigned)(v / S) & 1u);
  const long long fo = (long long)f * M * D;
  if (!kEM) {
    // every frame of the buffer: the last iteration's nearest cluster (the
    // draws where no iteration ran).  On the shared tiers the buffer goes
    // through the frame area, now free, in tiles of T rows (loads of
    // neighbouring floats), 4 frames a thread at compile-time widths.
    const Weights W = weights(P, L, (it + 1) & 1);
    const long long* finit = a.init + (long long)f * N;
    long long* fassign = a.assign + (long long)f * N;
    if (it == 0) {
      for (int n = t; n < N; n += kThreads) fassign[n] = finit[n];
    } else if (kDevice) {
      for (int n = t; n < N; n += kThreads) {
        float val;
        value_generic<kKind>(a.x + (long long)n * D, W, nullptr, &val, D, M, Dq);
        fassign[n] = (long long)val;
      }
    } else {
      const long long room = smem_floats(L, a.cap, a.tile, a.stages, V) - L.fixed;
      const int T = (int)min((long long)max(N, 1), min(4096LL, room / (Dq + 1)));
      float* tv = area + (long long)T * Dq;  // the tile's values
      for (int j = warp; j < T; j += kWarps)
        for (int d = D + lane; d < Dq; d += 32) area[(long long)j * Dq + d] = 0.f;
      for (int n0 = 0; n0 < N; n0 += T) {
        const int nt = min(T, N - n0);
        const float* src = a.x + (long long)n0 * D;
        for (int e = t; e < nt * D; e += kThreads) {
          const int j = e / D;
          area[(long long)j * Dq + (e - j * D)] = __ldg(src + e);
        }
        __syncthreads();
        tile_values<kKind, kD, kM, 4>(area, nt, W, nullptr, tv, D, M, Dq, 1);
        __syncthreads();
        for (int j = t; j < nt; j += kThreads) fassign[n0 + j] = (long long)tv[j];
      }
    }
  }
  for (int q = t; q < M * D; q += kThreads) {
    a.mu_out[fo + q] = P[L.mu + q];
    a.var_out[fo + q] = kKind == kKmeansQuirk ? P[L.var0 + q % D] : P[L.var + q];
  }
  for (int m = t; m < M; m += kThreads) a.w_out[(long long)f * M + m] = P[L.wt + m];
  if (t == 0 && a.n_iters) a.n_iters[f] = it;
  GMM_TICK(5)
  if (a.trace) {
    __syncthreads();
    if (trace) {
      long long* o = a.trace + 8LL * f;
      o[0] = it;
      for (int i = 0; i < 6; ++i) o[1 + i] = cyc[i];
      o[7] = clock64() - t_start;
    }
  }
#undef GMM_TICK
}

// The launch contract both launchers check, the plan of
// ops/gmm_fit_kernels.gmm_fit_plan: the device tier takes no dynamic shared
// memory and every scratch; the shared tiers one owner a thread, `smem`
// bytes of smem_floats, and where a fit may pass cap (cap < N) a ring of 2
// to kMaxStages stages of `tile` frames and the frame scratch.
int check_plan(const FitArgs& a, int F, int device, long long smem, int V) {
  if (F <= 0 || a.N < 0 || a.D <= 0 || a.M <= 0 || a.max_iters < 0 || a.cap < 0 ||
      a.cap > a.N || a.tile < 0 || a.stages < 0)
    return (int)cudaErrorInvalidValue;
  const Layout L = fit_layout(a.M, a.D);
  if (device)
    return smem == 0 && a.pscratch && a.frames && a.vals ? 0 : (int)cudaErrorInvalidValue;
  const bool ring = a.cap < a.N;
  if (L.O > kThreads || (ring && (a.stages < 2 || a.stages > kMaxStages || a.tile < 1 ||
                                  !a.frames)) ||
      (!ring && (a.stages || a.tile)) || 4 * smem_floats(L, a.cap, a.tile, a.stages, V) != smem)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int kKind, int kD, int kM, bool kDevice>
int launch_one(const FitArgs& a, int F, long long smem, cudaStream_t st) {
  auto kernel = gmm_fit_kernel<kKind, kD, kM, kDevice>;
  SRT_SET_SMEM(kernel, smem);
  kernel<<<F, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The instance: the device tier's, D = 39 at M = 1, 2 or 4, else the
// generic one.
template <int kKind>
int dispatch(const FitArgs& a, int F, int device, long long smem, cudaStream_t st) {
  if (device) return launch_one<kKind, 0, 0, true>(a, F, smem, st);
  if (a.D == 39 && a.M == 1) return launch_one<kKind, 39, 1, false>(a, F, smem, st);
  if (a.D == 39 && a.M == 2) return launch_one<kKind, 39, 2, false>(a, F, smem, st);
  if (a.D == 39 && a.M == 4) return launch_one<kKind, 39, 4, false>(a, F, smem, st);
  return launch_one<kKind, 0, 0, false>(a, F, smem, st);
}

}  // namespace

// trace (optional): int64 [F, 8] a fit, its iterations, then thread 0's
// clock64 cycles by phase: compaction and staging, weights (K25's start),
// distances or responsibilities, statistics, update and stop, K24's last
// pass; then the whole fit's cycles.
extern "C" int kmeans_fit_launch(const float* x, const uint8_t* masks, const float* c0,
                                 const long long* init, long long* assign, float* cent,
                                 float* vars, float* counts, int* n_iters, int* idx,
                                 float* frames, float* vals, float* pscratch, long long* trace,
                                 int F, int N, int D, int K, int disjoint, int max_iters,
                                 float var_floor, float dlog2pi, int quirk, int cap, int tile,
                                 int stages, int device, long long smem, void* stream) {
  FitArgs a{x, masks, c0, nullptr, nullptr, init, assign, cent, vars, counts, n_iters, idx,
            frames, vals, pscratch, trace, N, D, K, disjoint, max_iters, cap, tile, stages,
            var_floor, dlog2pi, 0.f, 0.f};
  const int rc = check_plan(a, F, device, smem, 1);
  if (rc) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  return quirk ? dispatch<kKmeansQuirk>(a, F, device, smem, st)
               : dispatch<kKmeans>(a, F, device, smem, st);
}

extern "C" int em_fit_launch(const float* x, const uint8_t* masks, const float* m0,
                             const float* v0, const float* w0, float* means, float* vars,
                             float* wts, int* n_iters, int* idx, float* frames, float* vals,
                             float* pscratch, long long* trace, int F, int N, int D, int M,
                             int disjoint, int max_iters, float rtol, float atol,
                             float var_floor, float dlog2pi, int cap, int tile, int stages,
                             int device, long long smem, void* stream) {
  FitArgs a{x, masks, m0, v0, w0, nullptr, nullptr, means, vars, wts, n_iters, idx,
            frames, vals, pscratch, trace, N, D, M, disjoint, max_iters, cap, tile, stages,
            var_floor, dlog2pi, rtol, atol};
  const int rc = check_plan(a, F, device, smem, M);
  if (rc) return rc;
  return dispatch<kEm>(a, F, device, smem, (cudaStream_t)stream);
}
