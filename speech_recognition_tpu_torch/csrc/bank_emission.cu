// Bank emission: the GMM negative log-likelihood of every bank state for
// every (frame, stream) at once, the first half of K1.
//
//   nll[t, b, u] = -logsumexp_m(lw[u, m] - w[u, m, :] . xa[:, t, b])
//
// with xa [A, T, B] the augmented features [x^2, x, 1] (ops.gmm.augment_dtb)
// and w [U, M, A] / lw [U, M] from ops.gmm.gmm_emission_weights.  The TPU
// kernel speech_recognition_tpu/ops/viterbi_banded_pallas.py _kernel
// (fuse_emission=True) computes this product in its own body, frame block
// by frame block; here it runs once for all T x B columns before the DP
// (csrc/banded_forward.cu), which reads the [T, B, U] plane this writes.
//
// What bounds it on the H100: at B=512, T=500 (N = 256,000 columns) and the
// 11 x 5 x 4-mixture bank (U*M = 220 rows, A = 79) it is 8.9 G f32 FMA
// operations (~0.13 ms at 67 TFLOP/s, TF32 off) against 81 MB read and
// 56 MB written (~0.04 ms): bound by operations.
//
// Design: a tiled f32 SIMT GEMM.  Each CTA stages the [A][U][Mp] weights
// (mixtures padded to a multiple of 4) in shared memory once, when they
// fit, and then walks column tiles of kCols (persistent grid): it loads
// the [A][kCols] feature tile, and each thread accumulates, for one bank
// state u and kColsT columns, the dot products of a block of 4 mixtures in
// registers (4 x kColsT accumulators; the 4 weights of a step are one
// 16-byte load, the columns broadcast across the warp, whose lanes are 32
// consecutive states).  The mixture logsumexp runs in the epilogue with a
// running maximum across mixture blocks, and the lanes of a warp store 32
// consecutive u of one column: coalesced rows of the [T, B, U] plane.
// Weights too large for shared memory are read through L1.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;     // columns per tile
constexpr int kColsT = 16;    // columns per thread
constexpr int kMixT = 4;      // mixtures per register block
constexpr int kGroups = kCols / kColsT;            // column groups (4)
constexpr int kStateSlots = kThreads / kGroups;    // states per pass (64)

inline int round4(int m) { return (m + 3) & ~3; }

template <bool kStage>
__global__ void __launch_bounds__(kThreads, 2)
bank_emission_kernel(const float* __restrict__ xa, const float* __restrict__ wp,
                     const float* __restrict__ lw, float* __restrict__ out, int A,
                     int N, int U, int M, int Mp) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                   // [A][U][Mp] if kStage
  float* xs = smem + (kStage ? (size_t)A * U * Mp : 0);  // [A][kCols]
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cg = warp % kGroups;                      // column group
  const int slot = (warp / kGroups) * 32 + lane;      // state slot
  const float* w = kStage ? ws : wp;
  if (kStage) {
    const int n4 = A * U * Mp / 4;
    for (int i = tid; i < n4; i += kThreads)
      reinterpret_cast<float4*>(ws)[i] = __ldg(reinterpret_cast<const float4*>(wp) + i);
  }
  const int n_tiles = (N + kCols - 1) / kCols;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile * kCols;
    __syncthreads();  // the previous tile's reads of xs are done
    for (int i = tid; i < A * kCols; i += kThreads) {
      const int a = i / kCols, c = i % kCols;
      xs[i] = n0 + c < N ? __ldg(xa + (size_t)a * N + n0 + c) : 0.f;
    }
    __syncthreads();
    for (int u = slot; u < U; u += kStateSlots) {
      float zmax[kColsT], sum[kColsT];
      for (int m0 = 0; m0 < M; m0 += kMixT) {
        float acc[kMixT][kColsT];
#pragma unroll
        for (int m = 0; m < kMixT; ++m)
#pragma unroll
          for (int j = 0; j < kColsT; ++j) acc[m][j] = 0.f;
        const float* wr = w + (size_t)u * Mp + m0;
        const float* xr = xs + cg * kColsT;
        for (int a = 0; a < A; ++a) {
          const float4 wv = kStage
              ? *reinterpret_cast<const float4*>(wr + (size_t)a * U * Mp)
              : __ldg(reinterpret_cast<const float4*>(wr + (size_t)a * U * Mp));
          const float wm[kMixT] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j4 = 0; j4 < kColsT; j4 += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + a * kCols + j4);
            const float xj[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int m = 0; m < kMixT; ++m)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[m][j4 + j] = fmaf(wm[m], xj[j], acc[m][j4 + j]);
          }
        }
        // running logsumexp over mixture blocks, padded mixtures left out
        float lwm[kMixT];
#pragma unroll
        for (int m = 0; m < kMixT; ++m)
          lwm[m] = m0 + m < M ? __ldg(lw + u * M + m0 + m) : 0.f;
#pragma unroll
        for (int j = 0; j < kColsT; ++j) {
          float cmax = -INFINITY;
#pragma unroll
          for (int m = 0; m < kMixT; ++m)
            if (m0 + m < M) {
              acc[m][j] = lwm[m] - acc[m][j];
              cmax = fmaxf(cmax, acc[m][j]);
            }
          if (m0 == 0) {
            zmax[j] = cmax;
            sum[j] = 0.f;
          } else {
            const float nm = fmaxf(zmax[j], cmax);
            sum[j] *= expf(zmax[j] - nm);
            zmax[j] = nm;
          }
#pragma unroll
          for (int m = 0; m < kMixT; ++m)
            if (m0 + m < M) sum[j] += expf(acc[m][j] - zmax[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kColsT; ++j) {
        const int col = n0 + cg * kColsT + j;
        if (col < N) out[(size_t)col * U + u] = -(logf(sum[j]) + zmax[j]);
      }
    }
  }
}

size_t smem_bytes(int A, int U, int M, int stage) {
  return ((stage ? (size_t)A * U * round4(M) : 0) + (size_t)A * kCols) * sizeof(float);
}

}  // namespace

// Shared memory of one CTA, with or without the staged weights.
extern "C" int bank_emission_smem_bytes(int A, int U, int M, int stage) {
  const size_t n = smem_bytes(A, U, M, stage);
  return n > 0x7fffffff ? 0x7fffffff : (int)n;
}

// xa [A, N] (N = T*B columns), wp [A, U, Mp] weights with the mixtures
// padded to Mp = round4(M) by zeros, lw [U, M] -> out [N, U]; grid = CTAs
// of the persistent column walk.
extern "C" int bank_emission_launch(const float* xa, const float* wp, const float* lw,
                                    float* out, int A, int N, int U, int M, int stage,
                                    int grid, void* stream) {
  if (A < 1 || N < 1 || U < 1 || M < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(A, U, M, stage);
  const cudaStream_t s = (cudaStream_t)stream;
  if (stage) {
    SRT_SET_SMEM(bank_emission_kernel<true>, smem);
    bank_emission_kernel<true><<<grid, kThreads, smem, s>>>(xa, wp, lw, out, A, N, U, M,
                                                            round4(M));
  } else {
    SRT_SET_SMEM(bank_emission_kernel<false>, smem);
    bank_emission_kernel<false><<<grid, kThreads, smem, s>>>(xa, wp, lw, out, A, N, U, M,
                                                             round4(M));
  }
  return (int)cudaGetLastError();
}
