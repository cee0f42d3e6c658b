// Bank emission (K13): the GMM negative log-likelihood of every bank state
// for every (frame, stream) at once, the first launch of K1 and K10.
//
//   nll[t, b, u] = -logsumexp_m(lw[u, m] - w[u, m, :] . xa[:, t, b])
//
// with xa [A, T, B] the augmented features [x^2, x, 1] (ops.gmm.augment_dtb)
// and w [U, M, A] / lw [U, M] from ops.gmm.gmm_emission_weights.  The TPU
// kernel speech_recognition_tpu/ops/viterbi_banded_pallas.py _kernel
// (fuse_emission=True, and emit_wordtrace=True) computes this product in
// its own body, frame block by frame block; here it runs once for all
// T x B columns before the DP (csrc/banded_forward.cu), which reads the
// [T, B, U] plane this writes.
//
// What bounds it on the H100: at B=512, T=500 (N = 256,000 columns) and the
// 11 x 5 x 4-mixture bank (U*M = 220 rows, A = 79) it is 8.9 G f32
// operations (~0.13 ms at 67 TFLOP/s, TF32 off) against 81 MB read and
// 56 MB written (~0.04 ms): bound by the f32 FMA rate.  Measured on the
// card (scripts/exp_r8_k13_variants.py: this kernel with parts taken out),
// its FMAs alone issue at about half that rate (~0.28 ms) and the
// shared-memory loads that feed them alone take ~0.21 ms, so the design
// keeps loads per FMA low and lets the two overlap.
//
// Design: a persistent tiled f32 SIMT GEMM with the mixture logsumexp in
// its epilogue.  Each CTA stages w into shared memory once, in the layout
// the product reads ([A][U][Mp], mixtures padded to a multiple of 4 by
// zeros, one 16-byte load per (a, state) step), with 4-byte cp.async
// copies in w's own order (coalesced reads, nothing held in registers), and
// lw beside it.  It then walks column tiles of kCols: tile i+1's [A][kCols]
// features are copied with cp.async into the other of two buffers while
// tile i computes, so one barrier per tile separates the two.  The work of
// a tile is ceil(U/2) x kGroups items, each a pair of states and kColsT
// columns: a thread accumulates 2 states x 4 mixtures x 8 columns in
// registers, 64 FMAs per step of a from four 16-byte shared-memory loads
// (the two states' weights; columns cg*4.. and 32 + cg*4.., so the eight
// column groups of a warp read 128 consecutive bytes), with step a+1's
// loads issued before step a's FMAs.  The running logsumexp over blocks of
// 4 mixtures follows, and each state's 8 columns go to the [T, B, U] plane.
// The item index runs over all items in passes of the CTA's threads, and
// the wrapper picks 4-8 warps per CTA so that the last pass leaves the
// fewest lanes idle (U = 55: 28 pairs x 8 groups = 7 full warps), two CTAs
// per SM.  Weights too large for shared memory are read from w through L1.
//
// Feature widths whose two [A][kCols] tiles do not fit in shared memory
// (A above ~450) take the chunked form: the weights are read through L1 as
// above, and each tile's features come in chunks of kChunk dimensions, two
// chunk buffers filled by cp.async (chunk c + 1 in flight while chunk c
// computes).  A thread's 64 partial dot products stay in registers across
// the chunks of a block of 4 mixtures, so every product is summed over a in
// ascending order, as the unchunked L1 form sums it.  Every thread walks
// the same sequence of (tile, item pass, mixture block, chunk) steps, one
// barrier a step; a chunk is loaded again for each item pass and mixture
// block (once at U = 55, M = 4).

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kCols = 64;    // columns per tile
constexpr int kMixT = 4;     // mixtures per register block
constexpr int kColsT = 8;    // columns per item: two float4, 32 columns apart
constexpr int kGroups = kCols / kColsT;  // column groups per tile (items per state pair)
constexpr int kChunk = 64;   // feature dimensions per chunk (the chunked form)

__host__ __device__ inline int round4(int m) { return (m + 3) & ~3; }

// Floats of the staged weights: [A][U][Mp] and the [U][Mp] log weights.
__host__ __device__ inline size_t weight_floats(int A, int U, int M) {
  return (size_t)(A + 1) * U * round4(M);
}

// mode 0: weights through L1, 1: weights staged, 2: chunked features
size_t smem_bytes(int A, int U, int M, int mode) {
  if (mode == 2) return 2 * (size_t)kChunk * kCols * sizeof(float);
  return ((mode ? weight_floats(A, U, M) : 0) + 2 * (size_t)A * kCols) * sizeof(float);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// kOneBlock: M <= 4, one block of mixtures (no running logsumexp to keep
// live across blocks, which costs registers)
template <bool kStage, bool kOneBlock>
__global__ void __launch_bounds__(kMaxThreads, 2)
bank_emission_kernel(const float* __restrict__ xa, const float* __restrict__ w,
                     const float* __restrict__ lw, float* __restrict__ out, int A, int N,
                     int U, int M, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Mp = round4(M);
  const int tid = threadIdx.x, nt = blockDim.x;
  float* ws = smem;                              // [A][U][Mp] (kStage)
  float* lws = smem + (size_t)A * U * Mp;        // [U][Mp] (kStage)
  float* xs0 = smem + (kStage ? weight_floats(A, U, M) : 0);  // two [A][kCols] tiles
  const int n_tiles = (N + kCols - 1) / kCols;

  // tile's features into xs; columns past N are zeros (never stored)
  auto load_tile = [&](int tile, float* xs) {
    const int n0 = tile * kCols;
    if (vec) {  // N % 4 == 0 and xa 16-byte aligned: 16-byte copies
      for (int i = tid; i < A * (kCols / 4); i += nt) {
        const int a = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
        const bool in = n0 + c < N;
        cp_async16(xs + a * kCols + c, xa + (size_t)a * N + (in ? n0 + c : 0), in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < A * kCols; i += nt) {
        const int a = i / kCols, c = i % kCols;
        const bool in = n0 + c < N;
        cp_async4(xs + i, xa + (size_t)a * N + (in ? n0 + c : 0), in ? 4 : 0);
      }
    }
  };

  if (kStage) {
    const int um = U * M;
    for (int i = tid; i < um * A; i += nt) {  // w's own order: coalesced reads
      const int a = i % A, r = i / A;
      cp_async4(ws + ((size_t)a * U + r / M) * Mp + r % M, w + i, 4);
    }
    for (int i = tid; i < A * U * (Mp - M); i += nt) {  // padded mixtures: zero weights
      const int pm = Mp - M;
      ws[(size_t)(i / pm) * Mp + M + i % pm] = 0.f;
    }
    for (int i = tid; i < U * Mp; i += nt)
      lws[i] = i % Mp < M ? __ldg(lw + (i / Mp) * M + i % Mp) : 0.f;
  }
  int tile = blockIdx.x;
  if (tile < n_tiles) load_tile(tile, xs0);
  cp_async_commit();

  const int n_items = ((U + 1) / 2) * kGroups;
  for (int k = 0; tile < n_tiles; tile += gridDim.x, ++k) {
    const float* xs = xs0 + (size_t)(k & 1) * A * kCols;
    cp_async_wait<0>();
    __syncthreads();  // this tile (and the weights) arrived; the last tile's reads are done
    if (tile + (int)gridDim.x < n_tiles)
      load_tile(tile + gridDim.x, xs0 + (size_t)((k + 1) & 1) * A * kCols);
    cp_async_commit();
    const int n0 = tile * kCols;

    for (int it = tid; it < n_items; it += nt) {
      // a pair of states (an odd U's last pair computes its state twice and
      // stores it once) and the columns cg*4 .. +3, 32 + cg*4 .. +3: the 8
      // column groups of a warp read 128 consecutive bytes, no bank conflict
      const int u0 = 2 * (it / kGroups), cg = it % kGroups;
      const int u1 = min(u0 + 1, U - 1);
      const float* xr = xs + cg * 4;
      // acc[s * 4 + m][j] = lw - w . x for mixture m0 + m of state u0 (s = 0)
      // or u1 (s = 1) and column j
      auto product = [&](int m0, float (&acc)[2 * kMixT][kColsT]) {
#pragma unroll
        for (int m = 0; m < 2 * kMixT; ++m)
#pragma unroll
          for (int j = 0; j < kColsT; ++j) acc[m][j] = 0.f;
        auto step = [&](const float (&wm)[2 * kMixT], float4 x0, float4 x1) {
          const float xj[kColsT] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int m = 0; m < 2 * kMixT; ++m)
#pragma unroll
            for (int j = 0; j < kColsT; ++j) acc[m][j] = fmaf(wm[m], xj[j], acc[m][j]);
        };
        if (kStage) {
          // pointer-bumped rows; step a+1's fragments load while step a computes
          const int wstep = U * Mp, dw = (u1 - u0) * Mp;
          const float* wp = ws + (size_t)u0 * Mp + m0;
          const float* xp = xr;
          float4 wa = lds4(wp), wb = lds4(wp + dw), x0 = lds4(xp), x1 = lds4(xp + 32);
#pragma unroll 1
          for (int a = 1; a <= A; ++a) {
            float4 na = wa, nb = wb, n0v = x0, n1v = x1;
            if (a < A) {
              wp += wstep;
              xp += kCols;
              na = lds4(wp);
              nb = lds4(wp + dw);
              n0v = lds4(xp);
              n1v = lds4(xp + 32);
            }
            const float wm[2 * kMixT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
            step(wm, x0, x1);
            wa = na;
            wb = nb;
            x0 = n0v;
            x1 = n1v;
          }
        } else {
          for (int a = 0; a < A; ++a) {
            float wm[2 * kMixT];
#pragma unroll
            for (int m = 0; m < kMixT; ++m) {
              const bool in = m0 + m < M;
              wm[m] = in ? __ldg(w + ((size_t)u0 * M + m0 + m) * A + a) : 0.f;
              wm[kMixT + m] = in ? __ldg(w + ((size_t)u1 * M + m0 + m) * A + a) : 0.f;
            }
            step(wm, lds4(xr + a * kCols), lds4(xr + a * kCols + 32));
          }
        }
#pragma unroll
        for (int m = 0; m < 2 * kMixT; ++m) {
          const int uu = m < kMixT ? u0 : u1, mm = m0 + m % kMixT;
          const float l = mm < M ? (kStage ? lws[uu * Mp + mm] : __ldg(lw + uu * M + mm)) : 0.f;
#pragma unroll
          for (int j = 0; j < kColsT; ++j) acc[m][j] = l - acc[m][j];
        }
      };
      // the first block of 4 mixtures starts the logsumexp (its running
      // maximum and sum are not live during this block's product); later
      // blocks rescale it; padded mixtures are left out
      float zmax[2][kColsT], sum[2][kColsT];
      {
        float acc[2 * kMixT][kColsT];
        product(0, acc);
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int j = 0; j < kColsT; ++j) {
            float zm = acc[s2 * kMixT][j];
#pragma unroll
            for (int m = 1; m < kMixT; ++m)
              if (m < M) zm = fmaxf(zm, acc[s2 * kMixT + m][j]);
            float sm = 0.f;
#pragma unroll
            for (int m = 0; m < kMixT; ++m)
              if (m < M) sm += __expf(acc[s2 * kMixT + m][j] - zm);
            zmax[s2][j] = zm;
            sum[s2][j] = sm;
          }
      }
      for (int m0 = kMixT; !kOneBlock && m0 < M; m0 += kMixT) {
        float acc[2 * kMixT][kColsT];
        product(m0, acc);
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int j = 0; j < kColsT; ++j) {
            float nm = zmax[s2][j];
#pragma unroll
            for (int m = 0; m < kMixT; ++m)
              if (m0 + m < M) nm = fmaxf(nm, acc[s2 * kMixT + m][j]);
            float sm = sum[s2][j] * __expf(zmax[s2][j] - nm);
#pragma unroll
            for (int m = 0; m < kMixT; ++m)
              if (m0 + m < M) sm += __expf(acc[s2 * kMixT + m][j] - nm);
            zmax[s2][j] = nm;
            sum[s2][j] = sm;
          }
      }
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        if (s2 && u0 + 1 >= U) break;
        const int uu = u0 + s2;
#pragma unroll
        for (int j = 0; j < kColsT; ++j) {
          const int col = n0 + (j / 4) * 32 + cg * 4 + j % 4;
          if (col < N) out[(size_t)col * U + uu] = -(__logf(sum[s2][j]) + zmax[s2][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The chunked form (see the head of this file).
template <bool kOneBlock>
__global__ void __launch_bounds__(kMaxThreads, 2)
bank_emission_chunked_kernel(const float* __restrict__ xa, const float* __restrict__ w,
                             const float* __restrict__ lw, float* __restrict__ out, int A,
                             int N, int U, int M, int vec) {
  extern __shared__ __align__(16) float smem[];  // two [kChunk][kCols] buffers
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_tiles = (N + kCols - 1) / kCols;
  const int n_items = ((U + 1) / 2) * kGroups;
  const int n_pass = (n_items + nt - 1) / nt;
  const int n_blocks = kOneBlock ? 1 : (M + kMixT - 1) / kMixT;
  const int n_chunks = (A + kChunk - 1) / kChunk;

  // chunk c of a tile's features into buf; dimensions past A and columns
  // past N are zeros (never read, never stored)
  auto load_chunk = [&](int tile, int c, float* buf) {
    const int n0 = tile * kCols, a0 = c * kChunk;
    if (vec) {
      for (int i = tid; i < kChunk * (kCols / 4); i += nt) {
        const int da = i / (kCols / 4), col = (i % (kCols / 4)) * 4;
        const bool in = a0 + da < A && n0 + col < N;
        cp_async16(buf + da * kCols + col,
                   xa + (in ? (size_t)(a0 + da) * N + n0 + col : 0), in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kChunk * kCols; i += nt) {
        const int da = i / kCols, col = i % kCols;
        const bool in = a0 + da < A && n0 + col < N;
        cp_async4(buf + i, xa + (in ? (size_t)(a0 + da) * N + n0 + col : 0), in ? 4 : 0);
      }
    }
  };
  // the step after (tile, p, mb, c)
  auto advance = [&](int& tile, int& p, int& mb, int& c) {
    if (++c < n_chunks) return;
    c = 0;
    if (++mb < n_blocks) return;
    mb = 0;
    if (++p < n_pass) return;
    p = 0;
    tile += gridDim.x;
  };

  if ((int)blockIdx.x < n_tiles) load_chunk(blockIdx.x, 0, smem);
  cp_async_commit();
  int k = 0;  // steps taken: chunk buffer k & 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile * kCols;
    for (int p = 0; p < n_pass; ++p) {
      const int it = p * nt + tid;
      const bool valid = it < n_items;
      const int u0 = valid ? 2 * (it / kGroups) : 0, cg = it % kGroups;
      const int u1 = min(u0 + 1, U - 1);
      float zmax[2][kColsT], sum[2][kColsT];
      for (int mb = 0; mb < n_blocks; ++mb) {
        const int m0 = mb * kMixT;
        float acc[2 * kMixT][kColsT];
#pragma unroll
        for (int m = 0; m < 2 * kMixT; ++m)
#pragma unroll
          for (int j = 0; j < kColsT; ++j) acc[m][j] = 0.f;
        for (int c = 0; c < n_chunks; ++c, ++k) {
          cp_async_wait<0>();
          __syncthreads();  // chunk k arrived; step k - 1's reads of the other buffer are done
          int nt_ = tile, np = p, nmb = mb, nc = c;
          advance(nt_, np, nmb, nc);
          if (nt_ < n_tiles) load_chunk(nt_, nc, smem + (size_t)((k + 1) & 1) * kChunk * kCols);
          cp_async_commit();
          if (!valid) continue;
          const float* xr = smem + (size_t)(k & 1) * kChunk * kCols + cg * 4;
          const int a0 = c * kChunk, a1 = min(A, a0 + kChunk);
          for (int a = a0; a < a1; ++a) {
            float wm[2 * kMixT];
#pragma unroll
            for (int m = 0; m < kMixT; ++m) {
              const bool in = m0 + m < M;
              wm[m] = in ? __ldg(w + ((size_t)u0 * M + m0 + m) * A + a) : 0.f;
              wm[kMixT + m] = in ? __ldg(w + ((size_t)u1 * M + m0 + m) * A + a) : 0.f;
            }
            const float4 x0 = lds4(xr + (a - a0) * kCols), x1 = lds4(xr + (a - a0) * kCols + 32);
            const float xj[kColsT] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int m = 0; m < 2 * kMixT; ++m)
#pragma unroll
              for (int j = 0; j < kColsT; ++j) acc[m][j] = fmaf(wm[m], xj[j], acc[m][j]);
          }
        }
        if (!valid) continue;
#pragma unroll
        for (int m = 0; m < 2 * kMixT; ++m) {
          const int uu = m < kMixT ? u0 : u1, mm = m0 + m % kMixT;
          const float l = mm < M ? __ldg(lw + uu * M + mm) : 0.f;
#pragma unroll
          for (int j = 0; j < kColsT; ++j) acc[m][j] = l - acc[m][j];
        }
        // the running logsumexp over the blocks, as the unchunked kernel's
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int j = 0; j < kColsT; ++j) {
            float nm = mb ? zmax[s2][j] : acc[s2 * kMixT][j];
#pragma unroll
            for (int m = 0; m < kMixT; ++m)
              if (m0 + m < M && (mb || m)) nm = fmaxf(nm, acc[s2 * kMixT + m][j]);
            float sm = mb ? sum[s2][j] * __expf(zmax[s2][j] - nm) : 0.f;
#pragma unroll
            for (int m = 0; m < kMixT; ++m)
              if (m0 + m < M) sm += __expf(acc[s2 * kMixT + m][j] - nm);
            zmax[s2][j] = nm;
            sum[s2][j] = sm;
          }
      }
      if (!valid) continue;
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        if (s2 && u0 + 1 >= U) break;
        const int uu = u0 + s2;
#pragma unroll
        for (int j = 0; j < kColsT; ++j) {
          const int col = n0 + (j / 4) * 32 + cg * 4 + j % 4;
          if (col < N) out[(size_t)col * U + uu] = -(__logf(sum[s2][j]) + zmax[s2][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <bool kOneBlock>
int launch_chunked(const float* xa, const float* w, const float* lw, float* out, int A, int N,
                   int U, int M, int warps, int grid, cudaStream_t s) {
  const size_t smem = smem_bytes(A, U, M, 2);
  auto kernel = bank_emission_chunked_kernel<kOneBlock>;
  SRT_SET_SMEM(kernel, smem);
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(xa) % 16 == 0;
  kernel<<<grid, warps * 32, smem, s>>>(xa, w, lw, out, A, N, U, M, vec);
  return (int)cudaGetLastError();
}

template <bool kStage, bool kOneBlock>
int launch(const float* xa, const float* w, const float* lw, float* out, int A, int N, int U,
           int M, int warps, int grid, cudaStream_t s) {
  const size_t smem = smem_bytes(A, U, M, kStage);
  auto kernel = bank_emission_kernel<kStage, kOneBlock>;
  SRT_SET_SMEM(kernel, smem);
  // all of the SM's shared memory: two CTAs of ~110 KB each at A = 79, U = 55
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(xa) % 16 == 0;
  kernel<<<grid, warps * 32, smem, s>>>(xa, w, lw, out, A, N, U, M, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one CTA in mode 0 (weights through L1), 1 (weights
// staged) or 2 (chunked features).
extern "C" int bank_emission_smem_bytes(int A, int U, int M, int mode) {
  const size_t n = smem_bytes(A, U, M, mode);
  return n > 0x7fffffff ? 0x7fffffff : (int)n;
}

// xa [A, N] (N = T*B columns), w [U, M, A], lw [U, M] -> out [N, U]; mode
// as bank_emission_smem_bytes; warps (1-8) per CTA; grid = CTAs of the
// persistent column walk.
extern "C" int bank_emission_launch(const float* xa, const float* w, const float* lw,
                                    float* out, int A, int N, int U, int M, int mode,
                                    int warps, int grid, void* stream) {
  if (A < 1 || N < 1 || U < 1 || M < 1 || grid < 1 || warps < 1 ||
      warps * 32 > kMaxThreads || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 2)
    return M <= kMixT ? launch_chunked<true>(xa, w, lw, out, A, N, U, M, warps, grid, s)
                      : launch_chunked<false>(xa, w, lw, out, A, N, U, M, warps, grid, s);
  const int stage = mode;
  if (M <= kMixT)
    return stage ? launch<true, true>(xa, w, lw, out, A, N, U, M, warps, grid, s)
                 : launch<false, true>(xa, w, lw, out, A, N, U, M, warps, grid, s);
  return stage ? launch<true, false>(xa, w, lw, out, A, N, U, M, warps, grid, s)
               : launch<false, false>(xa, w, lw, out, A, N, U, M, warps, grid, s);
}
