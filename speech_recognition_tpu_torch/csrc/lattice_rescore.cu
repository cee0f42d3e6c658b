// K7: exact bigram rescoring over the word lattice.
//
// Replaces the TPU kernel speech_recognition_tpu/ops/lattice.py
// _hq_sweep_pallas (its inner `kern`): the blocked lookup of H - Q rows in
// a VMEM-resident ring, which exists because XLA would not keep the
// [dmax, B, L] ring resident across the rescoring scan.  On the card the
// lookup is one indexed load, so this kernel is the whole rescoring DP of
// ops/lattice.rescore_tbl (the plain version, which the tests hold against
// the reference's lattice_rescore bit for bit).  Per stream b and frame
// t < T, over leaf slots l (planes ends_cost, ends_tau [T, B, L]):
//   D[l]     s0 + start_l[l] where tau <= 0; otherwise s0 + hq with hq the
//            STORED (rounded) H - q row of frame tau, live only for
//            tau < t and t - tau <= dmax, else POS_INF
//   backoff  (base_l [L], pidx [L, K], pcost [L, K]): m_all / arg_all the
//            first minimum of D + base_l; per target j the sparse
//            candidates D[pidx[j, k]] + pcost[j, k] in k order, replacing
//            only on strictly smaller; the sparse one wins only if strictly
//            below m_all; H = min(., POS_INF)
//   dense    (big [L, L], source-major): H[j] = min(first minimum over the
//            source i of D[i] + big[i, j], POS_INF)
//   store    pred_w[t, b, j] = the winning source; ring row t % dmax = H - q[t]
//   end      D at frame clip(nf - 1, 0, T - 1) plus end_l, first minimum ->
//            cost[b], best_leaf[b]
//
// What bounds it on the H100: latency of the serial frame loop, as in K4.
// One CTA owns one stream for all T frames; per frame it reads 8L bytes of
// lattice planes, up to 4L of ring and 8KL (backoff) or 4L^2 (dense) of LM
// arrays through L1/L2, writes 8L bytes, and crosses two to four barriers.
// The bytes per frame are far below what the card moves in a frame's time,
// so barriers and the dependent loads set the time; the dense form adds L^2
// adds per frame and is left to graphs without a backoff structure.
//
// What the design does about it: the D row (and D at the final frame) stays
// in shared memory, so the sparse gathers and the dense column sweep read
// it without a memory round trip; the ring keeps dmax rows per stream in
// device memory (L2-resident at the main path's sizes); the backoff
// minimum is a warp-shuffle (value, index) reduction, one per frame.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // == 32: one reduction warp

struct Params {
  const float* ends_cost;  // [T, B, L]
  const int* ends_tau;     // [T, B, L]
  const float* q;          // [T, B] per-frame minimum of ends_cost
  const float* start_l;    // [L]
  const float* end_l;      // [L]
  const int* nf;           // [B]
  const float* big;        // [L, L] dense LM (source, target) or null
  const float* base_l;     // [L] backoff level or null
  const int* pidx;         // [L, K] seen predecessors (target-major)
  const float* pcost;      // [L, K]
  float* ring;             // [B, dmax, L] H - q rows
  float* cost;             // [B]
  int* best_leaf;          // [B]
  int* pred_w;             // [T, B, L]
  int T, B, L, K, dmax;
};

size_t smem_bytes(int L) { return (size_t)2 * L * sizeof(float); }

// (value, leaf index) lexicographic min: the first minimum in leaf order.
__device__ __forceinline__ void argmin_merge(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide first minimum; every thread gets the result.  Contains
// barriers, so all threads must call it.
__device__ void block_argmin(float& v, int& i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    argmin_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                 __shfl_xor_sync(0xffffffffu, i, off));
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = red_v[lane];
    i = red_i[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      argmin_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                   __shfl_xor_sync(0xffffffffu, i, off));
    if (lane == 0) {
      red_v[0] = v;
      red_i[0] = i;
    }
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  __syncthreads();  // red_v / red_i are reused by the next call
}

__global__ void __launch_bounds__(kThreads, 1) lattice_rescore_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* d = smem;          // [L] this frame's D row
  float* dfin = d + p.L;    // [L] D at the stream's last frame
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int tid = threadIdx.x, b = blockIdx.x;
  const int L = p.L, K = p.K, dmax = p.dmax;
  const bool backoff = p.base_l != nullptr;
  float* ring = p.ring + (size_t)b * dmax * L;
  const int t_fin = min(max(p.nf[b] - 1, 0), p.T - 1);

  for (int t = 0; t < p.T; ++t) {
    const size_t row = ((size_t)t * p.B + b) * L;
    float mv = INFINITY;  // first minimum of D + base_l (backoff)
    int mi = INT_MAX;
    for (int l = tid; l < L; l += kThreads) {
      const float s0 = __ldg(p.ends_cost + row + l);
      const int tau = __ldg(p.ends_tau + row + l);
      float dl;
      if (tau <= 0) {
        dl = s0 + __ldg(p.start_l + l);
      } else {
        const float hq = (tau < t && t - tau <= dmax)
                             ? ring[(size_t)(tau % dmax) * L + l]
                             : SRT_POS_INF;
        dl = s0 + hq;
      }
      d[l] = dl;
      if (t == t_fin) dfin[l] = dl;
      if (backoff) {
        const float db = dl + __ldg(p.base_l + l);
        if (db < mv) {  // strict: first minimum among this thread's leaves
          mv = db;
          mi = l;
        }
      }
    }
    if (backoff)
      block_argmin(mv, mi, red_v, red_i);  // its barriers also publish d
    else
      __syncthreads();

    const float qt = __ldg(p.q + (size_t)t * p.B + b);
    float* ring_row = ring + (size_t)(t % dmax) * L;
    for (int j = tid; j < L; j += kThreads) {
      float h;
      int pj;
      if (backoff) {
        float hs = SRT_POS_INF;
        int ps = 0;
        for (int k = 0; k < K; ++k) {
          const int src = __ldg(p.pidx + (size_t)j * K + k);
          const float c = d[src] + __ldg(p.pcost + (size_t)j * K + k);
          if (c < hs) {
            hs = c;
            ps = src;
          }
        }
        const bool take = hs < mv;
        h = fminf(take ? hs : mv, SRT_POS_INF);
        pj = take ? ps : mi;
      } else {
        float m = d[0] + __ldg(p.big + j);
        int a = 0;
        for (int i = 1; i < L; ++i) {
          const float c = d[i] + __ldg(p.big + (size_t)i * L + j);
          if (c < m) {
            m = c;
            a = i;
          }
        }
        h = fminf(m, SRT_POS_INF);
        pj = a;
      }
      p.pred_w[row + j] = pj;
      // this frame's reads of the slot (tau = t - dmax) all came before
      // the barrier above; later frames read it after the one below
      ring_row[j] = h - qt;
    }
    __syncthreads();  // d is rewritten next frame
  }

  float fv = INFINITY;
  int fi = INT_MAX;
  for (int l = tid; l < L; l += kThreads) {
    const float c = dfin[l] + __ldg(p.end_l + l);
    if (c < fv) {
      fv = c;
      fi = l;
    }
  }
  block_argmin(fv, fi, red_v, red_i);
  if (tid == 0) {
    p.cost[b] = fv;
    p.best_leaf[b] = fi;
  }
}

}  // namespace

extern "C" int lattice_rescore_smem_bytes(int L) {
  const size_t n = smem_bytes(L);
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
}

extern "C" int lattice_rescore_launch(
    const float* ends_cost, const int* ends_tau, const float* q,
    const float* start_l, const float* end_l, const int* nf, const float* big,
    const float* base_l, const int* pidx, const float* pcost, float* ring,
    float* cost, int* best_leaf, int* pred_w, int T, int B, int L, int K,
    int dmax, void* stream) {
  const bool dense = big != nullptr;
  if (B <= 0 || T <= 0 || L <= 0 || dmax <= 0 ||
      dense == (base_l != nullptr) ||
      (!dense && (K <= 0 || pidx == nullptr || pcost == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{ends_cost, ends_tau, q, start_l, end_l, nf, big, base_l, pidx,
           pcost, ring, cost, best_leaf, pred_w, T, B, L, dense ? 0 : K, dmax};
  const size_t smem = smem_bytes(L);
  SRT_SET_SMEM(lattice_rescore_kernel, smem);
  lattice_rescore_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
