// K11: dense full-sequence min-cost Viterbi over a [S, S] transition
// matrix, shared by the batch or one per item.
//
// Replaces the TPU kernel speech_recognition_tpu/ops/pallas_kernels.py
// _viterbi_kernel (pallas_viterbi), with the semantics of the XLA scan
// ops/viterbi.viterbi that it documents as identical, per item b:
//
//   nll clamped to POS_INF;
//   column(base, e): cost = min(base + e, POS_INF); then eps_depth
//     same-column passes, each computed from the whole pre-pass cost
//     (Jacobi): cand[to] = min(min_from(eps[to, from] + cost[from]) + e,
//     POS_INF), applied where cand < cost (strictly), eps_bp = its origin;
//   frame 0: column(init, nll[0]), bp row -1;
//   frame t: new[to] = min_from(trans[to, from] + prev[from]) with the
//     first minimum's origin as bp, then column(new, nll[t]); at t >= nf
//     the cost stays frozen, but the bp / eps_bp rows are still written
//     from the frozen cost;
//   final = the cost at frame nf - 1, POS_INF when nf < 1 or nf > T
//     (where the Pallas kernel leaves it unwritten).
//
// Every trans + prev add is done in f32 and no POS_INF entry is skipped:
// POS_INF plus a finite cost rounds to exactly 1e30, so an unreachable
// state's origin is the first origin whose cost is finite, and the
// planes are bit-identical to the plain version's.
//
// What bounds it on the H100: at the 385-state sausage (64 x 500) each
// frame reads two [S, S] matrices (1.2 MB, from L2: they do not fit the
// 227 KB of shared memory) for ~300k adds and compares per item, and
// the frames are sequential; at the isolated shape (5,632 items of 5
// states) the work is tiny and the cost is the 500 dependent frame steps
// of each warp.  Device memory bytes (emissions in, planes out) set the
// card's floor.
//
// Design.  Wide form (S > 32): one CTA of 1,024 threads per item; the
// cost frontier double-buffered in shared memory; each warp owns the
// destination rows row = warp + k * 32 and reduces over the origins with
// its lanes (a strided scan keeping the first minimum per lane, then a
// (value, index) shuffle reduction that keeps the lower index on equal
// values).  An eps pass computes every candidate into shared memory,
// then, after a barrier, applies them, so every row reads the pre-pass
// cost.  The matrices are staged in shared memory where 2 * S^2 * 4
// bytes fit beside the frontier (transcript graphs), else read from
// device memory (L2-resident).  A frontier too wide for shared memory
// (above ~11,600 states) lives in a [B, 5, S] device-memory scratch
// (template mode kScratch), so no graph size is refused.  Narrow form
// (S <= 32, isolated words):
// one warp per item, 8 items per CTA, lane = destination state, the
// frontier in registers read across lanes with shuffles, the item's
// matrices in shared memory.
//
// With `planes` off (bp == nullptr) nothing but `final` is written and
// the frame loop stops at nf: what the isolated scorers need.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kCtaThreads = 1024;  // wide form
constexpr int kItemsPerCta = 8;    // narrow form: warps (items) per CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp_inf(float x) {
  return fminf(x, SRT_POS_INF);
}

// (value, index) min over the warp; equal values keep the lower index.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// min over j of row[j] + cost[j] and its first index, over the warp
__device__ __forceinline__ void row_min(const float* row, const float* cost,
                                        int S, int lane, float& v, int& idx) {
  v = INFINITY;
  idx = 0x7fffffff;
  for (int j = lane; j < S; j += kWarp) {
    const float x = row[j] + cost[j];
    if (x < v) {
      v = x;
      idx = j;
    }
  }
  warp_argmin(v, idx);
}

template <bool kScratch>
__global__ void __launch_bounds__(kCtaThreads)
viterbi_dense_cta_kernel(const float* __restrict__ nll,
                         const float* __restrict__ trans,
                         const float* __restrict__ eps,
                         const float* __restrict__ init,
                         const int* __restrict__ nframes,
                         float* __restrict__ final_cost, int* __restrict__ bp,
                         int* __restrict__ eps_bp, float* __restrict__ scratch,
                         int T, int S, int mat_per_item, int init_per_item,
                         int eps_depth, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the frontier: in shared memory, or in the item's scratch rows
  float* prev = kScratch ? scratch + (size_t)blockIdx.x * 5 * S
                         : reinterpret_cast<float*>(smem_raw);  // [S]
  float* cur = prev + S;                              // [S]
  float* cand = cur + S;                              // [S]
  int* ebp = reinterpret_cast<int*>(cand + S);        // [S]
  int* cidx = ebp + S;                                // [S]
  float* staged = reinterpret_cast<float*>(smem_raw);  // [S*S] trans, [S*S] eps
  if (!kScratch) staged = reinterpret_cast<float*>(cidx + S);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp, n_warps = blockDim.x / kWarp;
  const size_t ss = (size_t)S * S;
  const float* tr = trans + (mat_per_item ? b * ss : 0);
  const float* ep = eps ? eps + (mat_per_item ? b * ss : 0) : nullptr;
  if (stage) {
    for (size_t i = tid; i < ss; i += blockDim.x) {
      staged[i] = tr[i];
      if (ep) staged[ss + i] = ep[i];
    }
    tr = staged;
    if (ep) ep = staged + ss;
    __syncthreads();
  }
  const float* x = nll + (size_t)b * T * S;
  const float* ini = init + (init_per_item ? (size_t)b * S : 0);
  const int nf = nframes[b];
  const bool planes = bp != nullptr;
  int* bpb = planes ? bp + (size_t)b * T * S : nullptr;
  int* epb = planes ? eps_bp + (size_t)b * T * S : nullptr;
  const int t_end = planes ? T : min(T, nf);

  // eps passes on `cur` at frame t (owned rows by lane 0 of each warp)
  auto eps_passes = [&](int t) {
    for (int k = 0; ep && k < eps_depth; ++k) {
      for (int row = warp; row < S; row += n_warps) {
        float v;
        int i;
        row_min(ep + (size_t)row * S, cur, S, lane, v, i);
        if (lane == 0) {
          cand[row] = clamp_inf(v + clamp_inf(x[(size_t)t * S + row]));
          cidx[row] = i;
        }
      }
      __syncthreads();  // every candidate read the pre-pass cost
      for (int row = warp; row < S; row += n_warps)
        if (lane == 0 && cand[row] < cur[row]) {
          cur[row] = cand[row];
          ebp[row] = cidx[row];
        }
      __syncthreads();
    }
    if (planes)
      for (int row = warp; row < S; row += n_warps)
        if (lane == 0) epb[(size_t)t * S + row] = ebp[row];
  };

  if (t_end > 0) {
    for (int row = warp; row < S; row += n_warps)
      if (lane == 0) {
        cur[row] = clamp_inf(ini[row] + clamp_inf(x[row]));
        ebp[row] = -1;
        if (planes) bpb[row] = -1;
      }
    __syncthreads();
    eps_passes(0);
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  for (int t = 1; t < t_end; ++t) {
    for (int row = warp; row < S; row += n_warps) {
      float v;
      int i;
      row_min(tr + (size_t)row * S, prev, S, lane, v, i);
      if (lane == 0) {
        cur[row] = clamp_inf(v + clamp_inf(x[(size_t)t * S + row]));
        ebp[row] = -1;
        if (planes) bpb[(size_t)t * S + row] = i;
      }
    }
    __syncthreads();
    eps_passes(t);
    if (t < nf) {  // past nf the frontier stays frozen
      float* tmp = prev;
      prev = cur;
      cur = tmp;
    }
  }
  __syncthreads();
  const bool has_final = nf >= 1 && nf <= T;
  for (int s = tid; s < S; s += blockDim.x)
    final_cost[(size_t)b * S + s] = has_final ? prev[s] : SRT_POS_INF;
}

__global__ void __launch_bounds__(kItemsPerCta * kWarp)
viterbi_dense_warp_kernel(const float* __restrict__ nll,
                          const float* __restrict__ trans,
                          const float* __restrict__ eps,
                          const float* __restrict__ init,
                          const int* __restrict__ nframes,
                          float* __restrict__ final_cost,
                          int* __restrict__ bp, int* __restrict__ eps_bp, int B,
                          int T, int S, int mat_per_item, int init_per_item,
                          int eps_depth) {
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kItemsPerCta + warp;
  if (b >= B) return;  // the whole warp leaves; no block barrier follows
  const int ss = S * S;
  float* tr = smem_f + warp * (eps ? 2 : 1) * ss;
  float* ep = eps ? tr + ss : nullptr;
  const float* gtr = trans + (mat_per_item ? (size_t)b * ss : 0);
  const float* gep = eps ? eps + (mat_per_item ? (size_t)b * ss : 0) : nullptr;
  for (int i = lane; i < ss; i += kWarp) {
    tr[i] = gtr[i];
    if (ep) ep[i] = gep[i];
  }
  __syncwarp();

  const int s = min(lane, S - 1);  // lanes >= S compute a copy, write nothing
  const bool own = lane < S;
  const float* x = nll + (size_t)b * T * S;
  const int nf = nframes[b];
  const bool planes = bp != nullptr;
  int* bpb = planes ? bp + (size_t)b * T * S : nullptr;
  int* epb = planes ? eps_bp + (size_t)b * T * S : nullptr;
  const int t_end = planes ? T : min(T, nf);

  // Jacobi eps passes: every lane reads the others' pre-pass costs through
  // the shuffles before any lane applies its candidate
  auto column = [&](float base, float e, float& cost, int& ebp) {
    cost = clamp_inf(base + e);
    ebp = -1;
    for (int k = 0; ep && k < eps_depth; ++k) {
      float v = INFINITY;
      int idx = 0;
      for (int j = 0; j < S; ++j) {
        const float c = ep[s * S + j] + __shfl_sync(kFull, cost, j);
        if (c < v) {
          v = c;
          idx = j;
        }
      }
      const float cnd = clamp_inf(v + e);
      if (cnd < cost) {
        cost = cnd;
        ebp = idx;
      }
    }
  };

  float prev = SRT_POS_INF;
  if (t_end > 0) {
    const float* ini = init + (init_per_item ? (size_t)b * S : 0);
    int ebp;
    column(ini[s], clamp_inf(x[s]), prev, ebp);
    if (planes && own) {
      bpb[s] = -1;
      epb[s] = ebp;
    }
  }
  for (int t = 1; t < t_end; ++t) {
    float v = INFINITY;
    int idx = 0;
    for (int j = 0; j < S; ++j) {
      const float c = tr[s * S + j] + __shfl_sync(kFull, prev, j);
      if (c < v) {
        v = c;
        idx = j;
      }
    }
    float cost;
    int ebp;
    column(v, clamp_inf(x[(size_t)t * S + s]), cost, ebp);
    if (planes && own) {
      bpb[(size_t)t * S + s] = idx;
      epb[(size_t)t * S + s] = ebp;
    }
    if (t < nf) prev = cost;  // past nf the frontier stays frozen
  }
  if (own)
    final_cost[(size_t)b * S + s] = (nf >= 1 && nf <= T) ? prev : SRT_POS_INF;
}

}  // namespace

// Shared memory of the wide form: the frontier (prev, cur, candidates and
// two index rows) and, with `stage`, the staged matrices.  Where the
// frontier alone does not fit, the launcher takes a [B, 5, S] scratch.
extern "C" int viterbi_dense_smem_bytes(int S, int use_eps, int stage) {
  if (S <= kWarp)
    return kItemsPerCta * (use_eps ? 2 : 1) * S * S * (int)sizeof(float);
  const long long frontier = 5LL * S * 4;
  const long long mats = stage ? (use_eps ? 2LL : 1LL) * S * S * 4 : 0;
  const long long total = frontier + mats;
  return total > 0x7fffffffLL ? 0x7fffffff : (int)total;
}

// nll [B, T, S] f32; trans / eps [S, S] or [B, S, S] (mat_per_item), eps
// may be null; init [S] or [B, S] (init_per_item); nf [B] i32 ->
// final [B, S] f32, bp / eps_bp [B, T, S] i32 (both null: planes off).
// scratch: null, or [B, 5, S] 4-byte words for a frontier too wide for
// shared memory (wide form, no staging).
extern "C" int viterbi_dense_launch(const float* nll, const float* trans,
                                    const float* eps, const float* init,
                                    const int* nf, float* final_cost, int* bp,
                                    int* eps_bp, float* scratch, int B, int T,
                                    int S, int mat_per_item, int init_per_item,
                                    int eps_depth, int stage, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || (bp == nullptr) != (eps_bp == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int use_eps = eps != nullptr;
  if (S <= kWarp) {
    const int smem = viterbi_dense_smem_bytes(S, use_eps, 1);
    SRT_SET_SMEM(viterbi_dense_warp_kernel, smem);
    viterbi_dense_warp_kernel<<<(B + kItemsPerCta - 1) / kItemsPerCta,
                                kItemsPerCta * kWarp, smem, st>>>(
        nll, trans, eps, init, nf, final_cost, bp, eps_bp, B, T, S,
        mat_per_item, init_per_item, eps_depth);
  } else if (scratch) {
    viterbi_dense_cta_kernel<true><<<B, kCtaThreads, 0, st>>>(
        nll, trans, eps, init, nf, final_cost, bp, eps_bp, scratch, T, S,
        mat_per_item, init_per_item, eps_depth, 0);
  } else {
    const int smem = viterbi_dense_smem_bytes(S, use_eps, stage);
    SRT_SET_SMEM(viterbi_dense_cta_kernel<false>, smem);
    viterbi_dense_cta_kernel<false><<<B, kCtaThreads, smem, st>>>(
        nll, trans, eps, init, nf, final_cost, bp, eps_bp, nullptr, T, S,
        mat_per_item, init_per_item, eps_depth, stage);
  }
  return (int)cudaGetLastError();
}
