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
// What bounds it on the H100: at the 385-state sausage (64 x 500) a
// frame step and each eps pass are a min-plus product [S, S] (x) [S, items]
// with index tracking, ~9.5 G add-compare-select pairs in all: ~1.3 ms of
// f32 instructions issued on 132 SMs.  Read per item from L2 (the two matrices are
// 1.2 MB), as the first port did, they cost 28.5 ms.  At the isolated
// shape (5,632 items of 5 states) the work is tiny and the cost is 500
// dependent frame steps: a 5-shuffle min chain each, ~30 us, if no step
// waits on device memory.  Device memory bytes (emissions in, planes out)
// set the card's floor.
//
// Design: five forms, chosen on the host by ops/viterbi_kernels.dense_plan.
//
// * packed (S <= 32, the isolated path and small graphs): G = 32 / S items
//   per warp in lane groups of S (lane = g * S + s); the frontier is one
//   register per lane, read across the group with __shfl_sync from the
//   explicit lane g * S + j.  Each lane keeps its rows of the matrices in
//   registers, so a frame step is S independent shuffles and adds and a
//   min tree.  The emissions do not depend on the DP: a cp.async ring in
//   shared memory fetches them kPrefetch frames ahead, so no frame step
//   waits on device memory.
// * rows (S > 32), two forms of one kernel: a CTA owns R destination rows
//   of kI items; lane = rl * K + k scans origin chunk k of row rl, the K
//   lanes of a row merge with xor shuffles (the lower origin wins equal
//   values); the matrix rows are staged transposed and chunked so the
//   warp's reads hit 32 banks, the frontier is double-buffered in shared
//   memory.  cluster form (one matrix shared by the batch): a thread block
//   cluster of C CTAs splits the rows, kI = 4 items share every matrix
//   element read, and after each frame step and each eps pass a CTA writes
//   its rows' new costs into every CTA's frontier through distributed
//   shared memory, then waits on barrier.cluster (with the GPU-scope fence
//   it compiles to, ~900 cycles).  The plan takes the smallest cluster
//   whose rows fit and grows it only while the card holds every cluster at
//   once: at the sausage (B = 64, 16 clusters) it holds 15 of 7 or 8 CTAs,
//   so C = 6.  item form (per-item matrices, alignment): kI = 1,
//   32 x ceil(R / (32 / K)) threads sized to S, so several items share an
//   SM; C > 1 splits an item whose matrices do not fit one CTA.
// * wide (rows that no cluster's shared memory holds, above ~465 states):
//   one CTA of 1,024 threads per item; each warp owns the rows row = warp +
//   k * 32 and reduces over the origins with its lanes; the matrices are
//   read from device memory (L2-resident).  scratch: the wide form with its
//   frontier in a [B, 5, S] device-memory scratch, above ~11,600 states, so
//   no graph size is refused.
//
// The lanes of a row keep its frame-start cost, its pre-pass cost and its
// eps origin in registers, so an eps pass compares against the pre-pass
// cost (Jacobi) and a frozen frame (t >= nf) publishes the frame-start
// cost after computing the frame's planes from it.
//
// With `planes` off (bp == nullptr) nothing but `final` is written and
// the frame loop stops at the longest nf among the items a warp, CTA or
// cluster shares: what the isolated scorers need.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kCtaThreads = 1024;  // wide form
constexpr int kPackedMaxWarps = 8;  // packed form: warps per CTA, at most
constexpr int kPrefetch = 8;        // packed form: frames of emissions in flight
constexpr int kRowsMaxThreads = 544;  // row forms: 17 warps keep 120 registers a thread
constexpr unsigned kFull = 0xffffffffu;

enum Form { kPacked = 0, kRows = 1, kWide = 2, kWideScratch = 3 };

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
                         int eps_depth) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the frontier: in shared memory, or in the item's scratch rows
  float* prev = kScratch ? scratch + (size_t)blockIdx.x * 5 * S
                         : reinterpret_cast<float*>(smem_raw);  // [S]
  float* cur = prev + S;                              // [S]
  float* cand = cur + S;                              // [S]
  int* ebp = reinterpret_cast<int*>(cand + S);        // [S]
  int* cidx = ebp + S;                                // [S]

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp, n_warps = blockDim.x / kWarp;
  const size_t ss = (size_t)S * S;
  const float* tr = trans + (mat_per_item ? b * ss : 0);
  const float* ep = eps ? eps + (mat_per_item ? b * ss : 0) : nullptr;
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

// min over j < kS of c[j] and, with kIdx, its first index: a tree whose
// merges take the right half only when strictly lower, so equal values
// keep the lower index.
template <int kS, bool kIdx>
__device__ __forceinline__ float tree_min(float (&c)[kS], int& idx) {
  int ix[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) ix[j] = j;
#pragma unroll
  for (int w = 1; w < kS; w <<= 1) {
#pragma unroll
    for (int j = 0; j + w < kS; j += 2 * w) {
      if (kIdx) {
        const bool r = c[j + w] < c[j];
        c[j] = r ? c[j + w] : c[j];
        ix[j] = r ? ix[j + w] : ix[j];
      } else {
        c[j] = fminf(c[j], c[j + w]);
      }
    }
  }
  idx = ix[0];
  return c[0];
}

// Packed form (S <= 32): G = 32 / S items per warp, lane = g * S + s; kS
// is S up to 6, else S rounded up to a power of two, kIdx whether the
// planes are written
// (only then are the origins tracked).  Each lane keeps its row of trans
// (and eps) in registers, so a frame step is kS independent shuffles and
// adds, then a tree of log2(kS) levels.
template <int kS, bool kIdx>
__global__ void __launch_bounds__(kPackedMaxWarps * kWarp)
viterbi_dense_packed_kernel(const float* __restrict__ nll,
                            const float* __restrict__ trans,
                            const float* __restrict__ eps,
                            const float* __restrict__ init,
                            const int* __restrict__ nframes,
                            float* __restrict__ final_cost,
                            int* __restrict__ bp, int* __restrict__ eps_bp, int B,
                            int T, int S, int mat_per_item, int init_per_item,
                            int eps_depth, long long* __restrict__ trace) {
  const int n_warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int G = kWarp / S, GS = G * S;
  const bool in_group = lane < GS;
  const int g = in_group ? lane / S : G - 1;  // lanes >= G * S compute a copy
  const int s = in_group ? lane - g * S : S - 1;
  const int b = (blockIdx.x * n_warps + warp) * G + g;
  const bool own = in_group && b < B;
  const int bx = min(b, B - 1);  // reads of lanes without an item
  const bool use_eps = eps != nullptr;
  const float* trow = trans + (mat_per_item ? (size_t)bx * S * S : 0) + (size_t)s * S;
  const float* erow = use_eps ? eps + (trow - trans) : nullptr;
  float tr[kS], er[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    tr[j] = j < S ? trow[j] : 0.f;
    er[j] = use_eps && j < S ? erow[j] : 0.f;
  }
  const int src0 = g * S;  // the group's first lane
  const int nf = own ? nframes[b] : 0;
  const bool planes = bp != nullptr;
  const int t_end = __reduce_max_sync(kFull, own ? max(planes ? T : min(T, nf), 0) : 0);
  const float* x = nll + (size_t)bx * T * S + s;
  int* bpb = planes ? bp + (size_t)bx * T * S + s : nullptr;
  int* epb = planes ? eps_bp + (size_t)bx * T * S + s : nullptr;

  // min over j of m[j] + (the group's lane j's v), and its first origin
  auto relax = [&](const float (&m)[kS], float v, int& idx) -> float {
    float c[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {  // every lane shuffles: no branch around a shuffle
      const float o = __shfl_sync(kFull, v, src0 + min(j, S - 1));
      c[j] = j < S ? m[j] + o : INFINITY;
    }
    return tree_min<kS, kIdx>(c, idx);
  };
  // Jacobi eps passes: every lane reads the others' pre-pass costs through
  // the shuffles before any lane applies its candidate
  auto column = [&](float base, float e, float& cost, int& ebp) {
    cost = clamp_inf(base + e);
    ebp = -1;
    for (int k = 0; use_eps && k < eps_depth; ++k) {
      int idx;
      const float cnd = clamp_inf(relax(er, cost, idx) + e);
      if (cnd < cost) {
        cost = cnd;
        ebp = idx;
      }
    }
  };

  // the emission ring: frame t of this lane's column lands in slot
  // t % kPrefetch by cp.async, kPrefetch frames ahead of its step
  __shared__ float ring_s[kPackedMaxWarps][kPrefetch][kWarp];
  float* ring = &ring_s[warp][0][lane];
  auto fetch = [&](int t) {  // one commit group per frame (frames past T - 1 clamp)
    cp_async4(ring + (t % kPrefetch) * kWarp, x + (size_t)min(t, T - 1) * S);
    cp_async_commit();
  };
  if (t_end > 1)
    for (int t = 1; t <= kPrefetch; ++t) fetch(t);
  float prev = SRT_POS_INF;
  const long long c0 = trace ? clock64() : 0;
  if (t_end > 0) {
    const float* ini = init + (init_per_item ? (size_t)bx * S : 0);
    int ebp;
    column(ini[s], clamp_inf(x[0]), prev, ebp);
    if (planes && own) {
      bpb[0] = -1;
      epb[0] = ebp;
    }
  }
  for (int t = 1; t < t_end; ++t) {
    cp_async_wait<kPrefetch - 1>();  // frame t landed
    const float e = clamp_inf(ring[(t % kPrefetch) * kWarp]);
    int idx;
    const float v = relax(tr, prev, idx);
    float cost;
    int ebp;
    column(v, e, cost, ebp);  // e is read: its slot takes frame t + kPrefetch
    fetch(t + kPrefetch);
    if (planes && own) {
      bpb[(size_t)t * S] = idx;
      epb[(size_t)t * S] = ebp;
    }
    if (t < nf) prev = cost;  // past nf the frontier stays frozen
  }
  cp_async_wait_all();
  if (own) final_cost[(size_t)b * S + s] = (nf >= 1 && nf <= T) ? prev : SRT_POS_INF;
  if (trace && lane == 0) {  // the warp's cycles over its frames
    const size_t w = (size_t)blockIdx.x * n_warps + warp;
    trace[2 * w] = clock64() - c0;
    trace[2 * w + 1] = t_end;
  }
}

// Shared-memory layout of the row forms, in floats: two frontier buffers
// [2][K][fs][kI] (chunk stride fs odd, so the K chunks' reads hit distinct
// banks), then the staged trans (and eps) rows, each [K][cs] with chunk k
// holding origins [k * cl, k * cl + cl) as [jj][row] (cs = rpw mod 32, so a
// warp's rpw rows x K chunks hit 32 banks).
struct RowsLayout {
  int rpw, warps, cl, cs, fs, mat, front;
  __host__ __device__ RowsLayout(int S, int R, int K, int kI) {
    rpw = kWarp / K;  // rows per warp
    warps = (R + rpw - 1) / rpw;
    cl = (S + K - 1) / K;
    cs = cl * R;
    cs += K > 1 ? ((rpw - cs) % kWarp + kWarp) % kWarp : (4 - cs % 4) % 4;
    fs = cl | 1;
    mat = K * cs;
    front = K * fs * kI;
  }
  __host__ __device__ long long bytes(int use_eps) const {
    return 4LL * (2LL * front + (1LL + use_eps) * mat);
  }
};

// kI consecutive floats of shared memory as one vector
template <int kI>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

// Row forms (S > 32).  Cluster c of C CTAs takes items [c * kI, c * kI +
// kI); its CTA of rank r owns rows [r * R, r * R + R).  Lane rl * K + k of
// warp w scans origin chunk k of row w * rpw + rl for its kI items, so one
// frontier vector read serves kI add-compare-selects.  (Two rows per lane,
// and lanes ordered k-major, measured slower.)  The K lanes of a
// row all hold the row's state for its kI items (frame-start cost,
// pre-pass cost, eps origin, emissions two frames ahead): after a phase,
// lane k publishes the row's kI costs as one vector into the frontier of
// the CTAs r = k (mod K), and writes the plane entries of the items
// i = k (mod K).
template <int kI>
__global__ void __launch_bounds__(kRowsMaxThreads)
viterbi_dense_rows_kernel(const float* __restrict__ nll,
                          const float* __restrict__ trans,
                          const float* __restrict__ eps,
                          const float* __restrict__ init,
                          const int* __restrict__ nframes,
                          float* __restrict__ final_cost, int* __restrict__ bp,
                          int* __restrict__ eps_bp, int B, int T, int S, int R,
                          int K, int mat_per_item, int init_per_item,
                          int eps_depth, long long* __restrict__ trace) {
  using V = typename Vec<kI>::T;
  extern __shared__ __align__(16) float smem_f[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const RowsLayout L(S, R, K, kI);
  const int use_eps = eps != nullptr;
  float* front = smem_f;
  float* trs = smem_f + 2 * L.front;
  float* eps_s = trs + L.mat;
  const int k = lane % K;
  const int row0 = rank * R;
  const int item0 = (blockIdx.x / C) * kI;
  const int row_l = warp * L.rpw + lane / K;
  const int row = row0 + row_l;
  const bool row_ok = row_l < R && row < S;
  const int rread = min(row_l, R - 1);
  const int rowx = min(row, S - 1);  // emission reads of lanes without a row
  const int pub = ((row / L.cl) * L.fs + row % L.cl) * kI;  // the row's frontier entry

  // stage this CTA's rows of the matrices, transposed and chunked
  const size_t ss = (size_t)S * S;
  const float* gtr = trans + (mat_per_item ? (size_t)item0 * ss : 0);
  const float* gep = use_eps ? eps + (mat_per_item ? (size_t)item0 * ss : 0) : nullptr;
  const int nrows = min(R, S - row0);
  for (int i = tid; i < nrows * S; i += blockDim.x) {
    const int rr = i / S, j = i - rr * S;
    const int kk = j / L.cl, jj = j - kk * L.cl;
    const int o = kk * L.cs + jj * R + rr;
    trs[o] = gtr[(size_t)(row0 + rr) * S + j];
    if (use_eps) eps_s[o] = gep[(size_t)(row0 + rr) * S + j];
  }

  bool ok[kI];
  int nfi[kI];
  int t_end = 0;
  const bool planes = bp != nullptr;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    ok[i] = item0 + i < B;
    nfi[i] = ok[i] ? nframes[item0 + i] : 0;
    if (ok[i]) t_end = max(t_end, planes ? T : min(T, nfi[i]));
  }
  // this lane writes the plane entries of item i
  auto wr = [&](int i) { return ok[i] && row_ok && i % K == k; };
  // unconditional loads (item and frame clamped), so a prefetch register
  // is rewritten in place and no copy of it waits on the load
  auto xload = [&](int t, int i) -> float {
    return nll[((size_t)min(item0 + i, B - 1) * T + min(t, T - 1)) * S + rowx];
  };
  long long cyc[3] = {0, 0, 0};  // thread 0's cycles: scans, owners + publish, barriers
  long long tick = 0;
  auto lap = [&](int ph) {
    if (trace) {
      const long long now = clock64();
      cyc[ph] += now - tick;
      tick = now;
    }
  };
  auto sync_all = [&]() {
    lap(1);
    if (C > 1) cluster.sync();
    else __syncthreads();
    lap(2);
  };
  // the row's kI costs into frontier buffer `buf` of the CTAs r = k (mod K)
  auto publish = [&](int buf, const float (&val)[kI]) {
    if (!row_ok) return;
    V vq;
    float* qf = reinterpret_cast<float*>(&vq);
#pragma unroll
    for (int i = 0; i < kI; ++i) qf[i] = val[i];
    V* dst = reinterpret_cast<V*>(front + buf * L.front + pub);
    if (C == 1) {
      if (k == 0) *dst = vq;
    } else {
      for (int r = k; r < C; r += K) *cluster.map_shared_rank(dst, r) = vq;
    }
  };
  // min over origins j of m[row][j] + frontier[buf][j][i] for every item,
  // the first minimizing origin with it, merged over the row's K lanes
  auto scan = [&](const float* m, int buf, float (&v)[kI], int (&ix)[kI]) {
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      v[i] = INFINITY;
      ix[i] = 0x7fffffff;
    }
    const int j0 = k * L.cl, n = min(L.cl, S - j0);
    const float* mp = m + k * L.cs + rread;
    const V* fp = reinterpret_cast<const V*>(front + buf * L.front + k * L.fs * kI);
    auto acs = [&](int jj) {
      const float a = mp[jj * R];
      V f4 = fp[jj];
      const float* f = reinterpret_cast<const float*>(&f4);
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const float c = a + f[i];
        if (c < v[i]) {
          v[i] = c;
          ix[i] = j0 + jj;
        }
      }
    };
    int jj = 0;
    for (; jj + 4 <= n; jj += 4) {
      acs(jj);
      acs(jj + 1);
      acs(jj + 2);
      acs(jj + 3);
    }
    for (; jj < n; ++jj) acs(jj);
    for (int o = 1; o < K; o <<= 1) {
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const float ov = __shfl_xor_sync(kFull, v[i], o);
        const int oi = __shfl_xor_sync(kFull, ix[i], o);
        if (ov < v[i] || (ov == v[i] && oi < ix[i])) {
          v[i] = ov;
          ix[i] = oi;
        }
      }
    }
  };

  float prevr[kI], cur[kI], xa[kI], xb[kI];
  int ebp[kI];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    prevr[i] = SRT_POS_INF;
    xa[i] = xload(1, i);
    xb[i] = xload(2, i);
  }
  int buf = 0;  // the frontier buffer that holds the costs of the last phase
  // one frame: the frame step (t > 0; from `init` at t = 0), then the eps
  // passes; the last phase publishes the frame-start cost of a frozen item
  auto frame = [&](int t, const float (&e)[kI]) {
    float v[kI];
    int ix[kI];
    if (t > 0) {
      scan(trs, buf, v, ix);
      lap(0);
    } else {
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        v[i] = init[(init_per_item ? (size_t)min(item0 + i, B - 1) * S : 0) + rowx];
        ix[i] = -1;
      }
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      cur[i] = clamp_inf(v[i] + e[i]);
      ebp[i] = -1;
      if (planes && wr(i)) bp[((size_t)(item0 + i) * T + t) * S + row] = ix[i];
    }
    const int passes = use_eps ? eps_depth : 0;
    for (int p = 0; p <= passes; ++p) {
      if (p > 0) {
        scan(eps_s, buf, v, ix);
        lap(0);
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          const float cnd = clamp_inf(v[i] + e[i]);
          if (cnd < cur[i]) {
            cur[i] = cnd;
            ebp[i] = ix[i];
          }
        }
      }
      float out[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i)
        out[i] = (p == passes && t > 0 && t >= nfi[i]) ? prevr[i] : cur[i];
      publish(buf ^ 1, out);
      sync_all();
      buf ^= 1;
      if (p == passes) {
#pragma unroll
        for (int i = 0; i < kI; ++i) prevr[i] = out[i];
      }
    }
    if (planes) {
#pragma unroll
      for (int i = 0; i < kI; ++i)
        if (wr(i)) eps_bp[((size_t)(item0 + i) * T + t) * S + row] = ebp[i];
    }
  };

  sync_all();  // staging done, and every CTA of the cluster running
  const long long c0 = trace ? clock64() : 0;
  tick = c0;
  cyc[0] = cyc[1] = cyc[2] = 0;
  if (t_end > 0) {
    float e0[kI];
#pragma unroll
    for (int i = 0; i < kI; ++i) e0[i] = clamp_inf(xload(0, i));
    frame(0, e0);
  }
  for (int t = 1; t < t_end; t += 2) {
    float e[kI];
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      e[i] = clamp_inf(xa[i]);
      xa[i] = xload(t + 2, i);
    }
    frame(t, e);
    if (t + 1 < t_end) {
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        e[i] = clamp_inf(xb[i]);
        xb[i] = xload(t + 3, i);
      }
      frame(t + 1, e);
    }
  }
#pragma unroll
  for (int i = 0; i < kI; ++i)
    if (wr(i))
      final_cost[(size_t)(item0 + i) * S + row] =
          (nfi[i] >= 1 && nfi[i] <= T) ? prevr[i] : SRT_POS_INF;
  if (trace && tid == 0) {  // thread 0's cycles by phase, and the frames
    long long* tr = trace + 5 * (size_t)blockIdx.x;
    tr[0] = cyc[0];
    tr[1] = cyc[1];
    tr[2] = cyc[2];
    tr[3] = clock64() - c0;
    tr[4] = t_end;
  }
}

}  // namespace

// Dynamic shared memory per CTA of a form (enum Form), in bytes:
//   packed (none: p0 = warps per CTA); rows: p0 = R rows per CTA, p1 = K lanes
//   per row, p2 = kI items per CTA; wide: its frontier (five [S] rows);
//   wide with a scratch frontier: 0.
extern "C" long long viterbi_dense_smem_bytes(int form, int S, int per_item, int use_eps,
                                              int p0, int p1, int p2) {
  switch (form) {
    case kPacked:
      return 0;  // the matrices live in registers
    case kRows:
      return RowsLayout(S, p0, p1, p2).bytes(use_eps ? 1 : 0);
    case kWide:
      return 5LL * S * 4;
    default:
      return 0;
  }
}

// Clusters of `cluster` CTAs of the row form (`threads` threads, `smem`
// bytes, `k_items` items per CTA) the card can hold at once, or a negated
// cudaError_t.
extern "C" int viterbi_dense_cluster_slots(int cluster, int threads, long long smem,
                                           int k_items) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t e;
  if (smem > SRT_MAX_SMEM) return -(int)cudaErrorInvalidValue;
  if (k_items == 4) {
    e = cudaFuncSetAttribute(viterbi_dense_rows_kernel<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&n, viterbi_dense_rows_kernel<4>, &cfg);
  } else {
    e = cudaFuncSetAttribute(viterbi_dense_rows_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&n, viterbi_dense_rows_kernel<1>, &cfg);
  }
  return e == cudaSuccess ? n : -(int)e;
}

// nll [B, T, S] f32; trans / eps [S, S] or [B, S, S] (mat_per_item), eps
// may be null; init [S] or [B, S] (init_per_item); nf [B] i32 ->
// final [B, S] f32, bp / eps_bp [B, T, S] i32 (both null: planes off).
// The form and its sizes come from the host's plan (dense_plan): p0..p2
// as in viterbi_dense_smem_bytes, `cluster` CTAs per cluster (rows form),
// `grid` CTAs and `smem` bytes, which must equal the form's layout.
// scratch: [B, 5, S] 4-byte words for the wide form's frontier (form 3).
// trace (packed and row forms; null: off): packed [warps][2] = (cycles of
// the warp's frame loop, frames); rows [grid][5] = thread 0's cycles in
// the scans, in the owners' work and publishing, in the barriers, in all,
// and the frames.
extern "C" int viterbi_dense_launch(const float* nll, const float* trans,
                                    const float* eps, const float* init,
                                    const int* nf, float* final_cost, int* bp,
                                    int* eps_bp, float* scratch, int B, int T,
                                    int S, int mat_per_item, int init_per_item,
                                    int eps_depth, int form, int p0, int p1, int p2,
                                    int cluster, int grid, long long smem,
                                    long long* trace, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || grid <= 0 || (bp == nullptr) != (eps_bp == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int use_eps = eps != nullptr;
  if (smem != viterbi_dense_smem_bytes(form, S, mat_per_item, use_eps, p0, p1, p2))
    return (int)cudaErrorInvalidValue;
  switch (form) {
    case kPacked: {
      if (S > kWarp || p0 < 1 || p0 > kPackedMaxWarps ||
          (long long)grid * p0 * (kWarp / S) < B)
        return (int)cudaErrorInvalidValue;
      const int ks = S <= 6 ? S : S <= 8 ? 8 : S <= 16 ? 16 : 32;
      const bool idx = bp != nullptr;
#define SRT_PACKED(KS)                                                              \
  if (ks == KS) {                                                                   \
    auto kern = idx ? viterbi_dense_packed_kernel<KS, true>                         \
                    : viterbi_dense_packed_kernel<KS, false>;                       \
    kern<<<grid, p0 * kWarp, 0, st>>>(nll, trans, eps, init, nf, final_cost, bp,    \
                                       eps_bp, B, T, S, mat_per_item, init_per_item, \
                                       eps_depth, trace);                           \
  }
      SRT_PACKED(1) SRT_PACKED(2) SRT_PACKED(3) SRT_PACKED(4) SRT_PACKED(5) SRT_PACKED(6)
      SRT_PACKED(8) SRT_PACKED(16) SRT_PACKED(32)
#undef SRT_PACKED
      break;
    }
    case kRows: {
      const RowsLayout L(S, p0, p1, p2);
      const int threads = L.warps * kWarp;
      if (p1 < 1 || p1 > kWarp || (p1 & (p1 - 1)) || cluster < 1 || cluster > 8 ||
          grid % cluster || (long long)cluster * p0 < S || threads > kRowsMaxThreads ||
          (long long)(grid / cluster) * p2 < B || (mat_per_item && p2 != 1) ||
          (p2 != 1 && p2 != 4))
        return (int)cudaErrorInvalidValue;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(grid);
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = (size_t)smem;
      cfg.stream = st;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      cudaError_t e;
      if (p2 == 4) {
        SRT_SET_SMEM(viterbi_dense_rows_kernel<4>, smem);
        e = cudaLaunchKernelEx(&cfg, viterbi_dense_rows_kernel<4>, nll, trans, eps, init, nf,
                               final_cost, bp, eps_bp, B, T, S, p0, p1, mat_per_item,
                               init_per_item, eps_depth, trace);
      } else {
        SRT_SET_SMEM(viterbi_dense_rows_kernel<1>, smem);
        e = cudaLaunchKernelEx(&cfg, viterbi_dense_rows_kernel<1>, nll, trans, eps, init, nf,
                               final_cost, bp, eps_bp, B, T, S, p0, p1, mat_per_item,
                               init_per_item, eps_depth, trace);
      }
      if (e != cudaSuccess) return (int)e;
      break;
    }
    case kWide: {
      if (grid != B) return (int)cudaErrorInvalidValue;
      SRT_SET_SMEM(viterbi_dense_cta_kernel<false>, smem);
      viterbi_dense_cta_kernel<false><<<B, kCtaThreads, (size_t)smem, st>>>(
          nll, trans, eps, init, nf, final_cost, bp, eps_bp, nullptr, T, S,
          mat_per_item, init_per_item, eps_depth);
      break;
    }
    case kWideScratch: {
      if (grid != B || scratch == nullptr) return (int)cudaErrorInvalidValue;
      viterbi_dense_cta_kernel<true><<<B, kCtaThreads, 0, st>>>(
          nll, trans, eps, init, nf, final_cost, bp, eps_bp, scratch, T, S,
          mat_per_item, init_per_item, eps_depth);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
