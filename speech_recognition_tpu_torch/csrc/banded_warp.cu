// The banded Viterbi forward DP of csrc/banded_forward.cu in its warp form:
// one warp owns one stream, for graphs of at most 256 states, 32 words and
// 32 word ends (each word start and end its own state).
//
// It runs the DP modes of banded_forward.cu that small graphs take, with
// their rules unchanged (the mode numbers of the C interface are the same):
//   0  K1's DP (uniform graphs, eps depth 1, eps_prev), whose emissions come
//      from K13 (csrc/bank_emission.cu); with it K1 replaces
//      speech_recognition_tpu/ops/viterbi_banded_pallas.py _kernel
//      (fuse_emission=True, emit_eps_prev=True)
//   1  K8 (any banded graph without cross edges, any eps depth, on bank
//      emissions; _kernel with bank_input=True)
//   3, 4  K17, one chunk of a streaming decode on K1's or K8's DP from a
//      carried frontier (no Pallas kernel: the JAX package's
//      decode/streaming.py:86 _chunk_step is a lax.scan); 5, 6 the same with
//      the ancestor map.
// K10's word-trace mode stays in banded_forward.cu.  The per-frame rules
// (band select and its ties, emission clamp, Jacobi eps passes with the
// strict first minimum in origin order over a row's finite span, strict
// improvement, K8's stop when a pass improves nothing, the length masks,
// the chunk modes' carry, seed and ancestor map) are those listed at the
// top of banded_forward.cu; the plain versions are
// ops/viterbi_banded_kernels.fused_dp_ref, viterbi_banded_general_ref and
// viterbi_banded_chunk_ref, and every output is bit-identical to them.
//
// What bounds it on the H100: a streaming push is 256 streams x 64 frames
// on the CLI's 55-state loop graph, ~9 M state updates: ~0.01 ms of
// operations and bytes.  The time is the latency of 64 dependent frame
// steps per stream, each a chain of dependent instructions.  The four-warp
// form gives a stream 128 lanes (73 idle on 55 states), keeps the frontier
// in shared memory and meets at a named barrier after every phase: ~3,400
// cycles a frame step on 55 states, 1,700 of them in the eps pass
// (clock64 trace, scripts/exp_r16_chunk_dp.py --trace).
//
// What the design does about it: one warp a stream, no barrier but
// __syncwarp, and the frame step in registers.  Lane l holds states l,
// l + 32, ... (kPer of them, a template argument) with their band costs and
// bank rows, and whether each is a word end (its slot) or a word start (its
// row), all loaded once.  The band step takes cost[s-1] and cost[s-2] with
// two __shfl_sync per state slot (a lane's later slots take lane 31's /
// lanes 30-31's values of the slot before) and keeps the new costs and
// codes in registers.  Lane r owns eps row r: its entries over the row's
// finite span (+inf elsewhere: never a strict minimum, so the span needs no
// test) sit in 32 registers.  An eps pass is: the lanes holding word ends
// and starts write their costs into the warp's 32-entry snapshot rows; each
// row's lane takes the first minimum of entry + end cost as a tree over
// groups of eight (the right operand wins only on strictly less, so ties go
// to the lower origin, as in the plain scan), tests its start for strict
// improvement, and a ballot plus one shuffle per state slot hands the
// improved starts their new cost, code 4 and ancestor.  The next kRing - 1
// frames' emission rows are copied with cp.async into the warp's ring while
// the frame computes (rows held in registers and gathered by shuffle
// instead measured slower: 0.060 against 0.045 ms, their loads' latency
// surfacing in the frame step; a group of four frames' rows a wait, 0.0446,
// no faster).  The planes go straight from registers to device memory
// (bp8 [T, S, B] and eps_u / eps_prev [T, R, B], one byte or word at stride
// B): staging them in [S, streams-per-CTA] segments would need a barrier
// between the CTA's warps, for a phase that takes ~150 of a frame step's
// ~1,290 cycles on 55 states (the eps pass ~620).  The DP takes 0.045 ms
// at 256 x 64 on the loop against the four-warp form's 0.142 (NVIDIA H100
// 80GB HBM3, 700 W).  ops/viterbi_banded_kernels.banded_plan takes this
// form up to BANDED_WARP_MAX_STATES states (set from a chip sweep,
// scripts/exp_r16_chunk_dp.py --sweep) and the four-warp form above.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEpsCode = 4;
// frames of emissions in flight per stream: seven frames ahead (~1,300
// cycles a frame step) keep the cp.async copies off the frame's path
constexpr int kRing = 8;
constexpr int kMaxTile = 8;    // warps (streams) per CTA
constexpr int kPhases = 6;     // the trace's phases, as banded_forward.cu's

enum Mode { kFused = 0, kGeneral = 1, kFusedChunk = 3, kGeneralChunk = 4 };
__host__ __device__ constexpr int base_mode(int mode) {
  return mode <= kGeneral ? mode : (mode - kFusedChunk) % 2;
}
__host__ __device__ constexpr bool chunk_mode(int mode) { return mode >= kFusedChunk; }
__host__ __device__ constexpr bool org_mode(int mode) { return mode >= 5; }
inline bool valid_mode(int mode) { return mode == 0 || mode == 1 || (mode >= 3 && mode <= 6); }

struct Params {
  const float* nll;       // emission (u, t, b) at u*su + t*st + b*sb
  long long su, st, sb;
  const float4* band4;    // [S] (band0, band1, band2, bank_state as int bits)
  const float* init;      // [S]; the chunk modes: the carried frontier [S, B]
  const int* word_starts; // [R]
  const int* info;        // [S] (word-end slot + 1) | (word-start row + 1) << 16
  const float* eps_m;     // [R, 32] each row's eps entries over its finite span, +inf else
  const int* nf;          // [B]
  float* final_cost;      // [S, B]
  int8_t* bp8;            // [T, S, B]
  void* eps_u;            // [T, R, B] int8 or int32
  int u_wide;
  int* eps_aux;           // [T, R, B] K1's eps_prev, or null
  int* org_out;           // [S, B] the ancestor map (modes 5, 6), or null
  long long* trace;       // [B, kPhases] cycles per phase, or null
  int U, T, B, S, R, L, eps_depth, tile, first;
};

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) & ~(size_t)15; }

// One warp's shared memory: the emission ring, and the 32-entry snapshot
// rows of an eps pass: the word-end costs, the word-start costs, K1's
// eps_prev entries of the ends (end - d_end) and, with the map, the ends'
// ancestors.
__host__ __device__ inline size_t warp_bytes(int mode, int U) {
  return r16((size_t)kRing * U * 4) + 128 * (2 + (base_mode(mode) == kFused) + org_mode(mode));
}

__host__ __device__ inline size_t smem_bytes(int mode, int U, int tile) {
  return (size_t)tile * warp_bytes(mode, U);
}

// Band select of one state from its three candidates (banded_forward.cu's).
template <int kBase>
__device__ __forceinline__ float band_select(float c0, float c1, float c2, int& d) {
  if (kBase == kFused) {  // min-chain, the largest d wins ties
    const float best = fminf(fminf(c0, c1), c2);
    d = (c2 == best) ? 2 : ((c1 == best) ? 1 : 0);
    return best;
  }
  float best = SRT_POS_INF;  // _select_band: replace on <=
  d = 0;
  if (c0 <= best) { best = c0; d = 0; }
  if (c1 <= best) { best = c1; d = 1; }
  if (c2 <= best) { best = c2; d = 2; }
  return best;
}

// (value, index) of the first minimum of x[0..8): the right operand of each
// merge holds the higher indices and wins only when strictly less.
__device__ __forceinline__ void first_min8(const float (&x)[8], float& v, int& i) {
  float a[4];
  int ia[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool r = x[2 * k + 1] < x[2 * k];
    a[k] = r ? x[2 * k + 1] : x[2 * k];
    ia[k] = 2 * k + (r ? 1 : 0);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool r = a[2 * k + 1] < a[2 * k];
    a[k] = r ? a[2 * k + 1] : a[2 * k];
    ia[k] = r ? ia[2 * k + 1] : ia[2 * k];
  }
  const bool r = a[1] < a[0];
  v = r ? a[1] : a[0];
  i = r ? ia[1] : ia[0];
}

template <int kMode, int kPer>
__global__ void __launch_bounds__(kMaxTile * kWarp, 1) banded_warp_kernel(Params p) {
  constexpr int kBase = base_mode(kMode);
  constexpr bool kChunk = chunk_mode(kMode);
  constexpr bool kK1 = kBase == kFused;
  constexpr bool kOrg = org_mode(kMode);
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * p.tile + warp;
  if (b >= p.B) return;  // a padding warp: the CTA has no barrier
  const int S = p.S, R = p.R, L = p.L, T = p.T, B = p.B;

  // ---- the warp's shared memory -----------------------------------------------
  unsigned char* w = smem + (size_t)warp * warp_bytes(kMode, p.U);
  float* ring = reinterpret_cast<float*>(w);
  w += r16((size_t)kRing * p.U * 4);
  float* ends_s = reinterpret_cast<float*>(w);  // [32] word-end costs
  w += 128;
  float* starts_s = reinterpret_cast<float*>(w);  // [32] word-start costs
  w += 128;
  int* endpp_s = reinterpret_cast<int*>(w);  // [32] K1: end - d_end
  w += kK1 ? 128 : 0;
  int* endorg_s = reinterpret_cast<int*>(w);  // [32] the ends' ancestors

  const int nf = p.nf[b];
  // the emission row of the next frame to prefetch: the lane's first
  // element and the ring slot it goes to, both moved on a frame at a time
  const float* pf_src = p.nll + (size_t)b * p.sb + (size_t)lane * p.su;
  const long long su32 = (long long)kWarp * p.su;
  int pf_t = 0;
  auto prefetch = [&]() {
    if (pf_t < T) {
      float* dst = ring + (pf_t % kRing) * p.U;
      const float* src = pf_src;
      for (int u = lane; u < p.U; u += kWarp, src += su32) cp_async4(dst + u, src);
    }
    cp_async_commit();  // an empty group keeps the group count per frame fixed
    ++pf_t;
    pf_src += p.st;
  };
  for (int tf = 0; tf < kRing - 1; ++tf) prefetch();

  // ---- the lane's states: lane l holds states l + 32 j ------------------------------
  float c[kPer];   // the carried costs
  int o[kPer];     // the carried ancestors (modes 5, 6)
  float4 bd[kPer]; // band costs, bank row
  int es[kPer], rs[kPer];  // word-end slot, word-start row (-1: none)
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = j * kWarp + lane;
    const bool in = s < S;
    c[j] = (kChunk && in) ? __ldg(p.init + (size_t)s * B + b) : SRT_POS_INF;
    o[j] = in ? s : 0;  // each state its own ancestor at the chunk start
    bd[j] = in ? __ldg(p.band4 + s) : make_float4(0.f, 0.f, 0.f, 0.f);
    const int inf = in ? __ldg(p.info + s) : 0;
    es[j] = (inf & 0xffff) - 1;
    rs[j] = (inf >> 16) - 1;
  }
  // ---- the lane's eps row (lane r < R owns row r) --------------------------------
  const bool has_row = lane < R;
  float ev[32];
  int sbank = 0;
  if (has_row) {
    const float4* er4 = reinterpret_cast<const float4*>(p.eps_m + (size_t)lane * 32);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = __ldg(er4 + q);
      ev[4 * q] = v.x;
      ev[4 * q + 1] = v.y;
      ev[4 * q + 2] = v.z;
      ev[4 * q + 3] = v.w;
    }
    sbank = __float_as_int(__ldg(p.band4 + __ldg(p.word_starts + lane)).w);
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) ev[k] = INFINITY;
  }
  if (lane >= L) ends_s[lane] = 0.f;  // past the ends: +inf entries read it

  // the planes' rows of frame t, moved on a frame at a time: bp8 at
  // bp_t + s B, the lane's eps row at eu_t
  int8_t* bp_t = p.bp8 + b;
  long long s_off[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) s_off[j] = (long long)(j * kWarp + lane) * B;
  const long long bp_step = (long long)S * B, eu_step = (long long)R * B;
  long long eu_t = (long long)lane * B + b;

  long long tr[kPhases] = {0, 0, 0, 0, 0, 0};
  long long tc = clock64();
  auto mark = [&](int ph) {
    if (p.trace) {
      const long long now = clock64();
      tr[ph] += now - tc;
      tc = now;
    }
  };

  for (int t = 0; t < T; ++t) {
    prefetch();  // frame t + kRing - 1
    cp_async_wait<kRing - 1>();
    __syncwarp();  // every lane's copies of this frame's row have landed
    const float* er = ring + (t % kRing) * p.U;
    auto emis = [&](int u) {
      const float e = er[u];
      return kK1 ? e : fminf(e, SRT_POS_INF);
    };
    mark(0);

    // (a) band relaxation + emission, in registers; frame 0 seeds from
    // init (a chunk: from the carry, or a later chunk relaxes from it)
    float n[kPer];
    int d[kPer], on[kPer];
    if (t == 0 && (!kChunk || p.first)) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int s = j * kWarp + lane;
        const float base = kChunk ? c[j] : (s < S ? __ldg(p.init + s) : SRT_POS_INF);
        n[j] = fminf(base + emis(__float_as_int(bd[j].w)), SRT_POS_INF);
        d[j] = 0;
        on[j] = o[j];
      }
    } else {
      // cost[s-1] and cost[s-2] from the lanes below; lane 0 (and lane 1
      // for s-2) take them from lane 31 (30) of the slot before, POS_INF
      // (ancestor 0) in front of the row
      float p1 = SRT_POS_INF, p2 = SRT_POS_INF;
      int q1 = 0, q2 = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float x1 = __shfl_sync(kFull, c[j], (lane + 31) & 31);
        const float x2 = __shfl_sync(kFull, c[j], (lane + 30) & 31);
        const float c1 = lane >= 1 ? x1 : p1, c2 = lane >= 2 ? x2 : p2;
        p1 = x1;
        p2 = x2;
        const float best = band_select<kBase>(bd[j].x + c[j], bd[j].y + c1, bd[j].z + c2, d[j]);
        n[j] = fminf(best + emis(__float_as_int(bd[j].w)), SRT_POS_INF);
        if constexpr (kOrg) {
          const int z1 = __shfl_sync(kFull, o[j], (lane + 31) & 31);
          const int z2 = __shfl_sync(kFull, o[j], (lane + 30) & 31);
          const int y1 = lane >= 1 ? z1 : q1, y2 = lane >= 2 ? z2 : q2;
          q1 = z1;
          q2 = z2;
          on[j] = d[j] == 2 ? y2 : (d[j] == 1 ? y1 : o[j]);
        } else {
          on[j] = 0;
        }
      }
    }
    const float e_start = emis(sbank);  // the row's start emission
    mark(1);

    // (b) eps passes: snapshot the ends' and starts' costs, each row's lane
    // takes its first minimum and tests its start, the improved starts'
    // lanes take the candidates
    int eu = -1, pp = 0;  // the row's last improving origin, its eps_prev
    for (int pass = 0; pass < p.eps_depth; ++pass) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (es[j] >= 0) {
          ends_s[es[j]] = n[j];
          if (kK1) endpp_s[es[j]] = j * kWarp + lane - d[j];
          if (kOrg) endorg_s[es[j]] = on[j];
        }
        if (rs[j] >= 0) starts_s[rs[j]] = n[j];
      }
      __syncwarp();
      float cand = SRT_POS_INF;
      int aorg = 0;
      bool imp = false;
      if (has_row) {
        float bv = INFINITY;
        int bi = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q * 8 < L) {
            const float4 e0 = *reinterpret_cast<const float4*>(ends_s + 8 * q);
            const float4 e1 = *reinterpret_cast<const float4*>(ends_s + 8 * q + 4);
            const float x[8] = {ev[8 * q] + e0.x,     ev[8 * q + 1] + e0.y,
                                ev[8 * q + 2] + e0.z, ev[8 * q + 3] + e0.w,
                                ev[8 * q + 4] + e1.x, ev[8 * q + 5] + e1.y,
                                ev[8 * q + 6] + e1.z, ev[8 * q + 7] + e1.w};
            float v;
            int i;
            first_min8(x, v, i);
            if (v < bv) {
              bv = v;
              bi = 8 * q + i;
            }
          }
        }
        // the plain scan starts from POS_INF: nothing at or above it wins
        const bool any = bv < SRT_POS_INF;
        const int arg = any ? bi : 0;
        cand = fminf((any ? bv : SRT_POS_INF) + e_start, SRT_POS_INF);
        imp = cand < starts_s[lane];  // strict improvement only
        if (imp) {
          eu = arg;
          if (kK1) pp = endpp_s[arg];
        }
        if (kOrg) aorg = endorg_s[arg];
      }
      const unsigned won = __ballot_sync(kFull, imp);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float cv = __shfl_sync(kFull, cand, rs[j] & 31);
        const int ov = kOrg ? __shfl_sync(kFull, aorg, rs[j] & 31) : 0;
        if (rs[j] >= 0 && ((won >> rs[j]) & 1u)) {
          n[j] = cv;
          d[j] = kEpsCode;
          if (kOrg) on[j] = ov;
        }
      }
      __syncwarp();  // the snapshot rows are written again by the next pass
      if (!won) break;  // K8: the next pass would repeat this one
    }
    mark(2);

    // (c) planes of this frame, straight from registers to device memory
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (j * kWarp + lane < S) bp_t[s_off[j]] = (int8_t)d[j];
    bp_t += bp_step;
    if (has_row) {
      const int uo = max(eu, 0);
      if (p.u_wide)
        static_cast<int*>(p.eps_u)[eu_t] = uo;
      else
        static_cast<int8_t*>(p.eps_u)[eu_t] = (int8_t)uo;
      if (kK1) p.eps_aux[eu_t] = eu >= 0 ? pp : 0;
    }
    eu_t += eu_step;
    mark(3);

    // (d) length mask: the carry moves on only for active frames
    const bool frozen = (kK1 || kChunk) ? t >= nf : (t >= 1 && t >= nf);
    if (!frozen) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        c[j] = n[j];
        if (kOrg) o[j] = on[j];
      }
    }
    mark(4);
  }
  cp_async_wait<0>();

  if (p.trace && lane == 0)
    for (int k = 0; k < kPhases; ++k) p.trace[(size_t)b * kPhases + k] = tr[k];
  const bool has_final = kK1 || kChunk || (nf >= 1 && nf <= T);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = j * kWarp + lane;
    if (s < S) {
      p.final_cost[(size_t)s * B + b] = has_final ? c[j] : SRT_POS_INF;
      if (kOrg) p.org_out[(size_t)s * B + b] = o[j];
    }
  }
}

template <int kMode, int kPer>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(kMode, p.U, p.tile);
  auto kernel = banded_warp_kernel<kMode, kPer>;
  SRT_SET_SMEM(kernel, smem);
  kernel<<<(p.B + p.tile - 1) / p.tile, p.tile * kWarp, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_per(const Params& p, int per, cudaStream_t s) {
  switch (per) {
    case 2: return launch<kMode, 2>(p, s);
    case 4: return launch<kMode, 4>(p, s);
    default: return launch<kMode, 8>(p, s);
  }
}

}  // namespace

// Shared memory of one CTA of the warp form (the wrapper's
// banded_warp_smem_bytes computes the same sum; the card tests hold the two
// equal).
extern "C" int banded_warp_smem_bytes(int mode, int U, int tile) {
  if (!valid_mode(mode)) return -1;
  const size_t n = smem_bytes(mode, U, tile);
  return n > (size_t)INT_MAX ? INT_MAX : (int)n;
}

// Modes as banded_forward_launch's (0, 1, 3-6).  nll, band4, init, nf,
// first and the outputs as there; word_starts [R]; info [S] (word-end slot
// + 1) | (word-start row + 1) << 16 (each start and end its own state);
// eps_m [R, 32] each row's eps entries over its finite origin span, +inf
// elsewhere and past L; R, L <= 32, S <= 32 per.  `tile` warps (streams) a
// CTA, `per` states a lane (2, 4 or 8).  trace: null, or [B, 6] int64
// cycles per phase of the frame steps (emission wait, band, eps passes,
// plane rows, mask, unused).
extern "C" int banded_warp_launch(
    int mode, const float* nll, long long su, long long st, long long sb, const void* band4,
    const float* init, const int* word_starts, const int* info, const float* eps_m,
    const int* nf, int first, float* final_cost, int8_t* bp8, void* eps_u, int u_wide,
    int* eps_aux, int* org_out, int U, int T, int B, int S, int R, int L, int eps_depth,
    int tile, int per, long long* trace, void* stream) {
  if (!valid_mode(mode) || U < 1 || S < 1 || R < 1 || R > kWarp || L < 1 || L > kWarp ||
      eps_depth < 1 || B <= 0 || T <= 0 || tile < 1 || tile > kMaxTile ||
      !(per == 2 || per == 4 || per == 8) || S > per * kWarp || bp8 == nullptr ||
      (base_mode(mode) == kFused && (eps_depth != 1 || eps_aux == nullptr)) ||
      (org_mode(mode) != (org_out != nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.nll = nll; p.su = su; p.st = st; p.sb = sb;
  p.band4 = static_cast<const float4*>(band4); p.init = init;
  p.word_starts = word_starts; p.info = info; p.eps_m = eps_m; p.nf = nf;
  p.final_cost = final_cost; p.bp8 = bp8; p.eps_u = eps_u; p.u_wide = u_wide;
  p.eps_aux = eps_aux; p.org_out = org_out; p.trace = trace;
  p.U = U; p.T = T; p.B = B; p.S = S; p.R = R; p.L = L; p.eps_depth = eps_depth;
  p.tile = tile; p.first = first;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch_per<0>(p, per, s);
    case 1: return launch_per<1>(p, per, s);
    case 3: return launch_per<3>(p, per, s);
    case 4: return launch_per<4>(p, per, s);
    case 5: return launch_per<5>(p, per, s);
    default: return launch_per<6>(p, per, s);
  }
}
