// K19: the token-passing beam, every frame of a batch in one launch.
//
// It replaces no TPU kernel: the JAX package runs the beam as one jitted
// lax.scan, speech_recognition_tpu/ops/beam.py beam_search (:155, its scan
// :317).  The plain version is ops/beam.beam_search_ref, a frame loop of
// tensor ops (three stable argsorts a merge, two merges a frame).
//
// A stream's frontier is up to k live tokens (state, cost, predecessor
// word), ordered by (cost, state).  A frame, as the plain version's
// expand -> column:
//   * each live token j at state s with cost c proposes s + d (d = 0..2,
//     below S) at c + band[d, s + d] and, with cross edges, each child-arc
//     start child_starts[s, i] >= 0 at c + child_costs[s, i]; each adds
//     the target's emission nll[b, t, bank_state[tgt]], clamped at POS_INF
//     (frame 0: the init states at their init costs plus emission);
//   * first merge: of a state's candidates the one of least (cost, origin
//     state) survives; the survivors are ranked by (cost, state) and the
//     first k kept (the merged list M, n1 tokens).  A candidate's prev is
//     its origin token j, its word -1, its predecessor word the origin's;
//   * eps re-entry: each word start r takes the end token of M of least
//     (eps_block[r, slot] + (cost + bigram[pred, word]), slot), added in
//     that order (kBigram; else + cost alone), plus the start's emission,
//     clamped; the candidate carries the end token's prev, its word, and
//     as predecessor that word (kBigram) or V;
//   * second merge: an eps candidate replaces M's token of its state only
//     at a strictly lower cost (eps loses ties: its tie rank S + 1 is above
//     any origin), the first of equal eps candidates of one state wins, and
//     the survivors are ranked by (cost, state) into the next frontier.
// On live tokens (cost < POS_INF / 2) this is the plain version's rule:
// three stable sorts (state, cost, tie rank) keep each state's first entry
// of least (cost, tie, position), and a stable cost sort keeps the k of
// least (cost, state).  Candidates of one origin carry the same payload,
// so the position (band d, then child slot) never changes a result.  The
// token planes tok_state / tok_prev / tok_word [B, T, k] and the final
// frontier equal the plain version's bit for bit on every live slot; dead
// slots hold -1 (final cost POS_INF), where the plain version keeps the
// order of dropped duplicates.  Frame 0 runs for every stream (its row is
// written, as the plain version writes it); rows from the stream's length
// to T are -1; the final frontier is the one at n_frames - 1 where 1 <=
// n_frames <= T, else dead.
//
// What bounds it on the H100: a frame is a few hundred candidates (~170 a
// frame at k = 64 on the 1k trie, ~120 distinct states) through a dedup,
// a ranking and the eps pass: a chain of short dependent steps, each
// ended by a block barrier, for T frames; the bytes (the emission rows,
// the planes written) are a few MB.  So the time is the frame's latency
// chain, not bandwidth: with one CTA a stream and 8 warps an SM, a
// dependent instruction costs its full latency (~5 cycles an ALU step,
// ~30 a shared-memory load, ~300 an L2 load), so every phase is written
// for few dependent instructions.  Design: one CTA a stream, the whole
// frame loop inside the kernel, nothing read back, and per frame:
//   1. proposals from the graph's packed tables (ops/beam_kernels.
//      beam_pack, built once per graph): a token's proposals are one run
//      of int4 edge records (target, weight, target's bank row), so a
//      candidate is one record load (four of a thread's loaded at once),
//      its emission from the staged row and a 64-bit atomicMin of (cost
//      key << 32 | origin) on a key table a state; the first thread that
//      touches a state lists it and fetches its state record into L1.
//      The frontier keeps each token's run (first edge, count), so no
//      token walks empty child slots; g threads a token, g the largest
//      power of two with g * n_live within the block.
//   2. the ranking: each warp sorts 32 survivors' (cost key << 32 | state)
//      keys in registers (a bitonic network of shuffles).  One run is
//      ranked so.  Up to 8 runs (256 survivors): a thread a key counts the
//      keys below it in every run (a 5-step search a run, the runs
//      searched side by side, no division), its place being the sum.
//      Past 8 runs, rounds merge groups of 8 runs, one search an item
//      (key, other run) spread over the block and added into the key's
//      place, the keys then moved to their places; places at or past k
//      are dropped.  Keys are unique (the state is the low word).
//   3. the M step, at each place below k: M's token (payload, its state
//      record: end slot, end word, edge run), its loads issued before the
//      search; the key table entry of its state is marked with its index
//      in M, so the eps pass finds M's token of a word start there.
//   4. the eps pass, one warp a word start: lanes take M's end tokens,
//      the warp's least (score key, slot) by two redux.sync minima, a
//      ballot finds the token; lane 0 adds the start's emission and,
//      where no two word starts share a state (the packed tables say),
//      decides at once whether the candidate replaces M's token and lists
//      the winner with its key; else a second pass does it after a
//      barrier.
//   5. the ranks of M's survivors and the winners (M is sorted, the
//      winners are few), the next frontier and the planes, the next
//      frontier's edge runs fetched into L1; the key table is reset at the
//      touched states.
// That is five barriers a frame at up to 256 survivors.  The next
// frame's emission row is copied by cp.async into a second buffer while
// the frame runs.  beam_plan (ops/beam_kernels.py) puts a stream's
// working set (key table, token index a state, sort runs and places,
// frontier, M, eps) in shared memory where it fits with the two rows (the
// 1k trie at k = 64: ~130 KB; the kSmem instance, whose accesses are
// shared-memory instructions), else in a device scratch a stream (the
// dictionary-shaped trie, or k = S), the rows still staged where they
// fit; so no size is refused.  With stats, thread 0 sums the cycles of
// each phase (clock64).

#include "common.cuh"

namespace {

typedef unsigned long long u64;
constexpr u64 kEmpty = ~0ull;
constexpr u64 kHigh = 0xffffffff00000000ull;
constexpr int kMaxThreads = 1024;
constexpr int kRun = 32;   // keys a warp sorts
constexpr int kGroup = 8;  // runs a round merges
// a key table entry's low word: the origin state, or with this bit M's index
constexpr unsigned kInM = 0x80000000u;
constexpr float kHalfInf = SRT_POS_INF * 0.5f;

// A cost's order key: unsigned order is float order (no NaN); x + 0.0f
// makes -0 a +0, so equal costs get equal keys.
__device__ __forceinline__ unsigned cost_key(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_cost(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__host__ __device__ inline long long round8(long long x) { return (x + 7) & ~7ll; }

// The sort buffers' length: the widest run layout any round writes for up
// to mmax survivors (ops/beam_kernels._sort_cap mirrors it).
__host__ __device__ inline long long sort_cap(long long mmax, long long k) {
  long long n = (mmax + kRun - 1) / kRun, len = kRun, need = n * kRun;
  while (n > 1) {
    const long long g = n < kGroup ? n : kGroup;
    n = (n + g - 1) / g;
    len = g * len < k ? g * len : k;
    if (n * len > need) need = n * len;
  }
  return need;
}

// A stream's working set.  key [S] u64, two sort buffers [sort_cap] u64,
// tokidx [S] (a state's index in the frontier), the sort's places (two
// [sort_cap], beside the sort buffers), touched [mmax]; the
// frontier F (state, cost, pred, first edge, edge count) [k]; M: keys [k]
// u64, (state, cost, prev, pred, end slot, end word, first edge, edge
// count) [k], endlist [min(k, L)]; the eps candidates (state, cost, prev,
// word, pred, first edge, edge count) [R]; the winners (key [R] u64, the
// index in M each replaces or -1, word start) [R].  ops/beam_kernels.py
// mirrors it (_layout_bytes).
struct Beam {
  u64 *key, *sa, *sb, *mkey, *wkey;
  int *tokidx, *ra, *rb, *touched, *fstate, *fpred, *foff, *fcnt;
  int *mstate, *mprev, *mpred, *mslot, *mword, *moff, *mcnt, *endlist;
  float *fcost, *mcost, *ecost;
  int *estate, *eprev, *eword, *epred, *eoff, *ecnt, *wkill, *wr;
};

#define BEAM_TAKE(field, type, count)                                  \
  do {                                                                 \
    if (base) p->field = (type*)(base + off);                          \
    off += round8((long long)sizeof(type) * (long long)(count));       \
  } while (0)

__host__ __device__ inline long long beam_layout(char* base, Beam* p, int S, int k, int mmax,
                                                 int R, int L) {
  const long long cap = sort_cap(mmax, k);
  const int n_end = k < L ? k : L;
  long long off = 0;
  BEAM_TAKE(key, u64, S);
  BEAM_TAKE(sa, u64, cap);
  BEAM_TAKE(sb, u64, cap);
  BEAM_TAKE(mkey, u64, k);
  BEAM_TAKE(wkey, u64, R);
  BEAM_TAKE(tokidx, int, S);
  BEAM_TAKE(ra, int, cap);
  BEAM_TAKE(rb, int, cap);
  BEAM_TAKE(touched, int, mmax);
  BEAM_TAKE(fstate, int, k);
  BEAM_TAKE(fcost, float, k);
  BEAM_TAKE(fpred, int, k);
  BEAM_TAKE(foff, int, k);
  BEAM_TAKE(fcnt, int, k);
  BEAM_TAKE(mstate, int, k);
  BEAM_TAKE(mcost, float, k);
  BEAM_TAKE(mprev, int, k);
  BEAM_TAKE(mpred, int, k);
  BEAM_TAKE(mslot, int, k);
  BEAM_TAKE(mword, int, k);
  BEAM_TAKE(moff, int, k);
  BEAM_TAKE(mcnt, int, k);
  BEAM_TAKE(endlist, int, n_end);
  BEAM_TAKE(estate, int, R);
  BEAM_TAKE(ecost, float, R);
  BEAM_TAKE(eprev, int, R);
  BEAM_TAKE(eword, int, R);
  BEAM_TAKE(epred, int, R);
  BEAM_TAKE(eoff, int, R);
  BEAM_TAKE(ecnt, int, R);
  BEAM_TAKE(wkill, int, R);
  BEAM_TAKE(wr, int, R);
  return off;
}

// A stream's counters (stats): frames, survivors summed over its frames,
// the most survivors in a frame, then thread 0's clock64 cycles summed by
// phase: proposals, the warp sort, the merge rounds with the M step, the
// eps pass (and the word starts' rivalry), the ranks and the frame's end.
constexpr int kStats = 8;

// two staged emission rows in front of the working set
__host__ __device__ inline long long row_bytes(int U) { return 2 * round8(4ll * U); }

struct BeamArgs {
  const float* nll;        // [B, T, U]
  const int4* edges;       // [E]: target, weight bits, target's bank row, 0
  const int4* rec;         // [S]: first edge, edge count, end slot, end word
  const int4* init;        // [R0]: state, init cost bits, bank row, 0
  const int4* starts;      // [R]: state, bank row, first edge, edge count
  const float* eps_block;  // [R, L]
  const float* bigram;     // [V + 1, V] (kBigram)
  const int* nf;           // [B]
  int* final_state;        // [B, k]
  float* final_cost;
  int* final_pred;
  int* tok_state;          // [B, T, k]
  int* tok_prev;
  int* tok_word;
  char* scratch;           // device tier: B rows of `stride` bytes
  long long* stats;        // [B, kStats] or null (below)
  long long stride;
  int B, T, U, S, R, L, R0, V, k, mmax, dup_starts, staged;  // staged: the device tier's rows
};

__device__ __forceinline__ void prefetch_l1(const void* ptr) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(ptr));
}

// A live candidate for state tgt from origin state `origin`: the key
// table keeps each state's least (cost, origin); the thread that finds the
// entry empty lists the state and fetches its record into L1 for the M
// step.
__device__ __forceinline__ void propose(const Beam& p, const BeamArgs& a, int tgt, float v,
                                        int origin, int* count) {
  if (!(v < kHalfInf)) return;
  const u64 key = ((u64)cost_key(v) << 32) | (unsigned)origin;
  if (atomicMin(&p.key[tgt], key) == kEmpty) {
    p.touched[atomicAdd(count, 1)] = tgt;
    prefetch_l1(a.rec + tgt);
  }
}

// Ascending bitonic sort of one key a lane across the warp.
__device__ __forceinline__ u64 warp_sort(u64 v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, v, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  }
  return v;
}

// The M step: M's token at index i is the survivor of key x (cost key <<
// 32 | state); its payload, its state record, and the key table entry of
// its state now holds i.  m_load reads what the token needs (before its
// place is known, where the ranking allows), m_store writes it.
struct MLoad {
  int4 rec;
  u64 full;
  int prev, pred;
};

__device__ __forceinline__ MLoad m_load(const Beam& p, const BeamArgs& a, int t, u64 x) {
  const int s = x == kEmpty ? 0 : (int)(x & 0xffffffffu);  // a pad reads state 0
  MLoad m;
  m.rec = __ldg(a.rec + s);
  m.full = p.key[s];
  m.prev = -1;
  m.pred = a.V;
  if (t > 0) {
    m.prev = p.tokidx[(int)(m.full & 0xffffffffu)];
    m.pred = p.fpred[m.prev];
  }
  return m;
}

__device__ __forceinline__ void m_store(const Beam& p, int i, u64 x, const MLoad& m,
                                        int* n_end) {
  const int s = (int)(x & 0xffffffffu);
  p.mkey[i] = x;
  p.mstate[i] = s;
  p.mcost[i] = key_cost((unsigned)(x >> 32));
  p.mprev[i] = m.prev;
  p.mpred[i] = m.pred;
  p.moff[i] = m.rec.x;
  p.mcnt[i] = m.rec.y;
  p.mslot[i] = m.rec.z;
  p.mword[i] = m.rec.w;
  p.key[s] = (m.full & kHigh) | kInM | (unsigned)i;
  if (m.rec.z >= 0) p.endlist[atomicAdd(n_end, 1)] = i;
}

// Up to 32 survivors ranked by one warp: their keys sorted across its
// lanes, and the M step at each place below n1.
__device__ __forceinline__ void rank_in_warp(const Beam& p, const BeamArgs& a, int t, int m,
                                             int n1, int lane, int* n_end) {
  const int s = p.touched[min(lane, m - 1)];
  const u64 kv = p.key[s];
  const u64 v = warp_sort(lane < m ? (kv & kHigh) | (unsigned)s : kEmpty, lane);
  if (lane < n1) m_store(p, lane, v, m_load(p, a, t, v), n_end);
}

// One round for up to Q runs of 32 (the runs at sa, n_runs <= Q): a
// thread a key e below n1 in its run, its place the count of keys below it
// in every run (its own gives its index), each a 5-step search plus a
// last compare, the runs searched side by side; the M step at places
// below n1, its loads issued before the search.
template <int Q>
__device__ __forceinline__ void rank_runs(const Beam& p, const BeamArgs& a, int t, int n_runs,
                                          int n1, int tid, int nt, int* n_end) {
  for (int e = tid; e < n_runs * kRun; e += nt) {
    const u64 x = p.sa[e];
    if (x == kEmpty || (e & (kRun - 1)) >= n1) continue;
    const MLoad ml = m_load(p, a, t, x);
    int at[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) at[q] = min(q, n_runs - 1) * kRun;
#pragma unroll
    for (int step = kRun / 2; step > 0; step >>= 1) {
      u64 y[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) y[q] = p.sa[at[q] + step - 1];
#pragma unroll
      for (int q = 0; q < Q; ++q) at[q] += y[q] < x ? step : 0;
    }
    int pos = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const u64 y = p.sa[at[q]];
      pos += q < n_runs ? at[q] - q * kRun + (y < x) : 0;
    }
    if (pos < n1) m_store(p, pos, x, ml, n_end);
  }
}

// An eps candidate of word start r against M's token of its state: it
// wins where that state is not in M or at a strictly lower cost, and is
// listed with its key and the index of the token it replaces (or -1);
// cnt counts the winners [2] and the tokens they replace [3].
__device__ __forceinline__ void eps_win(const Beam& p, int r, int* cnt) {
  const int st = p.estate[r];
  const u64 kv = p.key[st];
  int kill = -1;
  if (kv != kEmpty && ((unsigned)kv & kInM)) {
    kill = (int)((unsigned)kv & ~kInM);
    if (!(p.ecost[r] < p.mcost[kill])) return;
    atomicAdd(&cnt[3], 1);
  }
  const int w = atomicAdd(&cnt[2], 1);
  p.wkey[w] = ((u64)cost_key(p.ecost[r]) << 32) | (unsigned)st;
  p.wkill[w] = kill;
  p.wr[w] = r;
}

// kBound: the most threads a CTA launches with (the registers a thread
// may take follow from it); kSmem: the working set and the rows in shared
// memory, so every access to them compiles to a shared-memory instruction
// (through the generic pointers of the device tier an atomic first tries
// the global space)
template <bool kBigram, int kBound, bool kSmem>
__global__ void __launch_bounds__(kBound) token_beam_kernel(const BeamArgs a) {
  extern __shared__ __align__(16) char smem[];
  // per frame parity: survivors, M's end tokens, eps winners, the tokens
  // they replace
  __shared__ int s_cnt[2][4];
  __shared__ long long s_cyc[5];  // the phases' cycles (stats)
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int S = a.S, k = a.k, R = a.R, T = a.T, U = a.U, V = a.V;
  float* rows = (float*)smem;
  const int row_stride = (int)(round8(4ll * U) / 4);  // floats a staged row
  Beam p;
  char* base = kSmem ? smem + row_bytes(U) : a.scratch + (long long)b * a.stride;
  const bool staged = kSmem || a.staged;
  beam_layout(base, &p, S, k, a.mmax, R, a.L);
  for (int i = tid; i < S; i += nt) p.key[i] = kEmpty;
  if (tid < 8) s_cnt[tid / 4][tid % 4] = 0;
  if (tid < 5) s_cyc[tid] = 0;
  const bool trace = a.stats && tid == 0;
  long long tick = 0;
#define BEAM_TICK(phase)                  \
  if (trace) {                            \
    const long long now_ = clock64();     \
    s_cyc[phase] += now_ - tick;          \
    tick = now_;                          \
  }
  const int nfb = a.nf[b];
  const int t_end = max(1, min(nfb, T));
  const long long plane_b = (long long)b * T * k;
  const float* nll_b = a.nll + (long long)b * T * U;
  if (staged) {
    for (int u = tid; u < U; u += nt) cp_async4(rows + u, nll_b + u);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  int n_live = 0, m_max = 0;
  long long m_sum = 0;
  if (trace) tick = clock64();
  for (int t = 0; t < t_end; ++t) {
    const float* row = staged ? rows + (t & 1) * row_stride : nll_b + (long long)t * U;
    if (staged && t + 1 < t_end) {
      float* next = rows + ((t + 1) & 1) * row_stride;
      for (int u = tid; u < U; u += nt) cp_async4(next + u, nll_b + (long long)(t + 1) * U + u);
      cp_async_commit();
    }
    int* cnt = s_cnt[t & 1];

    // 1. candidates -> the key table
    if (t == 0) {
      for (int i = tid; i < a.R0; i += nt) {
        const int4 e = __ldg(a.init + i);
        propose(p, a, e.x, fminf(__int_as_float(e.y) + row[e.z], SRT_POS_INF), e.x, &cnt[0]);
      }
    } else {
      // g = 1 << lg threads a token: the largest power of two, at most 32,
      // with g * n_live <= nt (nt a power of two)
      const int lg = min(5, max(0, (31 - __clz(nt)) - (n_live > 1 ? 32 - __clz(n_live - 1) : 0)));
      const int g = 1 << lg;
      for (int j = tid >> lg; j < n_live; j += nt >> lg) {
        const int s = p.fstate[j], off = p.foff[j], n = p.fcnt[j];
        const float c = p.fcost[j];
        // four of the token's edge records loaded at once (past its run,
        // its last one again: the loads take no branch), then proposed
        for (int e0 = tid & (g - 1); e0 < n; e0 += 4 * g) {
          int4 ed[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) ed[u] = __ldg(a.edges + off + min(e0 + u * g, n - 1));
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (e0 + u * g < n)
              propose(p, a, ed[u].x,
                      fminf((c + __int_as_float(ed[u].y)) + row[ed[u].z], SRT_POS_INF), s,
                      &cnt[0]);
        }
      }
    }
    __syncthreads();
    BEAM_TICK(0);

    // 2. the survivors' (cost, state) keys sorted a warp a run of 32; one
    // run is ranked at once, with the M step
    const int m = cnt[0];
    const int n1 = min(m, k);
    const int n_runs = (m + kRun - 1) / kRun;
    if (n_runs == 1) {
      if (warp == 0) rank_in_warp(p, a, t, m, n1, lane, &cnt[1]);
    } else {
      for (int w = warp; w < n_runs; w += nw) {
        const int i = w * kRun + lane;
        const int s = p.touched[min(i, m - 1)];
        const u64 kv = p.key[s];
        const u64 v = warp_sort(i < m ? (kv & kHigh) | (unsigned)s : kEmpty, lane);
        p.sa[i] = v;
        if (n_runs > kGroup) p.ra[i] = lane;
      }
    }
    __syncthreads();
    BEAM_TICK(1);
    if (n_runs > 1 && n_runs <= 2)
      rank_runs<2>(p, a, t, n_runs, n1, tid, nt, &cnt[1]);
    else if (n_runs > 2 && n_runs <= 4)
      rank_runs<4>(p, a, t, n_runs, n1, tid, nt, &cnt[1]);
    else if (n_runs > 4 && n_runs <= kGroup)
      rank_runs<kGroup>(p, a, t, n_runs, n1, tid, nt, &cnt[1]);
    if (n_runs > 1 && n_runs <= kGroup) __syncthreads();

    // ... past kGroup runs, merged a group of up to kGroup runs a round,
    // the first k kept: a key's place is its index plus its count in each
    // other run of its group, one search an item (key, other run) spread
    // over the block and added into the key's place; then the keys move to
    // their places (the padding of the runs is preset), and the last round
    // runs the M step
    if (n_runs > kGroup) {
      u64 *src = p.sa, *dst = p.sb;
      int *rsrc = p.ra, *rdst = p.rb;
      int n = n_runs, len = kRun;
      while (n > 1) {
        const int g = min(n, kGroup);
        const int n_out = (n + g - 1) / g;
        const int len_out = min(g * len, k);
        int top = 1;
        while (2 * top <= len) top <<= 1;
        // (key e, j-th other run of its group) for j < g - 1; the last
        // group may hold fewer runs, whose missing items are skipped
        const int items = n * len * (g - 1);
        for (int w = tid; w < items; w += nt) {
          const int e = w / (g - 1), j = w - e * (g - 1);
          const int run = e / len, i = e - run * len;
          const int g0 = run - run % g, q = j < run - g0 ? j : j + 1;
          const u64 x = src[e];
          if (g0 + q >= n || x == kEmpty || i >= len_out) continue;
          const u64* other = src + (long long)(g0 + q) * len;
          int at = 0;
          for (int step = top; step > 0; step >>= 1) {
            const int c = at + step;
            at = c <= len && other[min(c, len) - 1] < x ? c : at;
          }
          if (at) atomicAdd(&rsrc[e], at);
        }
        if (n_out > 1)
          for (int q = tid; q < n_out * len_out; q += nt) dst[q] = kEmpty;
        __syncthreads();
        // each key to its place, with its index there for the next round
        for (int e = tid; e < n * len; e += nt) {
          const u64 x = src[e];
          const int r = rsrc[e];
          if (x == kEmpty || r >= len_out) continue;
          if (n_out > 1) {
            const long long at = (long long)(e / len / g) * len_out + r;
            dst[at] = x;
            rdst[at] = r;
          } else if (r < n1) {
            m_store(p, r, x, m_load(p, a, t, x), &cnt[1]);
          }
        }
        __syncthreads();
        u64* tmp = src;
        src = dst;
        dst = tmp;
        int* rtmp = rsrc;
        rsrc = rdst;
        rdst = rtmp;
        n = n_out;
        len = len_out;
      }
    }
    BEAM_TICK(2);

    // 4. eps: one warp a word start
    const int ne = cnt[1];
    for (int r = warp; r < R; r += nw) {
      const int4 st4 = __ldg(a.starts + r);
      u64 best = kEmpty;
      int bi = -1;
      for (int e = lane; e < ne; e += 32) {
        const int i = p.endlist[e];
        const int slot = p.mslot[i];
        float ex = p.mcost[i];
        if (kBigram) {
          const int w = p.mword[i];
          const long long at = (long long)min(max(p.mpred[i], 0), V) * V + min(max(w, 0), V - 1);
          const float bg = __ldg(a.bigram + at);  // in range: read without a branch
          ex = ex + (w >= 0 ? bg : SRT_POS_INF);
        }
        const float score = __ldg(a.eps_block + (long long)r * a.L + slot) + ex;
        const u64 key = ((u64)cost_key(score) << 32) | (unsigned)slot;
        if (key < best) {
          best = key;
          bi = i;
        }
      }
      // the warp's least (score key, slot): the least score key, then the
      // least slot at it
      const unsigned kmin = __reduce_min_sync(0xffffffffu, (unsigned)(best >> 32));
      const u64 wb = ((u64)kmin << 32) |
                     __reduce_min_sync(0xffffffffu,
                                       (unsigned)(best >> 32) == kmin ? (unsigned)best : ~0u);
      const unsigned who = __ballot_sync(0xffffffffu, best == wb);
      const int i = __shfl_sync(0xffffffffu, bi, __ffs(who) - 1);
      if (lane == 0) {
        p.estate[r] = -1;
        if (wb != kEmpty) {
          const float v = fminf(key_cost((unsigned)(wb >> 32)) + row[st4.y], SRT_POS_INF);
          if (v < kHalfInf) {
            const int w = p.mword[i];
            p.estate[r] = st4.x;
            p.ecost[r] = v;
            p.eprev[r] = p.mprev[i];
            p.eword[r] = w;
            p.epred[r] = kBigram ? w : V;
            p.eoff[r] = st4.z;
            p.ecnt[r] = st4.w;
            if (!a.dup_starts) eps_win(p, r, cnt);
          }
        }
      }
    }
    __syncthreads();
    if (a.dup_starts) {
      // word starts that share a state: the first of least cost wins
      for (int r = tid; r < R; r += nt) {
        const int st = p.estate[r];
        if (st < 0) continue;
        const float c = p.ecost[r];
        bool lost = false;
        for (int r2 = 0; r2 < R && !lost; ++r2)
          lost = r2 != r && p.estate[r2] == st &&
                 (p.ecost[r2] < c || (p.ecost[r2] == c && r2 < r));
        if (!lost) eps_win(p, r, cnt);
      }
      __syncthreads();
    }
    BEAM_TICK(3);

    // 5. the ranks of the survivors: the next frontier and the planes
    const int n_win = cnt[2];
    const int n_new = min(k, n1 - cnt[3] + n_win);
    int* ts = a.tok_state + plane_b + (long long)t * k;
    int* tp = a.tok_prev + plane_b + (long long)t * k;
    int* tw = a.tok_word + plane_b + (long long)t * k;
    for (int q = tid; q < n1 + n_win; q += nt) {
      int rank, st, prev, word, pred, off, n;
      float cost;
      if (q < n1) {
        const u64 key = p.mkey[q];
        bool killed = false;
        rank = q;
#pragma unroll 4
        for (int w = 0; w < n_win; ++w) {
          const int x = p.wkill[w];
          killed |= x == q;
          rank -= x >= 0 && x < q;
          rank += p.wkey[w] < key;
        }
        if (killed) continue;
        st = p.mstate[q];
        cost = p.mcost[q];
        prev = p.mprev[q];
        word = -1;
        pred = p.mpred[q];
        off = p.moff[q];
        n = p.mcnt[q];
      } else {
        const int w0 = q - n1, r = p.wr[w0];
        const u64 key = p.wkey[w0];
        int lo = 0, hi = n1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (p.mkey[mid] < key)
            lo = mid + 1;
          else
            hi = mid;
        }
        rank = lo;
        for (int w = 0; w < n_win; ++w) {
          const int x = p.wkill[w];
          rank -= x >= 0 && x < lo;
          rank += w != w0 && p.wkey[w] < key;
        }
        st = p.estate[r];
        cost = p.ecost[r];
        prev = p.eprev[r];
        word = p.eword[r];
        pred = p.epred[r];
        off = p.eoff[r];
        n = p.ecnt[r];
      }
      if (rank >= k) continue;
      p.fstate[rank] = st;
      p.fcost[rank] = cost;
      p.fpred[rank] = pred;
      p.foff[rank] = off;
      p.fcnt[rank] = n;
      p.tokidx[st] = rank;
      ts[rank] = st;
      tp[rank] = prev;
      tw[rank] = word;
      // the token's edge records into L1 for the next frame's proposals
      if (n > 0) {
        prefetch_l1(a.edges + off);
        prefetch_l1(a.edges + off + n - 1);
      }
    }
    for (int j = n_new + tid; j < k; j += nt) {
      ts[j] = -1;
      tp[j] = -1;
      tw[j] = -1;
    }
    for (int i = tid; i < m; i += nt) p.key[p.touched[i]] = kEmpty;
    if (tid < 4) s_cnt[(t + 1) & 1][tid] = 0;
    m_sum += m;
    m_max = max(m_max, m);
    n_live = n_new;
    if (staged) cp_async_wait_all();
    __syncthreads();
    BEAM_TICK(4);
  }
#undef BEAM_TICK

  // rows past the stream's last frame, and the final frontier
  for (long long i = (long long)t_end * k + tid; i < (long long)T * k; i += nt) {
    a.tok_state[plane_b + i] = -1;
    a.tok_prev[plane_b + i] = -1;
    a.tok_word[plane_b + i] = -1;
  }
  const bool fin = nfb >= 1 && nfb <= T;
  for (int j = tid; j < k; j += nt) {
    const bool live = fin && j < n_live;
    const long long o = (long long)b * k + j;
    a.final_state[o] = live ? p.fstate[j] : -1;
    a.final_cost[o] = live ? p.fcost[j] : SRT_POS_INF;
    a.final_pred[o] = live ? p.fpred[j] : -1;
  }
  if (trace) {
    long long* st = a.stats + (long long)kStats * b;
    st[0] = t_end;
    st[1] = m_sum;
    st[2] = m_max;
    for (int i = 0; i < 5; ++i) st[3 + i] = s_cyc[i];
  }
}

}  // namespace

// A stream's working set in bytes, for the wrapper's plan to be held
// against.
extern "C" long long token_beam_bytes(int S, int k, int mmax, int R, int L) {
  return beam_layout(nullptr, nullptr, S, k, mmax, R, L);
}

// in_smem: the working set in dynamic shared memory (`bytes` of it) or in
// `scratch`, B rows of `bytes`; staged: the emission rows in shared memory
// (in front of the working set).  mmax: the most states a frame can touch
// (ops/beam_kernels.beam_widest); dup_starts: two word starts share a
// state.  bigram and stats may be null.
extern "C" int token_beam_launch(
    const float* nll, const int* edges, const int* rec, const int* init, const int* starts,
    const float* eps_block, const float* bigram, const int* nf, int* final_state,
    float* final_cost, int* final_pred, int* tok_state, int* tok_prev, int* tok_word,
    void* scratch, long long* stats, int B, int T, int U, int S, int R, int L, int R0, int V,
    int k, int mmax, int dup_starts, int in_smem, int staged, int threads, long long bytes,
    void* stream) {
  if (B <= 0 || T <= 0 || U <= 0 || S <= 0 || R < 0 || L < 0 || R0 < 0 || R0 > k ||
      k <= 0 || mmax < R0 || mmax > S || (bigram && V <= 0) || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (bytes != beam_layout(nullptr, nullptr, S, k, mmax, R, L))
    return (int)cudaErrorInvalidValue;
  if (!in_smem && !scratch) return (int)cudaErrorInvalidValue;
  BeamArgs a{nll,
             (const int4*)edges,
             (const int4*)rec,
             (const int4*)init,
             (const int4*)starts,
             eps_block,
             bigram,
             nf,
             final_state,
             final_cost,
             final_pred,
             tok_state,
             tok_prev,
             tok_word,
             (char*)scratch,
             stats,
             bytes,
             B,
             T,
             U,
             S,
             R,
             L,
             R0,
             bigram ? V : 0,
             k,
             mmax,
             dup_starts,
             staged};
  const long long smem = (staged ? row_bytes(U) : 0) + (in_smem ? bytes : 0);
  void (*kernel)(const BeamArgs) = nullptr;
#define K19_PICK(SM)                                                           \
  if (threads <= 256)                                                         \
    kernel = bigram ? &token_beam_kernel<true, 256, SM>                       \
                    : &token_beam_kernel<false, 256, SM>;                     \
  else                                                                        \
    kernel = bigram ? &token_beam_kernel<true, kMaxThreads, SM>               \
                    : &token_beam_kernel<false, kMaxThreads, SM>
  if (in_smem) {
    if (!staged) return (int)cudaErrorInvalidValue;
    K19_PICK(true);
  } else {
    K19_PICK(false);
  }
#undef K19_PICK
  if (smem) SRT_SET_SMEM(kernel, smem);
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
