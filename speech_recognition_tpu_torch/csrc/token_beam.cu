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
//     below S) at c + band[d, s + d] and, with kCross, each child-arc start
//     child_starts[s, i] >= 0 at c + child_costs[s, i]; each adds the
//     target's emission nll[b, t, bank_state[tgt]], clamped at POS_INF
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
// What bounds it on the H100: a frame is ~k (3 + C) candidates (1,024 at
// k = 64 on the 1k trie) through a dedup and a sort: a chain of short
// dependent steps, each a block barrier, for T frames; the bytes (the
// emission rows, the planes written) are a few MB.  So the time is the
// barriers and sort stages of T frames, not bandwidth.  Design: one CTA a
// stream, the whole frame loop inside the kernel, nothing read back.  The
// dedup is a 64-bit atomicMin of (cost key << 32 | origin) on a dense key
// table of S entries (reset only at the states touched, listed by the
// first thread that touches each); the survivors' keys (cost key << 32 |
// state) are bitonic-sorted at the next power of two of their count; the
// eps scores are one warp a word start; the second merge ranks each of
// M's tokens and each eps winner directly (M is sorted, at most R eps
// tokens), so it needs no sort.  beam_plan (ops/beam_kernels.py) puts a
// stream's tables (keys, token index per state, frontiers, sort buffer)
// and the staged emission row in shared memory where they fit (the 1k trie
// at k = 64: ~130 KB), else in a device scratch a stream (the
// dictionary-shaped trie, or k = S) through the same generic pointers, so
// no size is refused.

#include "common.cuh"

namespace {

typedef unsigned long long u64;
constexpr u64 kEmpty = ~0ull;
constexpr int kMaxThreads = 1024;
constexpr float kHalfInf = SRT_POS_INF * 0.5f;
// an eps candidate's state in the second merge: not live, live (kills no
// token of M), or >= 0 the index in M of the token it replaces
constexpr int kNone = -2;
constexpr int kLive = -1;

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

__host__ __device__ inline long long pow2_at_least(long long m) {
  long long p = 1;
  while (p < m) p <<= 1;
  return p;
}

// A stream's working set.  key [S] u64, sorted [P] u64 (P the power of two
// at least mmax = min(S, k nb), the most states a frame can touch), tokidx
// [S] (a state's index in the frontier, or in M between the merges),
// slotidx [L] (an end slot's index in M), touched [mmax], the frontier F
// (state, cost, pred) [k], M (state, cost, prev, pred) [k], endlist
// [min(k, L)], the eps candidates (state, cost, prev, word, pred, kill,
// result) [R] and, staged, the frame's emission row [U].
// ops/beam_kernels.py mirrors it (_layout_bytes).
struct Beam {
  u64 *key, *sorted;
  int *tokidx, *slotidx, *touched, *fstate, *fpred, *mstate, *mprev, *mpred, *endlist;
  float *fcost, *mcost;
  int *estate, *eprev, *eword, *epred, *ekill, *eres;
  float *ecost, *nllrow;
};

#define BEAM_TAKE(field, type, count)                                  \
  do {                                                                 \
    if (base) p->field = (type*)(base + off);                          \
    off += round8((long long)sizeof(type) * (long long)(count));       \
  } while (0)

__host__ __device__ inline long long beam_layout(char* base, Beam* p, int S, int k, int nb,
                                                 int R, int L, int U, int staged) {
  long long mmax = (long long)k * nb;
  if (mmax > S) mmax = S;
  const long long P = pow2_at_least(mmax);
  const int n_end = k < L ? k : L;
  long long off = 0;
  BEAM_TAKE(key, u64, S);
  BEAM_TAKE(sorted, u64, P);
  BEAM_TAKE(tokidx, int, S);
  BEAM_TAKE(slotidx, int, L);
  BEAM_TAKE(touched, int, mmax);
  BEAM_TAKE(fstate, int, k);
  BEAM_TAKE(fcost, float, k);
  BEAM_TAKE(fpred, int, k);
  BEAM_TAKE(mstate, int, k);
  BEAM_TAKE(mcost, float, k);
  BEAM_TAKE(mprev, int, k);
  BEAM_TAKE(mpred, int, k);
  BEAM_TAKE(endlist, int, n_end);
  BEAM_TAKE(estate, int, R);
  BEAM_TAKE(ecost, float, R);
  BEAM_TAKE(eprev, int, R);
  BEAM_TAKE(eword, int, R);
  BEAM_TAKE(epred, int, R);
  BEAM_TAKE(ekill, int, R);
  BEAM_TAKE(eres, int, R);
  BEAM_TAKE(nllrow, float, staged ? U : 0);
  return off;
}

struct BeamArgs {
  const float* nll;                // [B, T, U]
  const float* band;               // [3, S]
  const long long* child_starts;   // [S, C]
  const float* child_costs;        // [S, C]
  const long long* end_slot;       // [S]
  const long long* end_word;       // [S]
  const long long* word_starts;    // [R]
  const float* eps_block;          // [R, L]
  const long long* init_states;    // [R0]
  const float* init_costs;         // [R0]
  const long long* bank_state;     // [S]
  const float* bigram;             // [V + 1, V] (kBigram)
  const int* nf;                   // [B]
  int* final_state;                // [B, k]
  float* final_cost;
  int* final_pred;
  int* tok_state;                  // [B, T, k]
  int* tok_prev;
  int* tok_word;
  char* scratch;                   // device tier: B rows of `stride` bytes
  long long stride;
  int B, T, U, S, C, R, L, R0, V, k, staged, in_smem;
};

// A live candidate for state tgt from origin state `origin`: the key
// table keeps each state's least (cost, origin); the thread that finds the
// entry empty lists the state.
__device__ __forceinline__ void propose(const Beam& p, int tgt, float v, int origin,
                                        int* count) {
  if (!(v < kHalfInf)) return;
  const u64 key = ((u64)cost_key(v) << 32) | (unsigned)origin;
  if (atomicMin(&p.key[tgt], key) == kEmpty) p.touched[atomicAdd(count, 1)] = tgt;
}

// Ascending bitonic sort of v[0, n), n a power of two, by the whole block;
// ends with a barrier.
__device__ void bitonic_sort(u64* v, int n, int tid, int nt) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (n >> 1); i += nt) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const u64 x = v[lo], y = v[hi];
        if ((x > y) == ((lo & size) == 0)) {
          v[lo] = y;
          v[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ u64 eps_key(const Beam& p, int r) {
  return ((u64)cost_key(p.ecost[r]) << 32) | (unsigned)p.estate[r];
}

template <bool kCross, bool kBigram>
__global__ void __launch_bounds__(kMaxThreads) token_beam_kernel(const BeamArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_m, s_ne;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int S = a.S, k = a.k, R = a.R, T = a.T, U = a.U, V = a.V;
  const int nb = 3 + (kCross ? a.C : 0);
  Beam p;
  char* base = a.in_smem ? smem : a.scratch + (long long)b * a.stride;
  beam_layout(base, &p, S, k, nb, R, a.L, U, a.staged);
  for (int i = tid; i < S; i += nt) {
    p.key[i] = kEmpty;
    p.tokidx[i] = -1;
  }
  const int nfb = a.nf[b];
  const int t_end = max(1, min(nfb, T));
  const long long plane_b = (long long)b * T * k;
  int n_live = 0;
  for (int t = 0; t < t_end; ++t) {
    const float* row = a.nll + ((long long)b * T + t) * U;
    if (a.staged) {
      for (int u = tid; u < U; u += nt) p.nllrow[u] = row[u];
      row = p.nllrow;
    }
    if (tid == 0) {
      s_m = 0;
      s_ne = 0;
    }
    __syncthreads();

    // candidates -> the key table
    if (t == 0) {
      for (int i = tid; i < a.R0; i += nt) {
        const int s = (int)a.init_states[i];
        propose(p, s, fminf(a.init_costs[i] + row[a.bank_state[s]], SRT_POS_INF), s, &s_m);
      }
    } else {
      const int items = n_live * nb;
      for (int q = tid; q < items; q += nt) {
        const int blk = q / n_live, j = q - blk * n_live;
        const int s = p.fstate[j];
        int tgt;
        float w;
        if (blk < 3) {
          tgt = s + blk;
          if (tgt >= S) continue;
          w = a.band[(long long)blk * S + tgt];
        } else {
          const long long e = (long long)s * a.C + (blk - 3);
          const long long c = a.child_starts[e];
          if (c < 0) continue;
          tgt = (int)c;
          w = a.child_costs[e];
        }
        propose(p, tgt, fminf((p.fcost[j] + w) + row[a.bank_state[tgt]], SRT_POS_INF), s,
                &s_m);
      }
    }
    __syncthreads();

    // the survivors' (cost, state) keys, sorted
    const int m = s_m;
    const int P = (int)pow2_at_least(m);
    for (int i = tid; i < P; i += nt) {
      u64 v = kEmpty;
      if (i < m) {
        const int s = p.touched[i];
        v = (p.key[s] & 0xffffffff00000000ull) | (unsigned)s;
      }
      p.sorted[i] = v;
    }
    __syncthreads();
    bitonic_sort(p.sorted, P, tid, nt);

    // M: the first k, with their payloads; the key table is reset
    const int n1 = min(m, k);
    for (int i = tid; i < m; i += nt) {
      const int s = (int)(p.sorted[i] & 0xffffffffu);
      const u64 full = p.key[s];
      p.key[s] = kEmpty;
      if (i < n1) {
        int prev = -1, pred = V;
        if (t > 0) {
          prev = p.tokidx[(int)(full & 0xffffffffu)];
          pred = p.fpred[prev];
        }
        p.mstate[i] = s;
        p.mcost[i] = key_cost((unsigned)(full >> 32));
        p.mprev[i] = prev;
        p.mpred[i] = pred;
        const int slot = (int)a.end_slot[s];
        if (slot >= 0) {
          p.endlist[atomicAdd(&s_ne, 1)] = i;
          p.slotidx[slot] = i;
        }
      }
    }
    __syncthreads();

    // eps: one warp a word start
    for (int i = tid; i < n1; i += nt) p.tokidx[p.mstate[i]] = i;
    const int ne = s_ne;
    for (int r = warp; r < R; r += nw) {
      u64 best = kEmpty;
      for (int e = lane; e < ne; e += 32) {
        const int i = p.endlist[e];
        const int s = p.mstate[i];
        const int slot = (int)a.end_slot[s];
        float ex = p.mcost[i];
        if (kBigram) {
          const int w = (int)a.end_word[s];
          const long long at = (long long)min(max(p.mpred[i], 0), V) * V + min(max(w, 0), V - 1);
          ex = ex + (w >= 0 ? a.bigram[at] : SRT_POS_INF);
        }
        const float score = a.eps_block[(long long)r * a.L + slot] + ex;
        const u64 key = ((u64)cost_key(score) << 32) | (unsigned)slot;
        best = key < best ? key : best;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const u64 x = __shfl_xor_sync(0xffffffffu, best, o);
        best = x < best ? x : best;
      }
      if (lane == 0) {
        int kill = kNone;
        if (best != kEmpty) {
          const int i = p.slotidx[(int)(best & 0xffffffffu)];
          const int st = (int)a.word_starts[r];
          const float v =
              fminf(key_cost((unsigned)(best >> 32)) + row[a.bank_state[st]], SRT_POS_INF);
          if (v < kHalfInf) {
            const int w = (int)a.end_word[p.mstate[i]];
            p.estate[r] = st;
            p.ecost[r] = v;
            p.eprev[r] = p.mprev[i];
            p.eword[r] = w;
            p.epred[r] = kBigram ? w : V;
            kill = kLive;
          }
        }
        p.ekill[r] = kill;
      }
    }
    __syncthreads();

    // the second merge: which eps candidates win, and whom they replace
    for (int r = tid; r < R; r += nt) {
      int res = kNone;
      if (p.ekill[r] == kLive) {
        const int st = p.estate[r];
        const float c = p.ecost[r];
        bool lost = false;
        for (int r2 = 0; r2 < R && !lost; ++r2)
          lost = r2 != r && p.ekill[r2] == kLive && p.estate[r2] == st &&
                 (p.ecost[r2] < c || (p.ecost[r2] == c && r2 < r));
        if (!lost) {
          const int i = p.tokidx[st];
          if (i >= 0 && i < n1 && p.mstate[i] == st)
            res = c < p.mcost[i] ? i : kNone;
          else
            res = kLive;
        }
      }
      p.eres[r] = res;
    }
    __syncthreads();

    // ... and the ranks of the survivors: the next frontier and the planes
    int n_kill = 0, n_win = 0;
    for (int r = 0; r < R; ++r) {
      const int x = p.eres[r];
      n_kill += x >= 0;
      n_win += x >= kLive;
    }
    const int n_new = min(k, n1 - n_kill + n_win);
    int* ts = a.tok_state + plane_b + (long long)t * k;
    int* tp = a.tok_prev + plane_b + (long long)t * k;
    int* tw = a.tok_word + plane_b + (long long)t * k;
    for (int q = tid; q < n1 + R; q += nt) {
      int rank, st, prev, word, pred;
      float cost;
      if (q < n1) {
        const u64 key = p.sorted[q];
        bool killed = false;
        rank = q;
        for (int r = 0; r < R; ++r) {
          const int x = p.eres[r];
          killed |= x == q;
          rank -= x >= 0 && x < q;
          rank += x >= kLive && eps_key(p, r) < key;
        }
        if (killed) continue;
        st = p.mstate[q];
        cost = p.mcost[q];
        prev = p.mprev[q];
        word = -1;
        pred = p.mpred[q];
      } else {
        const int r = q - n1;
        if (p.eres[r] < kLive) continue;
        const u64 key = eps_key(p, r);
        int lo = 0, hi = n1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (p.sorted[mid] < key)
            lo = mid + 1;
          else
            hi = mid;
        }
        rank = lo;
        for (int r2 = 0; r2 < R; ++r2) {
          const int x = p.eres[r2];
          rank -= x >= 0 && x < lo;
          rank += r2 != r && x >= kLive && eps_key(p, r2) < key;
        }
        st = p.estate[r];
        cost = p.ecost[r];
        prev = p.eprev[r];
        word = p.eword[r];
        pred = p.epred[r];
      }
      if (rank >= k) continue;
      p.fstate[rank] = st;
      p.fcost[rank] = cost;
      p.fpred[rank] = pred;
      p.tokidx[st] = rank;
      ts[rank] = st;
      tp[rank] = prev;
      tw[rank] = word;
    }
    for (int j = n_new + tid; j < k; j += nt) {
      ts[j] = -1;
      tp[j] = -1;
      tw[j] = -1;
    }
    n_live = n_new;
    __syncthreads();
  }

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
}

template <bool kCross, bool kBigram>
int launch(const BeamArgs& a, int threads, long long smem, cudaStream_t st) {
  void (*kernel)(const BeamArgs) = token_beam_kernel<kCross, kBigram>;
  if (smem) SRT_SET_SMEM(kernel, smem);
  kernel<<<a.B, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// A stream's working set in bytes (staged: with the emission row), for the
// wrapper's plan to be held against.
extern "C" long long token_beam_bytes(int S, int k, int nb, int R, int L, int U, int staged) {
  return beam_layout(nullptr, nullptr, S, k, nb, R, L, U, staged);
}

// in_smem: the working set in dynamic shared memory (`bytes` of it, the
// emission row staged) or in `scratch`, B rows of `bytes` (not staged).
// has_cross / bigram pick the template; bigram may be null otherwise.
extern "C" int token_beam_launch(
    const float* nll, const float* band, const long long* child_starts,
    const float* child_costs, const long long* end_slot, const long long* end_word,
    const long long* word_starts, const float* eps_block, const long long* init_states,
    const float* init_costs, const long long* bank_state, const float* bigram, const int* nf,
    int* final_state, float* final_cost, int* final_pred, int* tok_state, int* tok_prev,
    int* tok_word, void* scratch, int B, int T, int U, int S, int C, int R, int L, int R0,
    int V, int k, int has_cross, int in_smem, int threads, long long bytes, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0 || S <= 0 || C <= 0 || R < 0 || L < 0 || R0 < 0 ||
      R0 > k || k <= 0 || (bigram && V <= 0) || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const int nb = 3 + (has_cross ? C : 0);
  if (bytes != beam_layout(nullptr, nullptr, S, k, nb, R, L, U, in_smem))
    return (int)cudaErrorInvalidValue;
  if (!in_smem && !scratch) return (int)cudaErrorInvalidValue;
  BeamArgs a{nll,        band,       child_starts, child_costs, end_slot,  end_word,
             word_starts, eps_block, init_states,  init_costs,  bank_state, bigram,
             nf,         final_state, final_cost,  final_pred,  tok_state, tok_prev,
             tok_word,   (char*)scratch, bytes,    B,           T,         U,
             S,          C,          R,            L,           R0,        bigram ? V : 0,
             k,          in_smem,    in_smem};
  const long long smem = in_smem ? bytes : 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (has_cross)
    return bigram ? launch<true, true>(a, threads, smem, st)
                  : launch<true, false>(a, threads, smem, st);
  return bigram ? launch<false, true>(a, threads, smem, st)
                : launch<false, false>(a, threads, smem, st);
}
