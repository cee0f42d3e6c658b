// K22: the lattice word walk, K23: the word-trace walk, and K26: the token
// beam's walk.  Each follows a chain back from each stream's end, one step
// a frame or a word, and writes the word ids in reverse order.
//
// None replaces a TPU kernel: the JAX package runs each as one XLA scan,
// K22 speech_recognition_tpu/ops/lattice.py lattice_words_device, K23
// speech_recognition_tpu/ops/viterbi_banded_pallas.py wordtrace_words_device
// and K26 speech_recognition_tpu/ops/beam.py beam_backtrace (:327, its scan
// :367).  Their plain versions are ops/lattice.lattice_words_ref,
// ops/viterbi_banded_kernels.wordtrace_words_ref and
// ops/beam.beam_backtrace_ref (loops of batched gathers).
//
// K22 (the bigram lattice): the walk of lattice_walk.cuh, from leaf =
// best_leaf[b]; rows past the chain are -1.  The planes are read at the
// strides the wrapper passes, so the public lattice_words_device walks
// any [T, L, B] view.  The bigram pipeline runs the same walk as K7's
// last step (lattice_rescore.cu) and launches no K22.
//
// K23 (the word-trace backend): from v = best_slot[b] entered at t =
// entry_t[b], alive = nf > 0, for T + 1 rows: the row is v while alive,
// else -1; while t > 0 the walk moves to (eps_u[t, v], eps_tau[t, v]) (the
// word K10 recorded at the re-entry of slot v at frame t, and that word's
// entry time); else it ends.  eps_u is int8 or int32 (the type
// _eps_u_dtype picks).  Entry times fall each step, so every chain ends
// within the T + 1 rows, and the plane keeps all of them: nothing is read
// back to cut it.
//
// K26 (the token beam): the best final token is the first minimum over the
// k slots of cost + (end_bonus[slot] (+ bigram[pred, word]) (+
// bigram_end[word])), added in that order, POS_INF where the slot's state is
// dead or no word end; best_cost is that sum and row 0 the token's word.
// Then from the last frame below n_frames back to 0, row T - t is
// tok_word[t, ix] while ix >= 0 (else -1) and ix moves to tok_prev[t, ix]
// for t > 0; rows of frames at or past n_frames are -1.  It reads only the
// live chain, so K19's planes (dead slots -1) and the plain version's
// (dead slots in their sort order) give the same rows.
//
// n_words counts the rows >= 0, as the JAX functions do.  An index is
// clamped to its axis as the JAX scans clamp it.
//
// What bounds them on the H100: a step is a dependent read at a (frame,
// word) known only after the step before (K22: two, tau then pred_w; K23:
// two at the same entry, issued together; K26: tok_prev at (t, ix), with
// tok_word beside it, every frame, after a pass over the k final slots).
// The time is the longest chain's round trips, ~0.5-1 us each where the
// planes are past L2 or cold in it, while the bytes on the chains are a
// few KB.  Design of K22 / K23, and of K26's chain form: one thread a
// stream, no staging; a dead stream writes its remaining rows of -1 and
// stops.
//
// K26's window form (ops/beam_kernels.walk_plan: where a ring of four
// windows of W >= 8 frames of both planes and the stream's rows fit in
// shared memory, e.g. W = 32 at k = 64, and the planes take bulk copies):
// one warp a stream.  The lanes pick the best final slot as a warp
// reduction of (cost key, slot); lane 0 keeps four windows of W frames x
// k slots of tok_prev and tok_word in flight (two bulk copies each, on an
// mbarrier a stage), walks each at a shared-memory load a frame into the
// rows, and refills the stage it left; a chain that dies stops the walk
// and the copies.  The lanes write the rows at the end.

#include "lattice_walk.cuh"

namespace {

constexpr int kThreads = 128;

// pred_w / ends_tau int32 with strides (t, l, b); best_leaf, nf [B] int32
// -> out [max_words, B] int32, n_words [B] int32.
__global__ void __launch_bounds__(kThreads) lattice_walk_kernel(
    const int* __restrict__ pred, long long p_t, long long p_l, long long p_b,
    const int* __restrict__ tau_pl, long long q_t, long long q_l, long long q_b,
    const int* __restrict__ best_leaf, const int* __restrict__ nf, int* __restrict__ out,
    int* __restrict__ n_words, int T, int L, int B, int max_words) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  int count;
  int k = lattice_walk_chain(pred, p_t, p_l, p_b, tau_pl, q_t, q_l, q_b, b, best_leaf[b],
                             nf[b], T, L, B, max_words, out, count);
  for (; k < max_words; ++k) out[(long long)k * B + b] = -1;
  n_words[b] = count;
}

// eps_u (U) / eps_tau (int32) with strides (t, r, b); best_slot, entry_t,
// nf [B] int32 -> out [T + 1, B] int32, n_words [B] int32.
template <typename U>
__global__ void __launch_bounds__(kThreads) wordtrace_walk_kernel(
    const U* __restrict__ eps_u, long long u_t, long long u_r, long long u_b,
    const int* __restrict__ eps_tau, long long e_t, long long e_r, long long e_b,
    const int* __restrict__ best_slot, const int* __restrict__ entry_t,
    const int* __restrict__ nf, int* __restrict__ out, int* __restrict__ n_words, int T, int R,
    int B) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int rows = T + 1;
  int v = best_slot[b];
  int t = entry_t[b];
  int count = 0;
  int k = 0;
  if (nf[b] > 0) {
    for (; k < rows; ++k) {
      out[(long long)k * B + b] = v;
      count += v >= 0;
      if (t <= 0) {
        ++k;
        break;
      }
      const int tc = clamp_index(t, T), vc = clamp_index(v, R);
      v = (int)eps_u[tc * u_t + vc * u_r + b * u_b];
      t = eps_tau[tc * e_t + vc * e_r + b * e_b];
    }
  }
  for (; k < rows; ++k) out[(long long)k * B + b] = -1;
  n_words[b] = count;
}

// A final slot's score for K26: cost + (end_bonus[slot] (+ bigram[pred,
// word]) (+ bigram_end[word])), POS_INF where the slot's state is dead or
// no word end; `word` its word.
template <bool kBigram, bool kEnd>
__device__ __forceinline__ float final_score(const int* final_state, const float* final_cost,
                                             const int* final_pred, const long long* end_slot,
                                             const long long* end_word,
                                             const float* end_bonus, const float* bigram,
                                             const float* bigram_end, long long o, int S,
                                             int E, int V, int* word) {
  const int s = final_state[o];
  const int sc = clamp_index(s, S);
  const int slot = (int)end_slot[sc];
  *word = (int)end_word[sc];
  float bonus = end_bonus[clamp_index(slot, E)];
  if (kBigram) {
    const int wc = clamp_index(*word, V);
    bonus = bonus + bigram[(long long)min(max(final_pred[o], 0), V) * V + wc];
    if (kEnd) bonus = bonus + bigram_end[wc];
  }
  return (s >= 0 && slot >= 0) ? final_cost[o] + bonus : SRT_POS_INF;
}

// A cost's order key: unsigned order is float order (no NaN), -0 as +0.
__device__ __forceinline__ unsigned walk_cost_key(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// K26.  final_state / final_pred [B, k] int32, final_cost [B, k];
// tok_prev / tok_word [B, T, k] int32; end_slot / end_word [S] int64,
// end_bonus [E]; bigram [V + 1, V] and bigram_end [V] where kBigram / kEnd;
// nf [B] int32 -> best_cost [B], words_rev [B, T + 1] int32.
template <bool kBigram, bool kEnd>
__global__ void __launch_bounds__(kThreads) token_walk_kernel(
    const int* __restrict__ final_state, const float* __restrict__ final_cost,
    const int* __restrict__ final_pred, const int* __restrict__ tok_prev,
    const int* __restrict__ tok_word, const long long* __restrict__ end_slot,
    const long long* __restrict__ end_word, const float* __restrict__ end_bonus,
    const float* __restrict__ bigram, const float* __restrict__ bigram_end,
    const int* __restrict__ nf, float* __restrict__ best_cost, int* __restrict__ words_rev,
    int B, int T, int k, int S, int E, int V) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float best = 0.0f;
  int bi = -1, bw = 0;
  for (int j = 0; j < k; ++j) {
    int word;
    const float tot = final_score<kBigram, kEnd>(final_state, final_cost, final_pred, end_slot,
                                                 end_word, end_bonus, bigram, bigram_end,
                                                 (long long)b * k + j, S, E, V, &word);
    if (bi < 0 || tot < best) {
      best = tot;
      bi = j;
      bw = word;
    }
  }
  best_cost[b] = best;
  int* out = words_rev + (long long)b * (T + 1);
  out[0] = bw;
  const int n = min(max(nf[b], 0), T);
  for (int c = 1; c <= T - n; ++c) out[c] = -1;
  int ix = bi;
  for (int t = n - 1; t >= 0; --t) {
    const long long row = ((long long)b * T + t) * k;
    int w = -1;
    if (ix >= 0) {
      w = tok_word[row + ix];
      if (t > 0) ix = tok_prev[row + ix];
    }
    out[T - t] = w;
  }
}

// K26's window form: one warp a stream, W frames a window.  Shared memory
// holds a ring of kWalkStages windows of both planes ([stage][plane][W *
// k] int32, each filled by two bulk copies), the stream's T rows and the
// stages' mbarriers; the planes are 16-byte aligned with k a multiple of 4
// (walk_plan), so every window is a whole number of 16-byte chunks.
constexpr int kWalkStages = 4;

__host__ __device__ inline long long walk_smem(int W, int k, int T) {
  return 4ll * (2ll * kWalkStages * W * k + T) + 8 * kWalkStages + 8;
}

template <bool kBigram, bool kEnd>
__global__ void __launch_bounds__(32) token_walk_window_kernel(
    const int* __restrict__ final_state, const float* __restrict__ final_cost,
    const int* __restrict__ final_pred, const int* __restrict__ tok_prev,
    const int* __restrict__ tok_word, const long long* __restrict__ end_slot,
    const long long* __restrict__ end_word, const float* __restrict__ end_bonus,
    const float* __restrict__ bigram, const float* __restrict__ bigram_end,
    const int* __restrict__ nf, float* __restrict__ best_cost, int* __restrict__ words_rev,
    int T, int k, int S, int E, int V, int W) {
  extern __shared__ __align__(16) int wsm[];
  typedef unsigned long long u64;
  const int b = blockIdx.x, lane = threadIdx.x;
  const long long wk = (long long)W * k;
  int* rows_s = wsm + 2 * kWalkStages * wk;  // rows_s[t]: frame t's word
  const unsigned bars = (unsigned)__cvta_generic_to_shared(wsm) +
                        ((4u * (unsigned)(2 * kWalkStages * wk + T) + 7u) & ~7u);
  const int n = min(max(nf[b], 0), T);
  const int n_win = (n + W - 1) / W;  // window i: frames [max(0, n - (i + 1) W), n - 1 - i W]
  const int* prev_b = tok_prev + (long long)b * T * k;
  const int* word_b = tok_word + (long long)b * T * k;
  // window i into stage i % kWalkStages: two bulk copies landing on its
  // mbarrier; the stage's last reads (lane 0's walk) come before the
  // copies' writes by the proxy fence
  auto issue = [&](int i) {
    const int hi = n - 1 - i * W, lo = max(0, hi - W + 1);
    const unsigned bytes = (unsigned)(4ll * (hi - lo + 1) * k);
    const unsigned bar = bars + 8u * (i % kWalkStages);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(wsm + 2 * (i % kWalkStages) * wk);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive_expect(bar, 2 * bytes);
    bulk_copy(dst, prev_b + (long long)lo * k, bytes, bar);
    bulk_copy(dst + 4u * (unsigned)wk, word_b + (long long)lo * k, bytes, bar);
  };
  if (lane == 0 && n > 0) {
    for (int st = 0; st < kWalkStages; ++st) mbar_init(bars + 8u * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(kWalkStages, n_win); ++i) issue(i);
  }
  // the best final slot: the least (cost key, slot), so the first minimum
  u64 best = ~0ull;
  float tot_b = 0.0f;
  int word_b0 = 0;
  for (int j = lane; j < k; j += 32) {
    int word;
    const float tot = final_score<kBigram, kEnd>(final_state, final_cost, final_pred, end_slot,
                                                 end_word, end_bonus, bigram, bigram_end,
                                                 (long long)b * k + j, S, E, V, &word);
    const u64 key = ((u64)walk_cost_key(tot) << 32) | (unsigned)j;
    if (key < best) {
      best = key;
      tot_b = tot;
      word_b0 = word;
    }
  }
  const unsigned kmin = __reduce_min_sync(0xffffffffu, (unsigned)(best >> 32));
  int ix = (int)__reduce_min_sync(0xffffffffu,
                                  (unsigned)(best >> 32) == kmin ? (unsigned)best : ~0u);
  const float cost = __shfl_sync(0xffffffffu, tot_b, ix & 31);
  const int bw = __shfl_sync(0xffffffffu, word_b0, ix & 31);
  int* out = words_rev + (long long)b * (T + 1);
  if (lane == 0) {
    best_cost[b] = cost;
    out[0] = bw;
    // lane 0 walks window after window: a frame is a clamp, an address and
    // a load of tok_prev (tok_word beside it).  Once the chain dies (ix <
    // 0) its rows are -1 (a sticky flag off the chain's path, which reads
    // slot 0 on), and the walk stops at the window's end.
    unsigned parity = 0;
    int i = 0, issued = min(kWalkStages, n_win);
    bool dead = false;
    for (; i < n_win && !dead; ++i) {
      const int hi = n - 1 - i * W, lo = max(0, hi - W + 1);
      const int st = i % kWalkStages;
      mbar_wait(bars + 8u * st, (parity >> st) & 1u);
      parity ^= 1u << st;
      const int* rp = wsm + 2 * st * wk + (long long)(hi - lo) * k;
      for (int t = hi; t >= max(lo, 1); --t, rp -= k) {
        const int c = max(ix, 0);
        const int nx = rp[c], w = rp[wk + c];
        dead |= ix < 0;
        rows_s[t] = dead ? -1 : w;
        ix = nx;
      }
      if (lo == 0) {  // frame 0: its word, no step
        dead |= ix < 0;
        rows_s[0] = dead ? -1 : rp[wk + max(ix, 0)];
      }
      dead |= ix < 0;
      if (!dead && issued < n_win) issue(issued++);
    }
    for (int t = n - 1 - i * W; t >= 0; --t) rows_s[t] = -1;
    // copies still in flight land before the CTA ends
    for (; i < issued; ++i) {
      const int st = i % kWalkStages;
      mbar_wait(bars + 8u * st, (parity >> st) & 1u);
      parity ^= 1u << st;
    }
  }
  __syncwarp();
  // row c of the stream: -1 for frames at or past n_frames, else frame T - c
  for (int c = 1 + lane; c <= T; c += 32) out[c] = c <= T - n ? -1 : rows_s[T - c];
}

}  // namespace

extern "C" int token_walk_launch(const int* final_state, const float* final_cost,
                                 const int* final_pred, const int* tok_prev,
                                 const int* tok_word, const long long* end_slot,
                                 const long long* end_word, const float* end_bonus,
                                 const float* bigram, const float* bigram_end, const int* nf,
                                 float* best_cost, int* words_rev, int B, int T, int k, int S,
                                 int E, int V, int window, void* stream) {
  if (B <= 0 || T <= 0 || k <= 0 || S <= 0 || E <= 0 || (bigram && (V <= 0 || !final_pred)) ||
      (bigram_end && !bigram))
    return (int)cudaErrorInvalidValue;
  if (window < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = (B + kThreads - 1) / kThreads;
  // the window form's shared memory: a ring of windows of both planes, the
  // rows and the mbarriers; its planes 16-byte aligned, k a multiple of 4
  const long long smem = window ? walk_smem(window, k, T) : 0;
  if (window && ((k & 3) || ((uintptr_t)tok_prev | (uintptr_t)tok_word) & 15))
    return (int)cudaErrorInvalidValue;
  if (smem > SRT_MAX_SMEM) return (int)cudaErrorInvalidValue;
#define K26_LAUNCH(BG, EN)                                                                   \
  do {                                                                                       \
    if (window) {                                                                            \
      const auto kw = token_walk_window_kernel<BG, EN>;                                     \
      if (smem > 48 * 1024) SRT_SET_SMEM(kw, smem);                                          \
      kw<<<B, 32, smem, st>>>(                                                               \
          final_state, final_cost, final_pred, tok_prev, tok_word, end_slot, end_word,        \
          end_bonus, bigram, bigram_end, nf, best_cost, words_rev, T, k, S, E, V, window);    \
    } else {                                                                                 \
      token_walk_kernel<BG, EN><<<grid, kThreads, 0, st>>>(                                  \
          final_state, final_cost, final_pred, tok_prev, tok_word, end_slot, end_word,        \
          end_bonus, bigram, bigram_end, nf, best_cost, words_rev, B, T, k, S, E, V);         \
    }                                                                                        \
  } while (0)
  if (!bigram)
    K26_LAUNCH(false, false);
  else if (bigram_end)
    K26_LAUNCH(true, true);
  else
    K26_LAUNCH(true, false);
#undef K26_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int lattice_walk_launch(const int* pred, long long p_t, long long p_l,
                                   long long p_b, const int* ends_tau, long long q_t,
                                   long long q_l, long long q_b, const int* best_leaf,
                                   const int* nf, int* out, int* n_words, int T, int L, int B,
                                   int max_words, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || max_words < 0) return (int)cudaErrorInvalidValue;
  lattice_walk_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      pred, p_t, p_l, p_b, ends_tau, q_t, q_l, q_b, best_leaf, nf, out, n_words, T, L, B,
      max_words);
  return (int)cudaGetLastError();
}

// u_wide: eps_u is int32 (1) or int8 (0).
extern "C" int wordtrace_walk_launch(const void* eps_u, int u_wide, long long u_t,
                                     long long u_r, long long u_b, const int* eps_tau,
                                     long long e_t, long long e_r, long long e_b,
                                     const int* best_slot, const int* entry_t, const int* nf,
                                     int* out, int* n_words, int T, int R, int B,
                                     void* stream) {
  if (B <= 0 || T <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = (B + kThreads - 1) / kThreads;
  if (u_wide)
    wordtrace_walk_kernel<int><<<grid, kThreads, 0, st>>>(
        (const int*)eps_u, u_t, u_r, u_b, eps_tau, e_t, e_r, e_b, best_slot, entry_t, nf, out,
        n_words, T, R, B);
  else
    wordtrace_walk_kernel<int8_t><<<grid, kThreads, 0, st>>>(
        (const int8_t*)eps_u, u_t, u_r, u_b, eps_tau, e_t, e_r, e_b, best_slot, entry_t, nf,
        out, n_words, T, R, B);
  return (int)cudaGetLastError();
}
