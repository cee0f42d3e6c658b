// K5: value backtrace over the lexical-tree backpointer planes of K4.
//
// Replaces the TPU kernels speech_recognition_tpu/ops/viterbi_lex_pallas.py
// _lex_bt_kernel (lex_backtrace_soa_pallas without eps_prev: band step,
// cross via the parent map, eps via the leaf side plane), _lex_bt_val_kernel
// (the same with one lookup per frame through eps_prev) and
// _lex_bt_wide_kernel (the lane-major layout).  All three give the same
// states and flags; here they are one walk in the graph's own numbering.
//
// Per stream b the walk seeds at t = T-1 with end_state[b] and runs to
// t = 0; the recorded state of frame t is the state before the step.  For
// t < nf: code = bp8[t, b, st]; an eps code (4) takes the predecessor from
// eps_prev[t, b, start_pos[st]] (K4 stored the winning leaf end minus its
// band code there), a cross code (3) takes cross_src[st], a band code d
// takes st - d; the step is taken only for 0 < t < nf, and the eps flag is
// code == 4 for t < nf.  Frames t >= nf pass the state through and read no
// plane (K4 leaves those entries unwritten).  The rules are those of the
// plain version ops/viterbi_lex_kernels.lex_backtrace_val_ref.
//
// What bounds it on the H100: latency.  A walk is T dependent steps per
// stream, each a 1-byte read of the [T, B, S] plane (614 MB at 128 x 500 x
// 9.6k states, far past the 50 MB L2) at a state known only after the
// step before: read where it lies, every frame is a device-memory round
// trip (~650 ns), while the bytes on the path would take ~0.1 us.  The
// floor that means something for a serial walk is T steps out of shared
// memory, ~8 us at 500 frames.
//
// What the design does about it: one warp per stream (kWarps streams a
// CTA), and a round trip fetches a window of frames x the states the walk
// can reach backwards from st without an eps step: the band predecessors
// inside st's arc, then through the cross edge at the arc start the parent
// arc's states, and so on up to the root.  That chain is static; the
// wrapper packs it once per graph (ops/viterbi_lex_kernels.lex_chains): per
// state a row of kChain chain states, first state first, and (P, slot),
// its length and start_pos of its first state.  Lane q holds chain
// position q, so a new chain costs two round trips (its row from L2, then
// its codes), and each lane computes its codes' addresses from the row.  A
// window holds F = kWin / (P + 1) frames x P positions, with the eps_prev
// entries of the chain's first state (its root start) for the F frames.
// The lanes stash each (frame, position)'s step as the index of the next
// frame's entry where it stays in the chain (a per-position mask, from the
// row, says which band and cross steps do), else as the state it leaves
// for (an eps code lands on another branch's leaf end, read from the
// stashed column); lane 0 walks the indices, one shared-memory load a
// frame, and the lanes write the states out.  While it walks, the lanes
// load the next window of the same chain (frames below), which the walk
// takes when it ends inside the chain.
//
// What the card taught (scripts/exp_r11_lex_backtrace.py, the trace):
//   * every load is unconditional and the stash has no branch: a load under
//     a condition merges with the register's old value through a copy that
//     waits for it, and per-entry branches (with the shared-memory stores
//     between the reads) ran the entries one at a time, ~200 cycles each;
//     the stash reads all it needs first, then stores;
//   * the window width: 256 entries (about half a word of frames); 512 and
//     1,024 cost more a window than the fewer windows saved, 128 more
//     windows; the CPU emulation (tests/k5_walk.py,
//     scripts/exp_r11_k5_windows.py) counts one window of a new chain per
//     word, and loading the landing word's window during the walk (K9's
//     speculation) would rarely have been the right one;
//   * warps per CTA (1, 2 or 4) do not matter: the walks do not contend.
// No size limit: any B, S, R, arc length and trie depth (a chain longer
// than kChain keeps its top kChain states, and the walk takes a new window
// where it leaves them).

#include "common.cuh"

namespace {

constexpr int kMaxBand = 2;
constexpr int kCrossCode = kMaxBand + 1;
constexpr int kEpsCode = kMaxBand + 2;
constexpr int kChain = 32;               // positions of a chain row: one per lane
constexpr int kTrace = 9;                // entries per stream of the optional trace
constexpr unsigned kFull = 0xffffffffu;

constexpr int kWarps = 4;                // streams (warps) per CTA
constexpr int kWin = 256;                // (frame, position) entries of a window
constexpr int kPerLane = kWin / 32;      // codes per lane
constexpr int kFrames = kWin / 2;        // frames of a window, at most (P >= 1)
constexpr int kColPerLane = kFrames / 32;  // eps_prev entries per lane

// One warp per stream.  Shared memory per warp: the window's steps and eps
// marks [frame][position], its eps_prev column, the walk's entry indices,
// the chain's states and their step masks.
__global__ void __launch_bounds__(kWarps * 32)
lex_backtrace_window_kernel(const int8_t* __restrict__ bp8,
                            const int* __restrict__ eps_prev,
                            const int* __restrict__ cross_src,
                            const int* __restrict__ start_pos,
                            const int* __restrict__ chains,
                            const int2* __restrict__ heads,
                            const int* __restrict__ end_state,
                            const int* __restrict__ nf, int* __restrict__ states,
                            uint8_t* __restrict__ flags, int T, int B, int S, int R,
                            long long* __restrict__ trace) {
  __shared__ int step_s[kWarps][kWin];  // next entry's index, or ~target state
  __shared__ uint8_t mark_s[kWarps][kWin];
  __shared__ int col_s[kWarps][kFrames];
  __shared__ int recs_s[kWarps][kFrames];
  __shared__ int cst_s[kWarps][kChain];
  __shared__ int2 inf_s[kWarps][kChain];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp leaves; no block barrier follows
  int* step = step_s[warp];
  uint8_t* mark = mark_s[warp];
  int* col = col_s[warp];
  int* recs = recs_s[warp];
  int* cst = cst_s[warp];
  int2* inf = inf_s[warp];

  const int n = min(max(nf[b], 0), T);
  int st = end_state[b];
  for (int t = n + lane; t < T; t += 32) {  // frames passed through
    states[(size_t)t * B + b] = st;
    flags[(size_t)t * B + b] = 0;
  }
  const size_t code_stride = (size_t)B * S, eps_stride = (size_t)B * R;
  const int8_t* plane = bp8 + (size_t)b * S;  // stream b's codes at frame 0
  const int* ep = eps_prev + (size_t)b * R;
  // the chain: P positions, the eps_prev slot of its first state, and the
  // reciprocal that divides an entry index i < kWin by P exactly
  int P = 1, slot = 0, inv = 65536;
  int8_t rc[kPerLane];
  int re[kColPerLane];
  // lane q, chain position q: its state, that state's cross source, and
  // which steps stay in the chain (bit d: the band step d lands on position
  // q - d; bit 3: the cross edge lands on position q - 1)
  int cxv = 0, up1 = 0, ok = 1;
  auto frames_of = [&](int t0) { return min(t0 + 1, kWin / (P + 1)); };
  // the window of F frames from t0 down into rc / re.  Every load is
  // unconditional (entries past the window read its last one again): a
  // load under a condition must merge with the register's old value, and
  // that copy waits for the load
  auto load = [&](int t0) {
    const int F = frames_of(t0), last = F * P - 1;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = min(lane + 32 * j, last), f = (i * inv) >> 16;
      rc[j] = plane[(size_t)(t0 - f) * code_stride + cst[i - f * P]];
    }
#pragma unroll
    for (int j = 0; j < kColPerLane; ++j)
      re[j] = ep[(size_t)(t0 - min(lane + 32 * j, F - 1)) * eps_stride + slot];
  };
  // lane 0's cycles: a new chain's row, waiting for a window's codes, the
  // stash, the next window's issue, the walk, the write-out; windows waited
  // for (a new chain), loaded during the walk
  long long cyc[6] = {0, 0, 0, 0, 0, 0}, tick = trace ? clock64() : 0;
  int n_wait = 0, n_ahead = 0;
  auto lap = [&](int ph) {
    if (trace) {
      const long long now = clock64();
      cyc[ph] += now - tick;
      tick = now;
    }
  };
  bool ahead = false;  // rc / re hold the window at t of the same chain
  int p = 0;           // the walk's position in the chain
  for (int t = n - 1; t >= 0;) {
    n_wait += !ahead;
    n_ahead += ahead;
    if (!ahead) {  // a new chain: its row (one round trip), then its window
      const int2 h = __ldg(heads + st);
      const int cv = __ldg(chains + (size_t)st * kChain + lane);
      P = h.x;
      slot = h.y;
      inv = (65536 + P - 1) / P;
      p = P - 1;
      cst[lane] = cv;
      up1 = __shfl_up_sync(kFull, cv, 1);
      const int up2 = __shfl_up_sync(kFull, cv, 2);
      ok = 1 | (lane >= 1 && up1 == cv - 1) << 1 | (lane >= 2 && up2 == cv - 2) << 2;
      __syncwarp();
      cxv = __ldg(cross_src + cv);  // arrives with the codes
      lap(0);
      load(t);
    }
    if (trace) {  // wait for the window here, to time it apart from the stash
      int any = 0;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) any |= rc[j];
#pragma unroll
      for (int j = 0; j < kColPerLane; ++j) any |= re[j];
      asm volatile("" ::"r"(any));
    }
    lap(1);
    const int F = frames_of(t), lim = F * P;
#pragma unroll
    for (int j = 0; j < kColPerLane; ++j)
      if (lane + 32 * j < F) col[lane + 32 * j] = re[j];
    inf[lane] = make_int2(cxv, ok | (lane >= 1 && up1 == cxv) << 3);
    __syncwarp();
    // the stash, without a branch: every entry is computed (past the
    // window, from its last one) and stored under a predicate; an eps code
    // off position 0 (none in a trie, where word starts begin their chains)
    // reads its eps_prev entry in a second pass.  All reads come first, so
    // that no store stands between them
    int sq[kPerLane], lq[kPerLane];
    int2 wq[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int ic = min(lane + 32 * j, lim - 1), f = (ic * inv) >> 16, q = ic - f * P;
      sq[j] = cst[q];
      lq[j] = col[f];
      wq[j] = inf[q];
    }
    bool off0 = false;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j, ic = min(i, lim - 1), f = (ic * inv) >> 16, q = ic - f * P;
      const int code = rc[j], s = sq[j], land = lq[j], band = min(code, kMaxBand);
      const int2 w = wq[j];
      const bool cross = code == kCrossCode, eps = code == kEpsCode;
      const int bit = cross ? 3 : band, d = cross ? 1 : band;
      int e = bit >= 0 && (w.y >> bit & 1) ? i + P - d : ~(cross ? w.x : s - band);
      if (eps) e = ~land;  // another branch's leaf end: leave the chain
      off0 |= eps && q != 0 && i < lim;
      if (i < lim) {
        step[i] = e;
        mark[i] = eps;
      }
    }
    if (__any_sync(kFull, off0)) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int i = lane + 32 * j, f = (i * inv) >> 16, q = i - f * P;
        if (i < lim && rc[j] == kEpsCode && q != 0)
          step[i] = ~ep[(size_t)(t - f) * eps_stride + __ldg(start_pos + cst[q])];
      }
    }
    __syncwarp();
    lap(2);
    const int t2 = t - F;  // the next window of this chain, loaded during the walk
    if (t2 >= 0) load(t2);
    lap(3);
    int f = 0, e = 0;
    if (lane == 0) {  // the walk: entry indices, one shared-memory load a frame
      int i = p;
      while (true) {  // (unsigned: a negative step, leaving the chain, also ends it)
        recs[f++] = i;
        e = step[i];
        if ((unsigned)e >= (unsigned)lim) break;
        i = e;
      }
    }
    __syncwarp();
    f = __shfl_sync(kFull, f, 0);
    e = __shfl_sync(kFull, e, 0);
    lap(4);
    for (int k = lane; k < f; k += 32) {
      const int i = recs[k];
      states[(size_t)(t - k) * B + b] = cst[i - k * P];
      flags[(size_t)(t - k) * B + b] = mark[i];
    }
    __syncwarp();  // the next window is stashed over this one
    lap(5);
    t -= f;
    ahead = e >= 0 && t >= 0;  // the walk used the window up inside the chain
    if (e >= 0)
      p = e - lim;
    else
      st = ~e;
  }
  if (trace && lane == 0) {
    long long* tr = trace + kTrace * (size_t)b;
    for (int k = 0; k < 6; ++k) tr[k] = cyc[k];
    tr[6] = n_wait;
    tr[7] = n_ahead;
    tr[8] = n;
  }
}

}  // namespace

// bp8 [T,B,S] i8, eps_prev [T,B,R] i32, cross_src/start_pos [S] i32,
// chains [S, 32] i32 and heads [S] int2 (lex_chains), end_state/nf [B] i32
// -> states [T,B] i32, flags [T,B] u8 (0/1).  trace (null: off): [B][9]
// per stream, lane 0's cycles fetching new chains' rows, waiting for
// windows, stashing, issuing the next window, walking and writing out; the
// windows waited for and loaded during the walk; the frames.
extern "C" int lex_backtrace_launch(const int8_t* bp8, const int* eps_prev,
                                    const int* cross_src, const int* start_pos,
                                    const int* chains, const int* heads,
                                    const int* end_state, const int* nf,
                                    int* states, uint8_t* flags, int T, int B,
                                    int S, int R, long long* trace, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  lex_backtrace_window_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
                                (cudaStream_t)stream>>>(
      bp8, eps_prev, cross_src, start_pos, chains, reinterpret_cast<const int2*>(heads),
      end_state, nf, states, flags, T, B, S, R, trace);
  return (int)cudaGetLastError();
}
