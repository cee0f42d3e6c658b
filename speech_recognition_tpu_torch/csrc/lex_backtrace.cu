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
// plane (K4 leaves those entries unwritten).
//
// What bounds it on the H100: latency.  Each frame is one dependent 1-byte
// load from the [T, B, S] plane (614 MB at 128 x 500 x 9.6k states, not
// L2-resident) and, on a cross or eps code, one more small load; T loads in
// a chain per stream.
//
// What the design does about it: one thread per stream and nothing else.
// The Pallas kernels' iota-compare one-hot reductions over a whole [S, B]
// plane per frame (and the code + 8 * src combo plane) are not needed: on
// this card each lookup is an indexed load.  cross_src[st] and
// start_pos[st] are loaded beside the code, so a band or cross step costs
// one round trip.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBand = 2;
constexpr int kCrossCode = kMaxBand + 1;
constexpr int kEpsCode = kMaxBand + 2;

__global__ void __launch_bounds__(kThreads)
lex_backtrace_kernel(const int8_t* __restrict__ bp8,
                     const int* __restrict__ eps_prev,
                     const int* __restrict__ cross_src,
                     const int* __restrict__ start_pos,
                     const int* __restrict__ end_state,
                     const int* __restrict__ nf, int* __restrict__ states,
                     uint8_t* __restrict__ flags, int T, int B, int S, int R) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = nf[b];
  int st = end_state[b];
  for (int t = T - 1; t >= 0; --t) {
    const int rec = st;
    uint8_t m = 0;
    if (t < n) {
      const int code = bp8[((size_t)t * B + b) * S + st];
      const int src = __ldg(cross_src + st);
      const int slot = __ldg(start_pos + st);
      m = code == kEpsCode;
      if (t > 0) {
        if (m)
          st = eps_prev[((size_t)t * B + b) * R + slot];
        else
          st = code == kCrossCode ? src : st - min(code, kMaxBand);
      }
    }
    states[(size_t)t * B + b] = rec;
    flags[(size_t)t * B + b] = m;
  }
}

}  // namespace

// bp8 [T,B,S] i8, eps_prev [T,B,R] i32, cross_src/start_pos [S] i32,
// end_state/nf [B] i32 -> states [T,B] i32, flags [T,B] u8 (0/1)
extern "C" int lex_backtrace_launch(const int8_t* bp8, const int* eps_prev,
                                    const int* cross_src, const int* start_pos,
                                    const int* end_state, const int* nf,
                                    int* states, uint8_t* flags, int T, int B,
                                    int S, int R, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  lex_backtrace_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      bp8, eps_prev, cross_src, start_pos, end_state, nf, states, flags, T, B,
      S, R);
  return (int)cudaGetLastError();
}
