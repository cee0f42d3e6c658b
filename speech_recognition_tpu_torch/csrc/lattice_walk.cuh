// K22's walk over one stream's chain of (entry time, predecessor leaf)
// pairs: the one walk in CUDA, run by K22's standalone kernel
// (word_walk.cu, one thread a stream on strided planes) and by K7's last
// step (lattice_rescore.cu, one lane of the stream's CTA on the planes it
// has just written).
//
// From leaf at t = clamp(nf - 1, 0, T - 1), while nf > 0, for at most
// max_words rows: the row is leaf; tau = ends_tau[t, clamp(leaf)], and
// while tau > 0 the walk moves to leaf = pred_w[clamp(tau), clamp(leaf)],
// t = tau (the predecessor of the word that entered at tau); else it
// ends.  An index is clamped to its axis as the JAX scan clamps it.
#pragma once

#include "common.cuh"

static __device__ __forceinline__ int clamp_index(int x, int n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

// Writes stream b's rows out[k * B + b] for k below the returned count of
// rows; `count` gets the rows >= 0.  The planes are read at the strides
// (t, l, b) given and with plain loads: K7 reads pred_w rows its own CTA
// stored before a block barrier, which the read-only path would not see.
static __device__ __forceinline__ int lattice_walk_chain(
    const int* pred, long long p_t, long long p_l, long long p_b, const int* tau_pl,
    long long q_t, long long q_l, long long q_b, int b, int leaf, int nf, int T, int L,
    int B, int max_words, int* out, int& count) {
  int t = clamp_index(nf - 1, T);
  int k = 0;
  count = 0;
  if (nf > 0) {
    for (; k < max_words; ++k) {
      out[(long long)k * B + b] = leaf;
      count += leaf >= 0;
      const int lc = clamp_index(leaf, L);
      const int tau = tau_pl[t * q_t + lc * q_l + b * q_b];
      if (tau <= 0) {
        ++k;
        break;
      }
      t = clamp_index(tau, T);
      leaf = pred[t * p_t + lc * p_l + b * p_b];
    }
  }
  return k;
}
