// K3: fused MFCC-39 frontend, one CTA per utterance, and K12, its
// cepstra-only mode.
//
// K3 replaces the TPU kernel speech_recognition_tpu/ops/frontend_pallas.py
// _mfcc39_kernel (reached through mfcc39_pallas_batch <- mfcc39_auto),
// with the semantics of the XLA reference ops/frontend.mfcc39 (frame
// count clamped to F, not to the 8-row padded count).
//
// K12 (template mode kCepsOnly) replaces the TPU kernel
// speech_recognition_tpu/ops/pallas_kernels.py pallas_mfcc (its inner
// `kernel`: windowed-DFT GEMMs -> power -> mel -> log -> DCT + lifter)
// and computes ops/frontend.mfcc (psf): the same chain as K3 up to the
// lifted DCT, whose rows go straight to out [B, F, n_ceps] (rows >= nf
// exact zeros).  It keeps no [F, n_ceps] block in shared memory, so it
// has no frame limit.  Where K3's [F, n_ceps] cepstra and first deltas do
// not fit in shared memory (more than ~1,967 frames, about 19.7 s at
// 16 kHz), they go to a [B, 2, F, n_ceps] device-memory scratch instead
// (template mode kScratch; the same code through global pointers), so K3
// has no frame limit either.
//
// Chain per utterance: pre-emphasis (emph[0] = s[0], samples at/after
// `length` zeroed) -> framing -> Hamming window -> (frames longer than
// 512 samples folded modulo 512) -> 512-point FFT ->
// power / n_fft -> mel filterbank -> floor at float64 eps -> log ->
// DCT-II (ortho) with the lifter folded in -> delta, delta-delta
// (one-sided end rows) -> per-utterance standardize (population
// variance floored at 1e-20) -> [F, 39]; rows >= nf are exact zeros.
//
// What bounds it on the H100: neither bytes nor FLOPs.  At 256 x 5 s it
// reads ~82 MB of signal and writes ~20 MB of features (~30 us at
// 3.35 TB/s) and needs ~1.7 GFLOP (~25 us of f32 FMA).  The bound is
// the latency of the serial frame loop inside each CTA: every step is a
// few dependent shared-memory passes separated by block barriers.
//
// What the design does about it: two real frames ride one complex FFT
// (frame a in the real part, frame b in the imaginary part, separated
// afterwards by conjugate symmetry) and four such FFTs run per step, so
// each barrier serves 8 frames; the radix-2 FFT replaces the TPU's
// staged GEMM DFT (on this card a gather is an indexed load, no MXU
// layout to serve).  Cepstra and deltas stay in shared memory where they
// fit, so the tail (deltas + standardize) never touches device memory;
// the output is written once, coalesced.  All arithmetic is f32.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kFFT = 512;
constexpr int kLog = 9;
constexpr int kBins = kFFT / 2 + 1;
constexpr int kThreads = 256;
constexpr int kPairs = 4;            // complex FFTs per step
constexpr int kFrames = 2 * kPairs;  // frames per step

__device__ __forceinline__ float emph_sample(const float* s, int i, int len,
                                             float a) {
  if (i >= len) return 0.f;
  // no FMA contraction: the reference computes s[i] - (a * s[i-1])
  return i == 0 ? s[0] : s[i] - __fmul_rn(a, s[i - 1]);
}

// delta of column c of x [F][nc] at frame f < nf, one-sided at both ends
__device__ __forceinline__ float delta_at(const float* x, int f, int c,
                                          int nf, int nc) {
  if (f == nf - 1) return x[f * nc + c] - x[max(f - 1, 0) * nc + c];
  if (f == 0) return x[nc + c] - x[c];
  return x[(f + 1) * nc + c] - x[(f - 1) * nc + c];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kCepsOnly, bool kScratch>
__global__ void __launch_bounds__(kThreads)
mfcc39_kernel(const float* __restrict__ sig, const int* __restrict__ lengths,
              const int* __restrict__ nframes,
              const float* __restrict__ window,
              const float* __restrict__ mel_w, const int* __restrict__ mel_lo,
              const int* __restrict__ mel_hi,
              const float* __restrict__ dct_lift, float* __restrict__ out,
              float* __restrict__ scratch, int L, int F, int fl, int fs,
              float preemph, int n_mels, int n_ceps, int standardize) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* z = reinterpret_cast<float2*>(smem_raw);     // [kPairs][kFFT]
  float2* tw = z + kPairs * kFFT;                       // [kFFT / 2]
  float* pw = reinterpret_cast<float*>(tw + kFFT / 2);  // [kFrames][kBins]
  float* lm = pw + kFrames * kBins;                     // [kFrames][n_mels]
  float* mean = lm + kFrames * n_mels;                  // [3 * n_ceps]
  float* scale = mean + 3 * n_ceps;                     // [3 * n_ceps]
  // K3: [F][n_ceps] cepstra and first deltas in shared memory, or in the
  // utterance's scratch rows; K12: the cepstra are the output rows
  float* ceps = kCepsOnly ? out + (size_t)blockIdx.x * F * n_ceps
                : kScratch ? scratch + (size_t)blockIdx.x * 2 * F * n_ceps
                           : scale + 3 * n_ceps;
  float* d1 = ceps + F * n_ceps;                        // [F][n_ceps] (K3)

  const int b = blockIdx.x, tid = threadIdx.x;
  const float* s = sig + (size_t)b * L;
  const int len = min(lengths[b], L);
  const int nf = nframes[b];
  const int D = 3 * n_ceps;

  for (int k = tid; k < kFFT / 2; k += kThreads) {
    double sn, cs;
    sincospi(2.0 * k / kFFT, &sn, &cs);
    tw[k] = make_float2((float)cs, (float)-sn);  // exp(-2 pi i k / N)
  }

  for (int f0 = 0; f0 < nf; f0 += kFrames) {
    // windowed frames, two per complex FFT, stored bit-reversed
    for (int i = tid; i < kPairs * kFFT; i += kThreads) {
      const int p = i / kFFT, n = i % kFFT;
      const int fa = f0 + 2 * p, fb = fa + 1;
      float va = 0.f, vb = 0.f;
      // a frame longer than the FFT folds onto it (sample k adds into
      // bin-time k mod kFFT), which is what the DFT bases of the plain
      // version compute; at 44.1 and 48 kHz frames are 1102 and 1200
      for (int k = n; k < fl; k += kFFT) {
        const float wk = window[k];
        if (fa < nf) va += emph_sample(s, fa * fs + k, len, preemph) * wk;
        if (fb < nf) vb += emph_sample(s, fb * fs + k, len, preemph) * wk;
      }
      z[p * kFFT + (__brev(n) >> (32 - kLog))] = make_float2(va, vb);
    }
    __syncthreads();
    // iterative radix-2 decimation-in-time FFT
    for (int st = 0; st < kLog; ++st) {
      const int half = 1 << st;
      for (int j = tid; j < kPairs * kFFT / 2; j += kThreads) {
        const int p = j / (kFFT / 2), q = j % (kFFT / 2);
        const int pos = q & (half - 1);
        const int i0 = p * kFFT + ((q >> st) << (st + 1)) + pos;
        const int i1 = i0 + half;
        const float2 w = tw[pos << (kLog - 1 - st)];
        const float2 a = z[i0], c = z[i1];
        const float2 t = make_float2(w.x * c.x - w.y * c.y,
                                     w.x * c.y + w.y * c.x);
        z[i0] = make_float2(a.x + t.x, a.y + t.y);
        z[i1] = make_float2(a.x - t.x, a.y - t.y);
      }
      __syncthreads();
    }
    // split Z = A + iB: A[k] = (Z[k] + conj Z[N-k]) / 2,
    // B[k] = (Z[k] - conj Z[N-k]) / 2i; power spectra / n_fft
    for (int i = tid; i < kPairs * kBins; i += kThreads) {
      const int p = i / kBins, k = i % kBins;
      const float2 zk = z[p * kFFT + k];
      const float2 zc = z[p * kFFT + ((kFFT - k) & (kFFT - 1))];
      const float ar = 0.5f * (zk.x + zc.x), ai = 0.5f * (zk.y - zc.y);
      const float br = 0.5f * (zk.y + zc.y), bi = -0.5f * (zk.x - zc.x);
      pw[(2 * p) * kBins + k] = (ar * ar + ai * ai) * (1.0f / kFFT);
      pw[(2 * p + 1) * kBins + k] = (br * br + bi * bi) * (1.0f / kFFT);
    }
    __syncthreads();
    // mel energies over each filter's nonzero bins, floored, log
    for (int i = tid; i < kFrames * n_mels; i += kThreads) {
      const int fr = i / n_mels, m = i % n_mels;
      float acc = 0.f;
      for (int k = mel_lo[m]; k < mel_hi[m]; ++k)
        acc += mel_w[m * kBins + k] * pw[fr * kBins + k];
      if (acc <= 0.f) acc = 2.220446049250313e-16f;  // float64 eps
      lm[i] = logf(acc);
    }
    __syncthreads();
    // DCT-II with the lifter folded in
    for (int i = tid; i < kFrames * n_ceps; i += kThreads) {
      const int fr = i / n_ceps, c = i % n_ceps, f = f0 + fr;
      if (f < nf) {
        float acc = 0.f;
        for (int m = 0; m < n_mels; ++m)
          acc += lm[fr * n_mels + m] * dct_lift[m * n_ceps + c];
        ceps[f * n_ceps + c] = acc;
      }
    }
    __syncthreads();
  }
  if (kCepsOnly) {
    for (int i = nf * n_ceps + tid; i < F * n_ceps; i += kThreads) ceps[i] = 0.f;
    return;
  }

  for (int i = tid; i < nf * n_ceps; i += kThreads)
    d1[i] = delta_at(ceps, i / n_ceps, i % n_ceps, nf, n_ceps);
  __syncthreads();

  auto feat_at = [&](int col, int f) -> float {
    const int g = col / n_ceps, c = col % n_ceps;
    if (g == 0) return ceps[f * n_ceps + c];
    if (g == 1) return d1[f * n_ceps + c];
    return delta_at(d1, f, c, nf, n_ceps);
  };

  if (standardize) {
    const int warp = tid / 32, lane = tid % 32;
    const float denom = (float)max(nf, 1);
    for (int col = warp; col < D; col += kThreads / 32) {
      float sum = 0.f;
      for (int f = lane; f < nf; f += 32) sum += feat_at(col, f);
      const float mu = warp_sum(sum) / denom;
      float sq = 0.f;
      for (int f = lane; f < nf; f += 32) {
        const float d = feat_at(col, f) - mu;
        sq += d * d;
      }
      const float var = warp_sum(sq) / denom;
      if (lane == 0) {
        mean[col] = mu;
        scale[col] = sqrtf(fmaxf(var, 1e-20f));
      }
    }
    __syncthreads();
  }

  float* o = out + (size_t)b * F * D;
  for (int i = tid; i < F * D; i += kThreads) {
    const int f = i / D, col = i % D;
    float v = 0.f;
    if (f < nf) {
      v = feat_at(col, f);
      if (standardize) v = (v - mean[col]) / scale[col];
    }
    o[i] = v;
  }
}

}  // namespace

// Shared memory of one CTA; F = 0 gives the form without the [F][n_ceps]
// blocks (K12, and K3 with its scratch).
extern "C" int mfcc39_smem_bytes(int F, int n_mels, int n_ceps) {
  const long long n = (kPairs * kFFT + kFFT / 2) * (long long)sizeof(float2) +
                      (kFrames * kBins + kFrames * n_mels + 2LL * F * n_ceps +
                       6 * n_ceps) * (long long)sizeof(float);
  return n > 0x7fffffffLL ? 0x7fffffff : (int)n;
}

// signals [B, L] f32, lengths/nf [B] i32, window [fl], mel_w [n_mels, 257],
// mel_lo/mel_hi [n_mels] i32, dct_lift [n_mels, n_ceps] -> out [B, F, 3*n_ceps];
// scratch: null (cepstra and deltas in shared memory) or [B, 2, F, n_ceps]
extern "C" int mfcc39_launch(const float* sig, const int* lengths,
                             const int* nf, const float* window,
                             const float* mel_w, const int* mel_lo,
                             const int* mel_hi, const float* dct_lift,
                             float* out, float* scratch, int B, int L, int F, int fl,
                             int fs, float preemph, int n_mels, int n_ceps,
                             int standardize, void* stream) {
  if (B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (scratch) {
    const int smem = mfcc39_smem_bytes(0, n_mels, n_ceps);
    SRT_SET_SMEM((mfcc39_kernel<false, true>), smem);
    mfcc39_kernel<false, true><<<B, kThreads, smem, st>>>(
        sig, lengths, nf, window, mel_w, mel_lo, mel_hi, dct_lift, out, scratch, L,
        F, fl, fs, preemph, n_mels, n_ceps, standardize);
  } else {
    const int smem = mfcc39_smem_bytes(F, n_mels, n_ceps);
    SRT_SET_SMEM((mfcc39_kernel<false, false>), smem);
    mfcc39_kernel<false, false><<<B, kThreads, smem, st>>>(
        sig, lengths, nf, window, mel_w, mel_lo, mel_hi, dct_lift, out, nullptr, L,
        F, fl, fs, preemph, n_mels, n_ceps, standardize);
  }
  return (int)cudaGetLastError();
}

// K12: as mfcc39_launch, cepstra only -> out [B, F, n_ceps]; its shared
// memory does not grow with F
extern "C" int mfcc_ceps_launch(const float* sig, const int* lengths,
                                const int* nf, const float* window,
                                const float* mel_w, const int* mel_lo,
                                const int* mel_hi, const float* dct_lift,
                                float* out, int B, int L, int F, int fl,
                                int fs, float preemph, int n_mels, int n_ceps,
                                void* stream) {
  if (B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const int smem = mfcc39_smem_bytes(0, n_mels, n_ceps);
  SRT_SET_SMEM((mfcc39_kernel<true, false>), smem);
  mfcc39_kernel<true, false><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      sig, lengths, nf, window, mel_w, mel_lo, mel_hi, dct_lift, out, nullptr, L, F,
      fl, fs, preemph, n_mels, n_ceps, 0);
  return (int)cudaGetLastError();
}
