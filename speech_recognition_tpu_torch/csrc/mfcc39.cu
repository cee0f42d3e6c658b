// K12: frame-parallel MFCC cepstra; K3 (MFCC-39) = this kernel writing
// [B, F, n_ceps] followed by K14, the per-utterance tail.
//
// K12 replaces the TPU kernel speech_recognition_tpu/ops/pallas_kernels.py
// pallas_mfcc (its inner `kernel`: windowed-DFT GEMMs -> power -> mel ->
// log -> DCT + lifter) and computes ops/frontend.mfcc (psf).  K3 replaces
// speech_recognition_tpu/ops/frontend_pallas.py _mfcc39_kernel (reached
// through mfcc39_pallas_batch <- mfcc39_auto), with the semantics of the
// XLA reference ops/frontend.mfcc39 (frame count clamped to F, not to the
// 8-row padded count): the cepstra kernel, then K14 (mfcc_tail_kernel) for
// the deltas and the standardization.
//
// Chain per frame: pre-emphasis (emph[0] = s[0], samples at/after `length`
// zeroed) -> framing -> Hamming window -> (frames longer than 512 samples
// folded modulo 512) -> 512-point FFT -> power / n_fft -> mel filterbank ->
// floor at float64 eps -> log -> DCT-II (ortho) with the lifter folded in;
// rows >= nf are exact zeros.  K14 per utterance: delta, delta-delta
// (one-sided end rows) -> standardize (population variance floored at
// 1e-20; norm "utterance") or raw (norm "none") -> [F, 39].
//
// What bounds it on the H100: at 256 x 5 s the chain reads ~82 MB of signal
// and writes ~20 MB of features (~30 us at 3.35 TB/s) and needs ~1.7 GFLOP
// (~25 us of f32 FMA): operations, by a hair.
//
// What the design does about it: the grid runs over the frames of the whole
// batch (no serial frame loop per utterance, no block barrier after the
// twiddle table).  One warp takes two frames of an utterance as one complex
// 512-point FFT (frame a in the real part, frame b in the imaginary part,
// separated afterwards by conjugate symmetry).  Its samples are loaded
// without branches, so all of a lane's loads are in flight at once (frames
// at the signal's edges from clamped addresses, values selected after).
// The FFT is 512 = 32 x 16: each lane holds samples lane + 32 j in
// registers and takes a 16-point DFT over j (every index a
// compile-time constant, so the array stays in registers), the 512-point
// twiddles, one padded transpose through the warp's 4.25 KB of shared
// memory, a 16-point DFT per (k2, m1) lane, the 32-point twiddles and one
// radix-2 step across lane halves by shuffles; only __syncwarp orders the
// warp's buffer.  The same warp then takes the power split in place, the
// mel sums over each filter's nonzero bins, the log and the lifted DCT,
// and writes its two cepstra rows (contiguous).  Eight warps per CTA share
// one twiddle table; four CTAs fill an SM (32 warps).  K14 is one CTA of
// 512 threads per utterance that stages the cepstra 128 frames at a time
// (with two rows of halo) in shared memory, so its shared memory does not
// grow with F: a pass for the mean, one for the variance, one that writes
// [F, 39] (each thread one column, each step a contiguous run of rows).
// All arithmetic is f32.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kFFT = 512;
constexpr int kBins = kFFT / 2 + 1;
constexpr int kWarps = 8;               // warps per CTA, one frame pair each
constexpr int kThreads = kWarps * 32;
constexpr int kCtasPerSm = 4;
constexpr int kPadRow = 17;             // float2 per row of the padded transpose
constexpr int kBuf = 32 * kPadRow;      // float2 per warp buffer (>= kFFT)
constexpr int kTailThreads = 512;

// Pre-emphasized sample i: s[i] - a s[i-1] (s[0] at i = 0, where the
// subtraction of a * 0 leaves it unchanged), 0 at and after `len`.
__device__ __forceinline__ float emph_sample(const float* s, int i, int len,
                                             float a) {
  if (i >= len) return 0.f;
  const float prev = i > 0 ? s[i - 1] : 0.f;
  // no FMA contraction: the reference computes s[i] - (a * s[i-1])
  return s[i] - __fmul_rn(a, prev);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(w.x * a.x - w.y * a.y, w.x * a.y + w.y * a.x);
}

// One radix-2 stage of butterflies of span 2 kHalf over v (every index a
// compile-time constant, so v stays in registers).
template <int kHalf>
__device__ __forceinline__ void fft16_stage(float2 (&v)[16], const float2* tw) {
#pragma unroll
  for (int k = 0; k < 16; k += 2 * kHalf) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float2 c = v[k + j + kHalf];
      const float2 t = j == 0 ? c : cmul(c, tw[j * (256 / kHalf)]);
      const float2 a = v[k + j];
      v[k + j] = make_float2(a.x + t.x, a.y + t.y);
      v[k + j + kHalf] = make_float2(a.x - t.x, a.y - t.y);
    }
  }
}

// In-register 16-point DFT of v, natural order in and out (radix-2
// decimation in time); tw is the CTA's table of exp(-2 pi i k / 512), so
// W_16^m = tw[32 m].  Multiplications by W^0 are skipped.
__device__ __forceinline__ void fft16(float2 (&v)[16], const float2* tw) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = ((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3);
    if (i < j) {
      const float2 t = v[i];
      v[i] = v[j];
      v[j] = t;
    }
  }
  fft16_stage<1>(v, tw);
  fft16_stage<2>(v, tw);
  fft16_stage<4>(v, tw);
  fft16_stage<8>(v, tw);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mfcc_ceps_kernel(const float* __restrict__ sig, const int* __restrict__ lengths,
                 int* __restrict__ nframes, const float* __restrict__ window,
                 const float* __restrict__ mel_w, const int* __restrict__ mel_lo,
                 const int* __restrict__ mel_hi, const float* __restrict__ dct_lift,
                 float* __restrict__ out, int B, int L, int F, int fl, int fs,
                 float preemph, int n_mels, int n_ceps) {
  __shared__ float2 tw[kFFT];
  __shared__ float2 wbuf[kWarps][kBuf];
  for (int k = threadIdx.x; k < kFFT; k += kThreads) {
    double sn, cs;
    sincospi(2.0 * k / kFFT, &sn, &cs);
    tw[k] = make_float2((float)cs, (float)-sn);  // exp(-2 pi i k / N)
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2* buf = wbuf[warp];
  float* lm = reinterpret_cast<float*>(buf + kBins);  // [2][n_mels] after the power
  const int pairs = (F + 1) / 2;                       // frame pairs per utterance
  const long long n_tasks = (long long)B * pairs;
  const int k2 = lane & 15, m1 = lane >> 4;            // the second stage's lane roles

  for (long long task = (long long)blockIdx.x * kWarps + warp; task < n_tasks;
       task += (long long)gridDim.x * kWarps) {
    const int b = (int)(task / pairs), fa = 2 * (int)(task % pairs), fb = fa + 1;
    // psf frame count: 1 up to one frame, else 1 + ceil((len - fl) / fs),
    // clamped to the capacity F (ops/frontend._frames_and_nf)
    const int length = lengths[b];
    const int nf = min(F, length <= fl ? 1 : 1 + (length - fl + fs - 1) / fs);
    if (fa == 0 && lane == 0) nframes[b] = nf;
    float* o = out + ((size_t)b * F + fa) * n_ceps;
    const int n_out = (fb < F ? 2 : 1) * n_ceps;  // both rows are contiguous
    if (fa >= nf) {
      for (int i = lane; i < n_out; i += 32) o[i] = 0.f;
      continue;
    }
    const float* s = sig + (size_t)b * L;
    const int len = min(length, L);
    const bool has_b = fb < nf;

    // windowed samples n = lane + 32 j of both frames; a frame longer than
    // the FFT folds onto it (sample k adds into bin-time k mod 512), as the
    // DFT bases of the plain version compute it (1102 and 1200 samples at
    // 44.1 and 48 kHz)
    float2 v[16];
    if (fl <= kFFT && fa > 0 && (has_b ? fb : fa) * fs + fl <= len) {
      // both frames inside (0, len), one sample per FFT slot: no clamping
      // (K12 at 256 x 5 s on an H100: 0.25 against 0.33 ms); slots past
      // the frame load its last sample and are zeroed by the window test
      const float* sa = s + fa * fs;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = lane + 32 * j, kk = min(k, fl - 1);
        const float wk = k < fl ? __ldg(window + kk) : 0.f;
        // no FMA contraction: the reference computes s[i] - (a * s[i-1])
        const float va = (sa[kk] - __fmul_rn(preemph, sa[kk - 1])) * wk;
        const float vb =
            has_b ? (sa[kk + fs] - __fmul_rn(preemph, sa[kk + fs - 1])) * wk : 0.f;
        v[j] = make_float2(va, vb);
      }
    } else if (fl <= kFFT && len > 0) {
      // one sample per FFT slot; every load is from a clamped, in-bounds
      // address and its value is selected afterwards, so the loads of all
      // slots can be in flight together
      const int last = len - 1;
      auto emph = [&](int i) {
        const float xi = s[min(i, last)];
        const float prev = i > 0 ? s[min(i, last + 1) - 1] : 0.f;
        // no FMA contraction: the reference computes s[i] - (a * s[i-1])
        return i < len ? xi - __fmul_rn(preemph, prev) : 0.f;
      };
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = lane + 32 * j;
        const float wk = k < fl ? __ldg(window + min(k, fl - 1)) : 0.f;
        const float va = emph(fa * fs + k) * wk;
        const float vb = has_b ? emph(fb * fs + k) * wk : 0.f;
        v[j] = make_float2(va, vb);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float va = 0.f, vb = 0.f;
        for (int k = lane + 32 * j; k < fl; k += kFFT) {
          const float wk = __ldg(window + k);
          va += emph_sample(s, fa * fs + k, len, preemph) * wk;
          if (has_b) vb += emph_sample(s, fb * fs + k, len, preemph) * wk;
        }
        v[j] = make_float2(va, vb);
      }
    }

    // stage 1: Y[n1 = lane][k2] = sum_n2 x[n1 + 32 n2] W_16^(n2 k2), times
    // W_512^(n1 k2), transposed through the warp's padded buffer
    fft16(v, tw);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      buf[lane * kPadRow + j] = j == 0 ? v[0] : cmul(v[j], tw[lane * j]);
    __syncwarp();
    // stage 2: lane (k2, m1) takes n1 = m1 + 2 m2: a 16-point DFT over m2,
    // the W_32^(m1 q2) twiddles, and the radix-2 step over m1 with the
    // partner lane (lane ^ 16); X[k2 + 16 q2 + 256 m1] lands in register q2
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = buf[(m1 + 2 * j) * kPadRow + k2];
    fft16(v, tw);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 z = (m1 && j) ? cmul(v[j], tw[16 * j]) : v[j];
      const float2 w = make_float2(__shfl_xor_sync(0xffffffffu, z.x, 16),
                                   __shfl_xor_sync(0xffffffffu, z.y, 16));
      v[j] = m1 ? make_float2(w.x - z.x, w.y - z.y) : make_float2(z.x + w.x, z.y + w.y);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 16; ++j) buf[k2 + 16 * j + 256 * m1] = v[j];
    __syncwarp();

    // split Z = A + iB: A[k] = (Z[k] + conj Z[N-k]) / 2, B[k] = (Z[k] -
    // conj Z[N-k]) / 2i; power spectra / n_fft, in place at bins 0..256
    // (slot k <= 256 is read only by its own lane)
    for (int k = lane; k < kBins; k += 32) {
      const float2 zk = buf[k];
      const float2 zc = buf[(kFFT - k) & (kFFT - 1)];
      const float ar = 0.5f * (zk.x + zc.x), ai = 0.5f * (zk.y - zc.y);
      const float br = 0.5f * (zk.y + zc.y), bi = -0.5f * (zk.x - zc.x);
      buf[k] = make_float2((ar * ar + ai * ai) * (1.0f / kFFT),
                           (br * br + bi * bi) * (1.0f / kFFT));
    }
    __syncwarp();
    // mel energies over each filter's nonzero bins, floored, log
    for (int m = lane; m < n_mels; m += 32) {
      float acc_a = 0.f, acc_b = 0.f;
      const float* wm = mel_w + (size_t)m * kBins;
      const int hi = __ldg(mel_hi + m);
      for (int k = __ldg(mel_lo + m); k < hi; ++k) {
        const float wk = __ldg(wm + k);
        const float2 pk = buf[k];
        acc_a += wk * pk.x;
        acc_b += wk * pk.y;
      }
      if (acc_a <= 0.f) acc_a = 2.220446049250313e-16f;  // float64 eps
      if (acc_b <= 0.f) acc_b = 2.220446049250313e-16f;
      lm[m] = logf(acc_a);
      lm[n_mels + m] = logf(acc_b);
    }
    __syncwarp();
    // DCT-II with the lifter folded in; both rows out at once
    for (int i = lane; i < n_out; i += 32) {
      const int fr = i / n_ceps, c = i % n_ceps;
      float acc = 0.f;
      if (fa + fr < nf) {
        const float* lr = lm + fr * n_mels;
        for (int m = 0; m < n_mels; ++m) acc += lr[m] * __ldg(dct_lift + m * n_ceps + c);
      }
      o[i] = acc;
    }
    __syncwarp();  // the buffer is reused by the next pair
  }
}

// K14: deltas, delta-deltas and the per-utterance standardization of one
// utterance's cepstra, kTile frames at a time: each tile's rows, with two
// rows of halo on either side, are staged in shared memory (rows outside
// [0, nf) as zeros, which the one-sided end rules never read).
struct Tile {
  const float* xs;  // rows f0 - 2 .. f0 + kTile + 1, nc columns each
  int f0, nf, nc;
  __device__ __forceinline__ float c(int f, int k) const { return xs[(f - f0 + 2) * nc + k]; }
  // delta of column k at frame f < nf, one-sided at both ends
  __device__ __forceinline__ float d1(int f, int k) const {
    if (f == nf - 1) return c(f, k) - c(max(f - 1, 0), k);
    if (f == 0) return c(1, k) - c(0, k);
    return c(f + 1, k) - c(f - 1, k);
  }
  __device__ __forceinline__ float d2(int f, int k) const {
    if (f == nf - 1) return d1(f, k) - d1(max(f - 1, 0), k);
    if (f == 0) return d1(1, k) - d1(0, k);
    return d1(f + 1, k) - d1(f - 1, k);
  }
  // feature group g (0: cepstra, 1: deltas, 2: delta-deltas), column k
  __device__ __forceinline__ float at(int f, int g, int k) const {
    return g == 0 ? c(f, k) : (g == 1 ? d1(f, k) : d2(f, k));
  }
};

constexpr int kTile = 128;

__global__ void __launch_bounds__(kTailThreads)
mfcc_tail_kernel(const float* __restrict__ ceps, const int* __restrict__ nframes,
                 float* __restrict__ out, int F, int nc, int standardize) {
  extern __shared__ float sm[];  // staged rows, [groups][3 nc] partial sums, mean, scale
  const int b = blockIdx.x, tid = threadIdx.x;
  const int D = 3 * nc, groups = kTailThreads / nc;
  float* xs = sm;
  float* red = xs + (kTile + 4) * nc;
  float* mean = red + groups * D;
  float* scale = mean + D;
  const float* x = ceps + (size_t)b * F * nc;
  float* o = out + (size_t)b * F * D;
  const int nf = min(nframes[b], F);
  const float denom = (float)max(nf, 1);
  const int g = tid / nc, k = tid % nc;

  // pass 0: the mean; pass 1: the population variance around it; pass 2:
  // the output rows (every row < F, zeros from nf on).  In the output pass
  // thread (r, col) writes column col of rows r, r + rows_per, ...: each
  // step's rows_per rows of D columns are one contiguous run.
  const int rows_per = kTailThreads / D, r0 = tid / D, col = tid % D;
  const int cg = col / nc, ck = col % nc;
  for (int pass = standardize ? 0 : 2; pass < 3; ++pass) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    const int frames = pass < 2 ? nf : F;
    for (int f0 = 0; f0 < frames; f0 += kTile) {
      __syncthreads();  // the previous tile has been read
      const int lo = max(f0 - 2, 0), hi = min(f0 + kTile + 2, nf);
      for (int i = tid; i < (kTile + 4) * nc; i += kTailThreads) {
        const int f = f0 - 2 + i / nc;
        xs[i] = (f >= lo && f < hi) ? x[(size_t)f * nc + i % nc] : 0.f;
      }
      __syncthreads();
      const Tile t{xs, f0, nf, nc};
      const int f1 = min(f0 + kTile, frames);
      if (pass < 2) {
        if (g < groups) {
          for (int f = f0 + g; f < f1; f += groups) {
            float a = t.c(f, k), d = t.d1(f, k), e = t.d2(f, k);
            if (pass) {
              a -= mean[k];
              d -= mean[nc + k];
              e -= mean[2 * nc + k];
              a *= a;
              d *= d;
              e *= e;
            }
            s0 += a;
            s1 += d;
            s2 += e;
          }
        }
      } else if (r0 < rows_per) {
        const float mu = standardize ? mean[col] : 0.f, sc = standardize ? scale[col] : 1.f;
        for (int f = f0 + r0; f < f1; f += rows_per) {
          float v = 0.f;
          if (f < nf) {
            v = t.at(f, cg, ck);
            if (standardize) v = (v - mu) / sc;
          }
          o[(size_t)f * D + col] = v;
        }
      }
    }
    if (pass < 2) {
      // the groups' partials, added by D threads
      if (g < groups) {
        red[g * D + k] = s0;
        red[g * D + nc + k] = s1;
        red[g * D + 2 * nc + k] = s2;
      }
      __syncthreads();
      if (tid < D) {
        float sum = 0.f;
        for (int i = 0; i < groups; ++i) sum += red[i * D + tid];
        if (pass)
          scale[tid] = sqrtf(fmaxf(sum / denom, 1e-20f));
        else
          mean[tid] = sum / denom;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// K12 (and K3's first launch): signals [B, L] f32, lengths [B] i32, window
// [fl], mel_w [n_mels, 257], mel_lo / mel_hi [n_mels] i32, dct_lift
// [n_mels, n_ceps] -> out [B, F, n_ceps] (rows >= nf zeros) and nf [B] i32,
// the psf frame counts clamped to F.  The grid is at most four CTAs per SM;
// each warp walks frame pairs.
extern "C" int mfcc_ceps_launch(const float* sig, const int* lengths,
                                int* nf, const float* window,
                                const float* mel_w, const int* mel_lo,
                                const int* mel_hi, const float* dct_lift,
                                float* out, int B, int L, int F, int fl,
                                int fs, float preemph, int n_mels, int n_ceps,
                                void* stream) {
  // the log energies of both frames live in the buffer's free slots
  if (B <= 0 || F <= 0 || n_mels < 1 || n_ceps < 1 || n_mels > kBuf - kBins)
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long tasks = (long long)B * ((F + 1) / 2);
  const long long want = (tasks + kWarps - 1) / kWarps;
  const int grid = (int)(want < (long long)n_sm * kCtasPerSm ? want : (long long)n_sm * kCtasPerSm);
  // shared memory for kCtasPerSm CTAs on an SM, the rest L1
  const int pct = (kCtasPerSm * (int)(sizeof(float2) * (kFFT + kWarps * kBuf)) * 100 +
                   SRT_MAX_SMEM - 1) / SRT_MAX_SMEM + 1;
  const cudaError_t e = cudaFuncSetAttribute(
      mfcc_ceps_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct < 100 ? pct : 100);
  if (e != cudaSuccess) return (int)e;
  mfcc_ceps_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      sig, lengths, nf, window, mel_w, mel_lo, mel_hi, dct_lift, out, B, L, F, fl, fs,
      preemph, n_mels, n_ceps);
  return (int)cudaGetLastError();
}

// K14: cepstra [B, F, n_ceps] (rows < nf read), nf [B] -> out [B, F,
// 3 n_ceps]: ceps, delta, delta-delta, standardized per utterance when
// `standardize` is 1; rows >= nf zeros.
extern "C" int mfcc_tail_launch(const float* ceps, const int* nf, float* out, int B,
                                int F, int n_ceps, int standardize, void* stream) {
  if (B <= 0 || F <= 0 || n_ceps < 1 || 3 * n_ceps > kTailThreads)
    return (int)cudaErrorInvalidValue;
  const int smem =
      ((kTile + 4) * n_ceps + (kTailThreads / n_ceps + 2) * 3 * n_ceps) * (int)sizeof(float);
  mfcc_tail_kernel<<<B, kTailThreads, smem, (cudaStream_t)stream>>>(ceps, nf, out, F,
                                                                     n_ceps, standardize);
  return (int)cudaGetLastError();
}
