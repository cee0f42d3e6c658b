// The latency floor of one block step of the forward-backward scans
// (csrc/forward_backward.cu) on the card: 838 CTAs of 96 threads (K16's
// scan at the soft-EM call), 638 steps, each ending in a barrier; thread
// 0's clock64 cycles a step, mean and slowest CTA, for a step of
//   mode 0: a shared-memory read and a barrier;
//   mode 1: + a 2-term log-sum-exp (IEEE expf, logf);
//   mode 2: + a logaddexp (expf, log1pf);
//   mode 3: + the warp max by redux and the block max read after the
//           barrier (the scan's zall);
// and mode 2 again at one CTA an SM.  Build and run on a machine with one
// GPU:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o step_floor \
//       scripts/exp_r14_step_floor.cu && ./step_floor
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ float wmaxr(float v) {
  const int i = __float_as_int(v);
  const int k = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}
template <int MODE>
__global__ void __launch_bounds__(224, 3) k(float* out, long long* cyc, int steps) {
  __shared__ float row[2][96];
  __shared__ float wm[2][8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  row[0][tid] = tid * 0.01f - 3.0f;
  __syncthreads();
  long long t0 = clock64();
  int p = 0;
  float acc = 0.0f;
  for (int s = 0; s < steps; ++s) {
    float x = row[p][(tid * 7) % 96];
    float y = x;
    if (MODE >= 1) {  // a 2-term LSE
      const float z1 = row[p][(tid * 11 + 1) % 96] - 1.0f;
      const float m = fmaxf(x, z1);
      y = logf(expf(x - m) + expf(z1 - m)) + m;
    }
    if (MODE >= 2) {  // + logaddexp
      const float d = -fabsf(y - x);
      y = fmaxf(x, y) + log1pf(expf(d));
    }
    if (MODE >= 3) {  // + publish and read the block max
      const float m = wmaxr(y);
      if (lane == 0) wm[s & 1][warp] = m;
    }
    row[p ^ 1][tid] = y * 0.5f;
    __syncthreads();
    if (MODE >= 3) {
      float m = -INFINITY;
      for (int i = 0; i < 3; ++i) m = fmaxf(m, wm[s & 1][i]);
      acc += m;
    }
    p ^= 1;
  }
  long long t1 = clock64();
  if (tid == 0) cyc[blockIdx.x] = t1 - t0;
  out[blockIdx.x * 96 + tid] = row[p][tid] + acc;
}
int main() {
  float* out; long long* cyc; cudaMalloc(&out, 838 * 96 * 4); cudaMalloc(&cyc, 838 * 8);
  long long h[838];
  for (int mode = 0; mode < 4; ++mode) {
    for (int rep = 0; rep < 2; ++rep) {
      if (mode == 0) k<0><<<838, 96>>>(out, cyc, 638);
      if (mode == 1) k<1><<<838, 96>>>(out, cyc, 638);
      if (mode == 2) k<2><<<838, 96>>>(out, cyc, 638);
      if (mode == 3) k<3><<<838, 96>>>(out, cyc, 638);
      cudaDeviceSynchronize();
    }
    cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
    double s = 0; long long mx = 0;
    for (int i = 0; i < 838; ++i) { s += h[i]; mx = h[i] > mx ? h[i] : mx; }
    printf("mode %d: cycles a step mean %.1f max %.1f\n", mode, s / 838 / 638, (double)mx / 638);
  }
  // one CTA per SM
  k<2><<<132, 96>>>(out, cyc, 638); cudaDeviceSynchronize();
  cudaMemcpy(h, cyc, 132 * 8, cudaMemcpyDeviceToHost);
  double s = 0; for (int i = 0; i < 132; ++i) s += h[i];
  printf("mode 2 at one CTA an SM: %.1f\n", s / 132 / 638);
  return 0;
}
