// Fixed-order reductions shared by kernels F, G and P: no float atomics,
// the same association in every run.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 1024;

// out[0] = sum of x[0:n], by one block of kReduceThreads threads
__global__ void __launch_bounds__(kReduceThreads) sum_kernel(const float* __restrict__ x, int n,
                                                             float* __restrict__ out) {
  __shared__ float sm[kReduceThreads / 32];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += x[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = sm[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) out[0] = t;
  }
}

// fixed-order block sum of one value per thread; every thread gets the total
__device__ inline float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) red[32] = t;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();
  return total;
}

}  // namespace
