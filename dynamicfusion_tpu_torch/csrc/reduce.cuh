// Fixed-order reductions shared by kernels F, G and P: no float atomics,
// the same association in every run.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 1024;

// sum of x[0:n] in the order of one block of kReduceThreads threads
// (thread t adds x[t], x[t + kReduceThreads], ..., then a shuffle tree
// adds each warp's lanes and another the 32 warps' sums), taken by a block
// of any multiple of 32 threads that divides kReduceThreads: each thread
// stands for the threads t, t + blockDim.x, ... of that block. The loads
// go through L2 (__ldcg), so a launch's last block may sum what its other
// blocks wrote. Every thread of the block must call it; thread 0 gets the
// total.
__device__ inline float ordered_sum(const float* x, int n) {
  __shared__ float sm[kReduceThreads / 32];
  for (int base = 0; base < kReduceThreads; base += blockDim.x) {
    const int t = base + threadIdx.x;
    float s = 0.0f;
    for (int i = t; i < n; i += kReduceThreads) s += __ldcg(x + i);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if ((t & 31) == 0) sm[t >> 5] = s;
  }
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < 32) {
    total = sm[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) total += __shfl_down_sync(0xffffffffu, total, o);
  }
  return total;
}

// out[0] = sum of x[0:n], by one block of kReduceThreads threads
__global__ void __launch_bounds__(kReduceThreads) sum_kernel(const float* __restrict__ x, int n,
                                                             float* __restrict__ out) {
  const float total = ordered_sum(x, n);
  if (threadIdx.x == 0) out[0] = total;
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
