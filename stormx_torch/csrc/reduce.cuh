// Deterministic two-pass sums for the kernels of stormx_torch/csrc.
//
// A kernel reduces each block's partial with block_sum and writes it to
// partials[blockIdx.x]; sum_partials_kernel, launched with one block right
// after it on the same stream, adds the partials in a fixed order.  Neither
// pass uses atomics, so for a given grid the sum is the same from run to run.

#pragma once

#include <cuda_runtime.h>

namespace stormx {

constexpr int kThreads = 256;        // threads per block of the reducing kernels
constexpr int kFinalThreads = 1024;  // threads of the one block of the second pass

// Sum of v over the block, valid in thread 0.  blockDim.x must be a multiple
// of 32; every thread of the block must call it.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? warp_sums[threadIdx.x] : T(0);
  if (warp == 0)
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// *out = Σ partials[0..n), with one block of kFinalThreads threads.
template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
    sum_partials_kernel(const T* __restrict__ partials, int n, T* __restrict__ out) {
  T v = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += partials[i];
  v = block_sum(v);
  if (threadIdx.x == 0) *out = v;
}

}  // namespace stormx
