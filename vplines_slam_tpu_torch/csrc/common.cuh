// Shared device helpers for the kernels in this directory.
#pragma once

#include <cuda_runtime.h>

namespace vp {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum K values over the whole block (blockDim.x a multiple of 32, <= 1024).
// scratch holds K*32 floats.  Every thread gets the totals; the summation
// order is fixed, so the result is deterministic run to run.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* scratch) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[k * 32 + wid] = v[k];
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x = lane < nwarps ? scratch[k * 32 + lane] : 0.f;
      x = warp_sum(x);
      if (lane == 0) scratch[k * 32] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = scratch[k * 32];
  __syncthreads();
}

// Order-preserving map float -> int so atomicMax on ints is a float max.
__device__ __forceinline__ int float_to_ordered(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float ordered_to_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

}  // namespace vp
