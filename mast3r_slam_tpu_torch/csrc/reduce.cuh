// Deterministic block reduction of a per-thread accumulator vector.
//
// Each thread holds NV partial sums. Warps reduce them with shuffles in a
// fixed tree, lane 0 of each warp parks its sums in shared memory, and the
// first NV threads add the warps' sums in warp order and write them to
// `out`. No atomics: the same inputs and the same grid always give the same
// bits. blockDim.x must be a multiple of 32 and at most 32 * MAX_WARPS.

#pragma once

#include <cuda_runtime.h>

namespace red {

constexpr int MAX_WARPS = 8;   // 256 threads

template <int NV>
__device__ __forceinline__ void block_sum_store(float* acc, float* out) {
  __shared__ float warp_sums[MAX_WARPS][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float x = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[warp][v] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
    for (int w = 0; w < n_warps; ++w) s += warp_sums[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

}  // namespace red
