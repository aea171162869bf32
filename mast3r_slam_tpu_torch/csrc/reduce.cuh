// Deterministic reductions of per-thread accumulator vectors.
//
// block_sum_store: each thread holds NV partial sums. Warps reduce them with
// shuffles in a fixed tree, lane 0 of each warp parks its sums in shared
// memory, and the first NV threads add the warps' sums in warp order and
// write them to `out`.
//
// slot_sums: one block adds `slots` such vectors that other blocks of the
// same launch wrote (slot b at part + b * NV), read through L2. Warp w
// takes the sums w, w + warps, ...; lane l adds slots l, l + 32, ... in
// order, a few slots per sum in flight at once; a shuffle tree adds the
// lanes.
//
// No atomics: the same inputs and the same grid always give the same bits.
// blockDim.x must be a multiple of 32 and at most 32 * MAX_WARPS
// (block_sum_store), exactly 32 * MAX_WARPS (slot_sums).

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

template <int NV>
__device__ __forceinline__ void slot_sums(const float* part, int slots,
                                          float* sums) {
  constexpr int WARPS = MAX_WARPS;
  constexpr int PER_WARP = (NV + WARPS - 1) / WARPS;
  constexpr int BATCH = 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float s[PER_WARP];
#pragma unroll
  for (int j = 0; j < PER_WARP; ++j) s[j] = 0.0f;
  for (int b0 = lane; b0 < slots; b0 += 32 * BATCH) {
    float x[PER_WARP][BATCH];
#pragma unroll
    for (int j = 0; j < PER_WARP; ++j)
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int v = warp + WARPS * j, b = b0 + 32 * q;
        x[j][q] = (v < NV && b < slots) ? __ldcg(part + (long long)b * NV + v)
                                        : 0.0f;
      }
#pragma unroll
    for (int j = 0; j < PER_WARP; ++j)
#pragma unroll
      for (int q = 0; q < BATCH; ++q)
        if (b0 + 32 * q < slots) s[j] += x[j][q];
  }
#pragma unroll
  for (int j = 0; j < PER_WARP; ++j) {
    float x = s[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    const int v = warp + WARPS * j;
    if (lane == 0 && v < NV) sums[v] = x;
  }
}

}  // namespace red
