// Pieces shared by the two descriptor searches, refine_matches.cu (the full
// (2r+1)^2 window) and refine_separable.cu (a u-pass then a v-pass).
//
// Query<T, F>: a query descriptor held in registers and its score against
// one descriptor row, which arrives as F / 8 vector units (uint4 of 8 bf16
// values, uint2 of 8 int8 values). bf16: the fp32 sum of the products in
// feature order, each multiply and add rounded on its own (a product of
// two bf16 values is exact in fp32), as refine_matches_plain sums;
// score_fma rounds each multiply-add once, as
// refine_matches_separable_plain sums (in float64, rounded to fp32 a step).
// int8: the products and every partial sum are integers below 2^24, exact
// in fp32 in any order, so the sum is taken with dp4a and converted once.
//
// Query placement: with grid_w > 0 the N queries of a batch item are a
// row-major grid of that width and a block owns a PATCH_W x PATCH_H patch
// of it (the threads of a block read neighbouring image rows); with
// grid_w == 0 a block owns THREADS consecutive queries of one batch item.
//
// take_tap: "first maximum wins, a NaN score counts as the maximum", as
// torch.argmax and jnp.argmax choose.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace desc {

constexpr int PATCH_W = 16;
constexpr int PATCH_H = 8;
constexpr int THREADS = PATCH_W * PATCH_H;

__device__ __forceinline__ float bf16_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

template <typename T, int F>
struct Query;

template <int F>
struct Query<uint16_t, F> {
  using Unit = uint4;
  float q[F];
  __device__ __forceinline__ void load(const Unit* src) {
#pragma unroll
    for (int p = 0; p < F / 8; ++p) {
      Unit v = src[p];
      q[8 * p + 0] = bf16_lo(v.x);
      q[8 * p + 1] = bf16_hi(v.x);
      q[8 * p + 2] = bf16_lo(v.y);
      q[8 * p + 3] = bf16_hi(v.y);
      q[8 * p + 4] = bf16_lo(v.z);
      q[8 * p + 5] = bf16_hi(v.z);
      q[8 * p + 6] = bf16_lo(v.w);
      q[8 * p + 7] = bf16_hi(v.w);
    }
  }
  __device__ __forceinline__ float score(const Unit* row) const {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < F / 8; ++p) {
      const Unit v = row[p];
      s = __fadd_rn(s, __fmul_rn(bf16_lo(v.x), q[8 * p + 0]));
      s = __fadd_rn(s, __fmul_rn(bf16_hi(v.x), q[8 * p + 1]));
      s = __fadd_rn(s, __fmul_rn(bf16_lo(v.y), q[8 * p + 2]));
      s = __fadd_rn(s, __fmul_rn(bf16_hi(v.y), q[8 * p + 3]));
      s = __fadd_rn(s, __fmul_rn(bf16_lo(v.z), q[8 * p + 4]));
      s = __fadd_rn(s, __fmul_rn(bf16_hi(v.z), q[8 * p + 5]));
      s = __fadd_rn(s, __fmul_rn(bf16_lo(v.w), q[8 * p + 6]));
      s = __fadd_rn(s, __fmul_rn(bf16_hi(v.w), q[8 * p + 7]));
    }
    return s;
  }
  // The same sum as a chain of fused multiply-adds in feature order: each
  // step rounds s + a * b once (the product of two bf16 values is exact),
  // equal to score() wherever every product lies in fp32's normal range.
  // __fmaf_rn stays fused under -fmad=false.
  __device__ __forceinline__ float score_fma(const Unit* row) const {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < F / 8; ++p) {
      const Unit v = row[p];
      s = __fmaf_rn(bf16_lo(v.x), q[8 * p + 0], s);
      s = __fmaf_rn(bf16_hi(v.x), q[8 * p + 1], s);
      s = __fmaf_rn(bf16_lo(v.y), q[8 * p + 2], s);
      s = __fmaf_rn(bf16_hi(v.y), q[8 * p + 3], s);
      s = __fmaf_rn(bf16_lo(v.z), q[8 * p + 4], s);
      s = __fmaf_rn(bf16_hi(v.z), q[8 * p + 5], s);
      s = __fmaf_rn(bf16_lo(v.w), q[8 * p + 6], s);
      s = __fmaf_rn(bf16_hi(v.w), q[8 * p + 7], s);
    }
    return s;
  }
};

template <int F>
struct Query<int8_t, F> {
  using Unit = uint2;
  int q[F / 4];
  __device__ __forceinline__ void load(const Unit* src) {
#pragma unroll
    for (int p = 0; p < F / 8; ++p) {
      Unit v = src[p];
      q[2 * p + 0] = (int)v.x;
      q[2 * p + 1] = (int)v.y;
    }
  }
  __device__ __forceinline__ float score(const Unit* row) const {
    int s = 0;
#pragma unroll
    for (int p = 0; p < F / 8; ++p) {
      const Unit v = row[p];
      s = __dp4a((int)v.x, q[2 * p + 0], s);
      s = __dp4a((int)v.y, q[2 * p + 1], s);
    }
    return (float)s;
  }
};

// Candidate `tap` with score s: keep it if it is the first NaN, or larger
// than every earlier score while no NaN was seen.
__device__ __forceinline__ void take_tap(float s, int tap, float& best,
                                         bool& best_nan, int& best_tap) {
  if (best_nan) return;
  if (s != s) {
    best_nan = true;
    best_tap = tap;
  } else if (s > best) {
    best = s;
    best_tap = tap;
  }
}

// This thread's query: batch item b, index `local` inside it, and whether
// it exists (the last patch or block may be ragged).
__device__ __forceinline__ void locate_query(int N, int grid_w, int& b,
                                             int& local, bool& valid) {
  const int tid = threadIdx.x;
  if (grid_w > 0) {
    const int grid_h = N / grid_w;
    const int bx = (grid_w + PATCH_W - 1) / PATCH_W;
    const int by = (grid_h + PATCH_H - 1) / PATCH_H;
    b = blockIdx.x / (bx * by);
    const int r = blockIdx.x - b * (bx * by);
    const int byi = r / bx;
    const int qx = (r - byi * bx) * PATCH_W + tid % PATCH_W;
    const int qy = byi * PATCH_H + tid / PATCH_W;
    valid = qx < grid_w && qy < grid_h;
    local = qy * grid_w + qx;
  } else {
    const int per_item = (N + THREADS - 1) / THREADS;
    b = blockIdx.x / per_item;
    local = (blockIdx.x - b * per_item) * THREADS + tid;
    valid = local < N;
  }
}

// Blocks of THREADS threads that cover B items of N queries.
inline long long query_blocks(int B, int N, int grid_w) {
  if (grid_w > 0) {
    const int grid_h = N / grid_w;
    return (long long)B * ((grid_w + PATCH_W - 1) / PATCH_W) *
           ((grid_h + PATCH_H - 1) / PATCH_H);
  }
  return (long long)B * ((N + THREADS - 1) / THREADS);
}

}  // namespace desc
