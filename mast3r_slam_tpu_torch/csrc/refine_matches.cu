// Coarse-to-fine dilated descriptor window search.
//
// Replaces mast3r_slam_tpu/ops/matching.py::refine_matches (:189-231),
// shipped in the JAX package as ops/window_gather.py
// ::refine_matches_full_unfold (:183). The JAX package kept it in XLA (the
// TPU compiler crashed on its dynamic gathers); the original system ran it
// as a CUDA kernel. The TPU layout tricks (phase-decimated full-window
// unfolds) are not carried over.
//
// D11: (B, H, W, F) bf16 (as uint16 bits) or int8 descriptor image.
// D21: (B, N, F) query descriptors of the same type.
// p1:  (B, N, 2) int32 start pixels (u, v); out: (B, N, 2) int32.
//
// For d = dilation_max .. 1: score the (2r+1)^2 candidates
// (u0 + (j - r) d, v0 + (i - r) d), u fastest, by a dot product of the
// descriptors; candidates outside the image score -inf; the FIRST maximum
// wins (argmax semantics, a NaN score counts as the maximum); the new
// centre is clamped into the image. bf16: the fp32 sum of the products in
// feature order, multiply and add rounded separately, as the plain version
// does (a product of two bf16 values is exact in fp32). int8: the products
// and every partial sum are integers below 2^24, exact in fp32 in any
// order, so the sum is taken with dp4a and converted once.
//
// Bound on the H100: the bytes in device memory are one pass over D11, D21,
// p1 and the output, but every point scores (2r+1)^2 rows per level, 11.8
// KB per point at r = 3, d = 5 (2.3 GB per call through the cache
// hierarchy), in exact fp32 on the CUDA cores: per tap and feature one
// unpack, one multiply and one add (no FMA), about 100 instructions a tap
// with the addressing and the comparison. What the design does about it:
//  * a descriptor row arrives as F / 8 vector loads (16 bytes for bf16, 8
//    for int8), not F scalar ones;
//  * the rows of several taps are loaded before any is summed, each tap
//    with its own accumulator in feature order, so that many loads and add
//    chains are in flight; the comparisons still run u fastest;
//  * a block owns a patch of the query grid (or consecutive queries when
//    the caller gives no grid width), so its threads read neighbouring
//    rows of the image.
// A shared-memory window was tried and dropped: staging, at every level, the
// bounding box of a block's centres plus r * d pixels and reading the taps
// from shared memory was slower on the H100 than reading them through L1
// (L1 already serves neighbouring windows well, and a block that fills a
// multiprocessor's shared memory waits alone at its barriers).

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "desc_search.cuh"

namespace {

using desc::PATCH_H;
using desc::PATCH_W;
using desc::Query;
using desc::THREADS;

// TAPS taps in flight per thread.
constexpr int TAPS = 7;

// One level of the search for one point: the (2r+1)^2 taps around (u0, v0)
// at dilation d.
template <typename T, int F>
__device__ __forceinline__ void score_level(
    const Query<T, F>& q, const typename Query<T, F>::Unit* img, int H, int W,
    int radius, int d, int& u0, int& v0) {
  using Unit = typename Query<T, F>::Unit;
  constexpr int RU = F / 8;
  const int k = 2 * radius + 1;
  const int kk = k * k;
  float best = -CUDART_INF_F;
  bool best_nan = false;
  int bi = 0, bj = 0;
  int li = 0, lj = 0;       // tap (row, column) of the next load
  int ci = 0, cj = 0;       // tap of the next comparison
  for (int t0 = 0; t0 < kk; t0 += TAPS) {
    Unit rows[TAPS][RU];
    bool inside[TAPS];
#pragma unroll
    for (int g = 0; g < TAPS; ++g) {
      const int u = u0 + (lj - radius) * d;
      const int v = v0 + (li - radius) * d;
      inside[g] = t0 + g < kk && u >= 0 && u < W && v >= 0 && v < H;
      if (inside[g]) {
        const Unit* rp = img + ((long long)v * W + u) * RU;
#pragma unroll
        for (int p = 0; p < RU; ++p) rows[g][p] = rp[p];
      } else {
#pragma unroll
        for (int p = 0; p < RU; ++p) rows[g][p] = Unit{};
      }
      if (++lj == k) {
        lj = 0;
        ++li;
      }
    }
    float s[TAPS];
#pragma unroll
    for (int g = 0; g < TAPS; ++g) {
      s[g] = inside[g] ? q.score(rows[g]) : -CUDART_INF_F;
    }
#pragma unroll
    for (int g = 0; g < TAPS; ++g) {
      if (t0 + g < kk) {
        if (!best_nan) {
          if (s[g] != s[g]) {
            best_nan = true;
            bi = ci;
            bj = cj;
          } else if (s[g] > best) {
            best = s[g];
            bi = ci;
            bj = cj;
          }
        }
        if (++cj == k) {
          cj = 0;
          ++ci;
        }
      }
    }
  }
  const int un = u0 + (bj - radius) * d;
  const int vn = v0 + (bi - radius) * d;
  u0 = un < 0 ? 0 : (un > W - 1 ? W - 1 : un);
  v0 = vn < 0 ? 0 : (vn > H - 1 ? H - 1 : vn);
}

// grid_w > 0: N = grid_h * grid_w queries in row-major order, a block owns
// a PATCH_W x PATCH_H patch of one batch item. grid_w == 0: a block owns
// THREADS consecutive queries of one batch item.
template <typename T, int F>
__global__ void __launch_bounds__(THREADS, 1)
refine_kernel(const T* __restrict__ D11, const T* __restrict__ D21,
              const int* __restrict__ p1, int* __restrict__ out, int H, int W,
              int N, int grid_w, int radius, int dilation_max) {
  using Unit = typename Query<T, F>::Unit;
  constexpr int RU = F / 8;
  int b, local;
  bool valid;
  desc::locate_query(N, grid_w, b, local, valid);
  const long long i = (long long)b * N + local;
  const Unit* img =
      reinterpret_cast<const Unit*>(D11) + (long long)b * H * W * RU;

  // guards, not an early return: with these the compiler keeps more rows in
  // registers (142 against 114 at F = 24) and the r = 3 search is 10% faster
  Query<T, F> q;
  int u0 = 0, v0 = 0;
  if (valid) {
    q.load(reinterpret_cast<const Unit*>(D21) + i * RU);
    const int2 p = reinterpret_cast<const int2*>(p1)[i];
    u0 = p.x;
    v0 = p.y;
  }
  for (int d = dilation_max; d >= 1; --d) {
    if (valid) score_level<T, F>(q, img, H, W, radius, d, u0, v0);
  }
  if (valid) {
    reinterpret_cast<int2*>(out)[i] = make_int2(u0, v0);
  }
}

template <typename T, int F>
int launch_f(const void* D11, const void* D21, const int* p1, int* out, int B,
             int H, int W, int N, int grid_w, int radius, int dilation_max,
             cudaStream_t stream) {
  const long long blocks = desc::query_blocks(B, N, grid_w);
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  refine_kernel<T, F><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)D11, (const T*)D21, p1, out, H, W, N, grid_w, radius,
      dilation_max);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* D11, const void* D21, const int* p1, int* out,
                 int B, int H, int W, int N, int F, int grid_w, int radius,
                 int dilation_max, cudaStream_t stream) {
#define LAUNCH(FF)                                                         \
  return launch_f<T, FF>(D11, D21, p1, out, B, H, W, N, grid_w, radius,    \
                         dilation_max, stream)
  switch (F) {
    case 8: LAUNCH(8);
    case 16: LAUNCH(16);
    case 24: LAUNCH(24);
    case 32: LAUNCH(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}

}  // namespace

// grid_w: width of the row-major query grid (N % grid_w == 0), or 0.
extern "C" int refine_matches_launch(const void* D11, const void* D21,
                                     const int* p1, int* out, int B, int H,
                                     int W, int N, int F, int radius,
                                     int dilation_max, int is_int8,
                                     int grid_w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (radius < 0 || grid_w < 0 || (grid_w > 0 && N % grid_w != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (is_int8)
    return launch_typed<int8_t>(D11, D21, p1, out, B, H, W, N, F, grid_w,
                                radius, dilation_max, s);
  return launch_typed<uint16_t>(D11, D21, p1, out, B, H, W, N, F, grid_w,
                                radius, dilation_max, s);
}
