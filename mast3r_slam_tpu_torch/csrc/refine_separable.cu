// Separable descriptor window search: per dilation level a u-pass, then a
// v-pass.
//
// Counterpart of mast3r_slam_tpu/ops/window_gather.py
// ::refine_matches_separable (:374) with its _axis_pass (:352), which the
// JAX package runs in XLA when matching.separable_refine is set
// (ops/matching.py:372). The TPU layout of that function (the
// phase-decimated u-unfold and the swapped-axes image for the v-pass) is
// not carried over: the kernel reads the descriptor rows directly.
//
// D11: (B, H, W, F) bf16 (as uint16 bits) or int8 descriptor image.
// D21: (B, N, F) query descriptors of the same type.
// p1:  (B, N, 2) int32 start pixels (u, v), inside the image (match clamps
//      them); out: (B, N, 2) int32.
//
// For d = dilation_max .. 1: the u-pass scores the 2r+1 candidates
// (u0 + (j - r) d, v0), the v-pass the 2r+1 candidates (u0, v0 + (i - r) d)
// at the u0 the u-pass chose. A candidate outside the image scores -inf;
// the first maximum wins and a NaN score counts as the maximum; the chosen
// coordinate is clamped into the image. Scores as in refine_matches.cu
// (desc_search.cuh): bf16 summed in fp32 in feature order without FMA,
// int8 with dp4a, so the result is bit-equal to the plain PyTorch version.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): one pass over D11, D21,
// p1 and the output is 22 MB at the base preset's (1, 384, 512, 24) bf16
// with 196,608 queries, 0.0066 ms at 3.35 TB/s; the work is 2 x (2r+1) taps
// x F x 2 FLOP x dilation_max levels a point, 0.66 GFLOP at r = 3, d = 5,
// 0.0099 ms at the 67 TFLOP/s fp32 peak. What the design does about it:
//  * a descriptor row arrives as F / 8 vector loads (16 bytes for bf16, 8
//    for int8), not F scalar ones;
//  * the rows of all 2r+1 taps of a pass (up to TAPS at once) are loaded
//    before any is summed, each tap with its own accumulator in feature
//    order, so that the loads and add chains of a pass are in flight
//    together;
//  * the two passes of a level depend on each other, so u0 and v0 stay in
//    registers across all levels of a point: one launch a call;
//  * a block owns a patch of the query grid (grid_w > 0) or consecutive
//    queries, so its threads read neighbouring rows of the image.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "desc_search.cuh"

namespace {

using desc::Query;
using desc::THREADS;

// taps loaded before they are summed (a pass at radius r has 2r+1)
constexpr int TAPS = 7;

// One pass for one point: the 2r+1 candidates along u (along_u) or v
// around (u0, v0) at dilation d; updates u0 or v0.
template <typename T, int F>
__device__ __forceinline__ void axis_pass(
    const Query<T, F>& q, const typename Query<T, F>::Unit* img, int H, int W,
    int radius, int d, bool along_u, int& u0, int& v0) {
  using Unit = typename Query<T, F>::Unit;
  constexpr int RU = F / 8;
  const int k = 2 * radius + 1;
  const int lim = along_u ? W : H;
  const int c0 = along_u ? u0 : v0;
  // the fixed coordinate, clamped for the reads (starts are inside the
  // image; a pass always leaves its coordinate inside)
  const int fu = u0 < 0 ? 0 : (u0 > W - 1 ? W - 1 : u0);
  const int fv = v0 < 0 ? 0 : (v0 > H - 1 ? H - 1 : v0);
  float best = -CUDART_INF_F;
  bool best_nan = false;
  int best_tap = 0;
  for (int t0 = 0; t0 < k; t0 += TAPS) {
    Unit rows[TAPS][RU];
    bool inside[TAPS];
#pragma unroll
    for (int g = 0; g < TAPS; ++g) {
      const int c = c0 + (t0 + g - radius) * d;
      inside[g] = t0 + g < k && c >= 0 && c < lim;
      if (inside[g]) {
        const long long pix =
            along_u ? (long long)fv * W + c : (long long)c * W + fu;
        const Unit* rp = img + pix * RU;
#pragma unroll
        for (int p = 0; p < RU; ++p) rows[g][p] = rp[p];
      } else {
#pragma unroll
        for (int p = 0; p < RU; ++p) rows[g][p] = Unit{};
      }
    }
    float s[TAPS];
#pragma unroll
    for (int g = 0; g < TAPS; ++g) {
      s[g] = inside[g] ? q.score(rows[g]) : -CUDART_INF_F;
    }
#pragma unroll
    for (int g = 0; g < TAPS; ++g) {
      if (t0 + g < k) desc::take_tap(s[g], t0 + g, best, best_nan, best_tap);
    }
  }
  const int cn = c0 + (best_tap - radius) * d;
  const int cc = cn < 0 ? 0 : (cn > lim - 1 ? lim - 1 : cn);
  if (along_u) {
    u0 = cc;
  } else {
    v0 = cc;
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(THREADS)
separable_kernel(const T* __restrict__ D11, const T* __restrict__ D21,
                 const int* __restrict__ p1, int* __restrict__ out, int H,
                 int W, int N, int grid_w, int radius, int dilation_max) {
  using Unit = typename Query<T, F>::Unit;
  constexpr int RU = F / 8;
  int b, local;
  bool valid;
  desc::locate_query(N, grid_w, b, local, valid);
  if (!valid) return;
  const long long i = (long long)b * N + local;
  const Unit* img =
      reinterpret_cast<const Unit*>(D11) + (long long)b * H * W * RU;
  Query<T, F> q;
  q.load(reinterpret_cast<const Unit*>(D21) + i * RU);
  const int2 p = reinterpret_cast<const int2*>(p1)[i];
  int u0 = p.x, v0 = p.y;
  for (int d = dilation_max; d >= 1; --d) {
    axis_pass<T, F>(q, img, H, W, radius, d, true, u0, v0);
    axis_pass<T, F>(q, img, H, W, radius, d, false, u0, v0);
  }
  reinterpret_cast<int2*>(out)[i] = make_int2(u0, v0);
}

template <typename T, int F>
int launch_f(const void* D11, const void* D21, const int* p1, int* out, int B,
             int H, int W, int N, int grid_w, int radius, int dilation_max,
             cudaStream_t stream) {
  const long long blocks = desc::query_blocks(B, N, grid_w);
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  separable_kernel<T, F><<<(unsigned)blocks, THREADS, 0, stream>>>(
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
extern "C" int refine_separable_launch(const void* D11, const void* D21,
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
