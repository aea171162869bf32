// Separable descriptor window search: per dilation level a u-pass, then a
// v-pass.
//
// Counterpart of mast3r_slam_tpu/ops/window_gather.py
// ::refine_matches_separable (:374) with its _axis_pass (:353), which the
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
// the first maximum wins and a NaN score counts as the maximum (the first
// NaN wins; if every score is -inf, tap 0); the chosen coordinate is
// clamped into the image. Scores: bf16 as a chain of fused multiply-adds in
// feature order (Query::score_fma; a product of two bf16 values is exact,
// so each step rounds a + b * c once, as the plain version's float64 step
// does), int8 with dp4a (exact integers), so the result is bit-equal to the
// plain PyTorch version.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): one pass over D11, D21,
// p1 and the output is 22 MB at the base preset's (1, 384, 512, 24) bf16
// with 196,608 queries, 0.0066 ms at 3.35 TB/s; the work is 2 x (2r+1) taps
// x F x 2 FLOP x dilation_max levels a point, 0.66 GFLOP at r = 3, d = 5,
// 0.0099 ms at the 67 TFLOP/s fp32 peak. What limits it is L1: a lane
// reads its own 48-byte row (bf16, F = 24) as three 16-byte loads, so each
// load of a warp touches about 12 cache lines, and the two passes of a
// level depend on each other (a pass needs the previous argmax before it
// can form addresses). What the design does about it:
//  * one lane a query loads every row of a pass before it scores any (the
//    tap count is a template case for r = 1, 2, 3, so no tap that does not
//    exist is scored; chunks of 7 taps, taken in order, for other radii):
//    one load round trip a pass;
//  * bf16 scores are FMA chains, 48 instructions a tap at F = 24 where
//    separate roundings take 72;
//  * the argmax compares an order-preserving 32-bit key of the score (any
//    NaN largest, -0 == +0), strictly greater replaces: the first maximum;
//  * a block owns a 16 x 8 patch of the query grid (grid_w > 0) or 128
//    consecutive queries, so a warp reads rows of the same image rows;
//  * u0 and v0 stay in registers across all levels: one launch a call.
// Lane groups (a group of lanes a query, one tap a lane, the winner by
// shuffles) were measured on the H100 and not kept: they lose on the
// coherent starts of the tracker and of add_factors and win only on
// scattered starts (PERF.md, section 6). Tensor cores do not fit: each
// query scores its own rows, a dot product per query and no shared matrix
// product.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "desc_search.cuh"

namespace {

using desc::Query;
using desc::THREADS;

// bf16 scores by the FMA chain, int8 by dp4a.
template <int F>
__device__ __forceinline__ float tap_score(const Query<uint16_t, F>& q,
                                           const uint4* row) {
  return q.score_fma(row);
}
template <int F>
__device__ __forceinline__ float tap_score(const Query<int8_t, F>& q,
                                           const uint2* row) {
  return q.score(row);
}

// A score as an unsigned key whose order is the argmax order: any NaN is
// the largest key, -0 and +0 are one key, and 0 is below every score.
__device__ __forceinline__ unsigned order_key(float s) {
  if (s != s) return 0xffffffffu;
  const unsigned b = __float_as_uint(__fadd_rn(s, 0.0f));   // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One pass for one point: the k = 2r+1 candidates along u (along_u) or v
// around (u0, v0) at dilation d, in chunks of M taps; updates u0 or v0.
// K: k at compile time, or 0.
template <typename T, int F, int K, int M>
__device__ __forceinline__ void axis_pass(
    const Query<T, F>& q, const typename Query<T, F>::Unit* img, int H, int W,
    int radius, int d, bool along_u, int& u0, int& v0) {
  using Unit = typename Query<T, F>::Unit;
  constexpr int RU = F / 8;
  const int k = K > 0 ? K : 2 * radius + 1;
  const int lim = along_u ? W : H;
  const int c0 = along_u ? u0 : v0;
  // the fixed coordinate, clamped for the reads (starts are inside the
  // image; a pass always leaves its coordinate inside)
  const int fu = u0 < 0 ? 0 : (u0 > W - 1 ? W - 1 : u0);
  const int fv = v0 < 0 ? 0 : (v0 > H - 1 ? H - 1 : v0);
  unsigned best_key = 0;
  int best_tap = 0;
#pragma unroll
  for (int t0 = 0; t0 < k; t0 += M) {
    // all M rows of the chunk are loaded, then scored in tap order
    Unit rows[M][RU];
    bool inside[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = c0 + (t0 + m - radius) * d;
      inside[m] = t0 + m < k && c >= 0 && c < lim;
      if (inside[m]) {
        const long long pix =
            along_u ? (long long)fv * W + c : (long long)c * W + fu;
        const Unit* rp = img + pix * RU;
#pragma unroll
        for (int p = 0; p < RU; ++p) rows[m][p] = __ldg(rp + p);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (t0 + m < k) {
        const unsigned key =
            order_key(inside[m] ? tap_score<F>(q, rows[m]) : -CUDART_INF_F);
        if (key > best_key) {
          best_key = key;
          best_tap = t0 + m;
        }
      }
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

// R: the radius at compile time, or -1 (any radius, chunks of 7 taps).
template <typename T, int F, int R>
__global__ void __launch_bounds__(THREADS)
separable_kernel(const T* __restrict__ D11, const T* __restrict__ D21,
                 const int* __restrict__ p1, int* __restrict__ out, int H,
                 int W, int N, int grid_w, int radius, int dilation_max) {
  using Unit = typename Query<T, F>::Unit;
  constexpr int RU = F / 8;
  constexpr int K = R >= 0 ? 2 * R + 1 : 0;
  constexpr int M = R >= 0 ? K : 7;
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
  const int r = R >= 0 ? R : radius;
  int u0 = p.x, v0 = p.y;
  for (int d = dilation_max; d >= 1; --d) {
    axis_pass<T, F, K, M>(q, img, H, W, r, d, true, u0, v0);
    axis_pass<T, F, K, M>(q, img, H, W, r, d, false, u0, v0);
  }
  reinterpret_cast<int2*>(out)[i] = make_int2(u0, v0);
}

template <typename T, int F, int R>
int launch_r(const void* D11, const void* D21, const int* p1, int* out,
             int B, int H, int W, int N, int grid_w, int radius,
             int dilation_max, cudaStream_t stream) {
  const long long blocks = desc::query_blocks(B, N, grid_w);
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  separable_kernel<T, F, R><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)D11, (const T*)D21, p1, out, H, W, N, grid_w, radius,
      dilation_max);
  return (int)cudaGetLastError();
}

// The tap count by radius: r = 1, 2, 3 at compile time, others in chunks.
template <typename T, int F>
int launch_f(const void* D11, const void* D21, const int* p1, int* out, int B,
             int H, int W, int N, int grid_w, int radius, int dilation_max,
             cudaStream_t stream) {
#define LAUNCH(R)                                                          \
  return launch_r<T, F, R>(D11, D21, p1, out, B, H, W, N, grid_w, radius,  \
                           dilation_max, stream)
  switch (radius) {
    case 1: LAUNCH(1);
    case 2: LAUNCH(2);
    case 3: LAUNCH(3);
    default: LAUNCH(-1);
  }
#undef LAUNCH
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
