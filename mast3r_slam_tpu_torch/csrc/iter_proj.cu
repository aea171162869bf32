// Per-point 2-DoF Levenberg-Marquardt ray projection.
//
// Replaces mast3r_slam_tpu/ops/matching.py:117 ::iter_proj (:117-186), which
// the JAX package kept in XLA (the TPU compiler crashed on its dynamic
// gathers); the original system ran it as a CUDA kernel too.
//
// img:    (B, H, W, C) fp32, C == 9 [ray(3), d ray/du (3), d ray/dv (3)] or
//         C == 12, the same record padded to 48 bytes (channels 9-11 are not
//         read; scharr_rays writes them as zeros). C == 12 must be 16-byte
//         aligned.
// pts:    (B, N, 3) fp32 unit target directions.
// p_init: (B, N, 2) fp32 initial pixel positions.
// p_out:  (B, N, 2) fp32 refined positions; conv_out: (B, N) bool.
//
// The trajectory is the JAX one exactly: max_iter + 1 evaluations (no early
// exit); the sample of the last ACCEPTED point is carried, so each
// iteration samples only the trial point; the first evaluation accepts the
// (clamped) init point against cost = inf; lambda x0.1 on acceptance, x10
// otherwise; converged = cost < thresh from each iteration's best cost; det
// is not guarded (1/det may be inf, as in JAX). Clamps propagate NaN like
// jnp.clip; a NaN coordinate reads a clamped address and yields a NaN
// sample, so it is never accepted.
//
// Bound on the H100: the function reads the 9-channel image once (7.1 MB at
// 384x512) and the points, 2.5-3.8 us at 3.35 TB/s; its ~110 FLOP an
// evaluation would take less. What limits a kernel is the step's
// arithmetic, issued one warp-instruction at a time: under -fmad=false each
// evaluation is ~100 separate multiplies and adds plus a sqrt and four
// IEEE divides (multi-instruction sequences), and every point runs max_iter
// + 1 evaluations whose gathers each wait on the previous step (at the
// coarse tpu_fast shape, 49,152 points fill 12 of the 64 warps a
// multiprocessor holds, so there the chain's latency shows too).
//
// Design (iter_proj_kernel<C>, one thread a point):
// * The 48-byte record: each corner's ray channels are one 16-byte load
//   (three scalar loads on the 9-float record) and its gradient channels
//   two more.
// * Only an accepted sample's gradients are ever read, so an evaluation
//   loads and blends the ray channels, and the gradient channels (and the
//   normal-equation terms formed from them) only when it accepts the trial:
//   fewer loads, fewer registers (50, and no cap: capping them spills).
//   The accepted terms are carried to the next steps instead of being
//   recomputed from the sample every iteration (the same operations on the
//   same values, so the same bits): one sqrt and three divides less.
// * Two and four threads a point, sharing a sample's taps by shuffles, were
//   built and measured slower at every shape of the matcher on the H100:
//   the step's arithmetic, not the loads' latency, bounds the kernel, and
//   every lane issues it (PERF.md, the iter_proj sweep).
// iter_proj_first is the first design -- one thread a point on the 9-float
// record, scalar loads, the accepted point's error recomputed every step --
// kept as the yardstick that chip_smoke.py times beside the new one.
// Built with -fmad=false and in the plain version's operation order: the
// kernels agree with the plain PyTorch version to the last bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  // NaN passes through, like jnp.clip / torch.clamp
  return x < lo ? lo : (x > hi ? hi : x);
}

// l2_normalize(s[0:3]) - t; a NaN norm propagates, as torch.clamp does
__device__ __forceinline__ void ray_err(const float s[9], const float t[3],
                                        float e[3]) {
  float n = sqrtf(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
  n = n < 1e-12f ? 1e-12f : n;
  e[0] = s[0] / n - t[0];
  e[1] = s[1] / n - t[1];
  e[2] = s[2] / n - t[2];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Integer corner and weights of a bilinear sample at (u, v).
struct Corner {
  long long base;   // record index of the top-left corner
  float du, dv;
};

__device__ __forceinline__ Corner corner(int H, int W, float u, float v) {
  float u11 = floorf(u);
  float v11 = floorf(v);
  int iu = (int)u11;
  int iv = (int)v11;
  // memory safety only: in-range coordinates never trip these
  iu = iu < 0 ? 0 : (iu > W - 2 ? W - 2 : iu);
  iv = iv < 0 ? 0 : (iv > H - 2 ? H - 2 : iv);
  if (!(u11 == u11)) iu = 0;
  if (!(v11 == v11)) iv = 0;
  return {(long long)iv * W + iu, u - u11, v - v11};
}

// Part of a record: PART 0 the ray channels 0-2 (one 16-byte load, which
// brings channel 3 too, or 3 scalar loads), PART 1 the gradient channels
// 3-8 (two 16-byte loads, or 6 scalar loads).
template <int C, int PART>
__device__ __forceinline__ void load_record(const float* __restrict__ p,
                                            float r[9]) {
  if constexpr (C == 12) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    if constexpr (PART == 0) {
      float4 a = __ldg(p4);
      r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    } else {
      float4 b = __ldg(p4 + 1), c = __ldg(p4 + 2);
      r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
      r[8] = c.x;
    }
  } else {
#pragma unroll
    for (int c = PART ? 3 : 0; c < (PART ? 9 : 3); ++c) r[c] = __ldg(p + c);
  }
}

// Channels [C0, C1) of the bilinear sample from the four corner records
// q00, q01, q10, q11, in the plain version's order: top, bot, v-blend.
template <int C0, int C1>
__device__ __forceinline__ void blend(const float r[4][9], const float w[4],
                                      float s[9]) {
#pragma unroll
  for (int i = C0; i < C1; ++i) {
    float top = r[0][i] * w[0] + r[1][i] * w[1];
    float bot = r[2][i] * w[0] + r[3][i] * w[1];
    s[i] = top * w[2] + bot * w[3];
  }
}

template <int C, int PART>
__device__ __forceinline__ void load_taps(const float* const q[4],
                                          float r[4][9]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) load_record<C, PART>(q[j], r[j]);
}

// Normal-equation terms of an accepted sample: gx.gx, gx.gy, gy.gy,
// -e.gx, -e.gy.
struct Terms {
  float g00, g01, g11, b0, b1;
};

__device__ __forceinline__ Terms terms(const float s[9], const float e[3]) {
  const float* gx = s + 3;
  const float* gy = s + 6;
  return {dot3(gx, gx), dot3(gx, gy), dot3(gy, gy), -dot3(e, gx),
          -dot3(e, gy)};
}

template <int C>
__global__ void __launch_bounds__(128)
    iter_proj_kernel(const float* __restrict__ img,
                     const float* __restrict__ pts,
                     const float* __restrict__ p_init,
                     float* __restrict__ p_out, bool* __restrict__ conv_out,
                     int B, int H, int W, int N, int max_iter,
                     float lambda_init, float cost_thresh) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * N) return;
  const int b = (int)(i / N);
  const float* im = img + (long long)b * H * W * C;
  const float t[3] = {pts[i * 3 + 0], pts[i * 3 + 1], pts[i * 3 + 2]};
  const float umax = (float)W - 2.0f, vmax = (float)H - 2.0f;
  const long long row = (long long)W * C;

  float u_a = clip(p_init[i * 2 + 0], 1.0f, umax);
  float v_a = clip(p_init[i * 2 + 1], 1.0f, vmax);
  float u_t = u_a, v_t = v_a;
  Terms acc;
  {
    // the zero sample the plain version starts from
    const float s0[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float e0[3];
    ray_err(s0, t, e0);
    acc = terms(s0, e0);
  }
  float cost_a = CUDART_INF_F;
  float lam = lambda_init;
  bool conv = false;

  for (int it = 0; it <= max_iter; ++it) {
    const Corner k = corner(H, W, u_t, v_t);
    const float w[4] = {1.0f - k.du, k.du, 1.0f - k.dv, k.dv};
    const float* q00 = im + k.base * C;
    const float* q[4] = {q00, q00 + C, q00 + row, q00 + row + C};
    float r[4][9], s[9], e[3];
    load_taps<C, 0>(q, r);
    blend<0, 3>(r, w, s);
    ray_err(s, t, e);
    const float cost_t = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];

    const bool improved = cost_t < cost_a;
    if (improved) {
      // only an accepted sample's gradients are ever read: load and blend
      // them and form its terms here
      load_taps<C, 1>(q, r);
      blend<3, 9>(r, w, s);
      u_a = u_t;
      v_a = v_t;
      acc = terms(s, e);
    }
    cost_a = fminf(cost_t, cost_a);
    if (cost_t != cost_t || cost_a != cost_a) cost_a = CUDART_NAN_F;
    lam = improved ? lam * 0.1f : lam * 10.0f;
    conv = cost_a < cost_thresh;

    const float A00 = acc.g00 + lam;
    const float A01 = acc.g01;
    const float A11 = acc.g11 + lam;
    const float det = A00 * A11 - A01 * A01;
    const float det_inv = 1.0f / det;
    const float du = det_inv * (A11 * acc.b0 - A01 * acc.b1);
    const float dv = det_inv * (-A01 * acc.b0 + A00 * acc.b1);
    u_t = clip(u_a + du, 1.0f, umax);
    v_t = clip(v_a + dv, 1.0f, vmax);
  }
  p_out[i * 2 + 0] = u_a;
  p_out[i * 2 + 1] = v_a;
  conv_out[i] = conv;
}

// -- the first design ---------------------------------------------------------

__device__ __forceinline__ void sample_first(const float* __restrict__ img,
                                             int H, int W, float u, float v,
                                             float s[9]) {
  Corner k = corner(H, W, u, v);
  const float* q00 = img + k.base * 9;
  const float* q01 = q00 + 9;
  const float* q10 = q00 + (long long)W * 9;
  const float* q11 = q10 + 9;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    float top = q00[c] * (1.0f - k.du) + q01[c] * k.du;
    float bot = q10[c] * (1.0f - k.du) + q11[c] * k.du;
    s[c] = top * (1.0f - k.dv) + bot * k.dv;
  }
}

__global__ void iter_proj_first(const float* __restrict__ img,
                                const float* __restrict__ pts,
                                const float* __restrict__ p_init,
                                float* __restrict__ p_out,
                                bool* __restrict__ conv_out, int B, int H,
                                int W, int N, int max_iter,
                                float lambda_init, float cost_thresh) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * N) return;
  int b = (int)(i / N);
  const float* im = img + (long long)b * H * W * 9;
  float t[3] = {pts[i * 3 + 0], pts[i * 3 + 1], pts[i * 3 + 2]};
  const float umax = (float)W - 2.0f, vmax = (float)H - 2.0f;

  float u_a = clip(p_init[i * 2 + 0], 1.0f, umax);
  float v_a = clip(p_init[i * 2 + 1], 1.0f, vmax);
  float u_t = u_a, v_t = v_a;
  float s_a[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) s_a[c] = 0.0f;
  float cost_a = CUDART_INF_F;
  float lam = lambda_init;
  bool conv = false;

  for (int it = 0; it <= max_iter; ++it) {
    float s_t[9], e[3];
    sample_first(im, H, W, u_t, v_t, s_t);
    ray_err(s_t, t, e);
    float cost_t = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];

    bool improved = cost_t < cost_a;
    if (improved) {
      u_a = u_t;
      v_a = v_t;
#pragma unroll
      for (int c = 0; c < 9; ++c) s_a[c] = s_t[c];
    }
    cost_a = fminf(cost_t, cost_a);
    if (cost_t != cost_t || cost_a != cost_a) cost_a = CUDART_NAN_F;
    lam = improved ? lam * 0.1f : lam * 10.0f;
    conv = cost_a < cost_thresh;

    float eb[3];
    ray_err(s_a, t, eb);
    Terms g = terms(s_a, eb);
    float A00 = g.g00 + lam;
    float A01 = g.g01;
    float A11 = g.g11 + lam;
    float det = A00 * A11 - A01 * A01;
    float det_inv = 1.0f / det;
    float du = det_inv * (A11 * g.b0 - A01 * g.b1);
    float dv = det_inv * (-A01 * g.b0 + A00 * g.b1);
    u_t = clip(u_a + du, 1.0f, umax);
    v_t = clip(v_a + dv, 1.0f, vmax);
  }
  p_out[i * 2 + 0] = u_a;
  p_out[i * 2 + 1] = v_a;
  conv_out[i] = conv;
}

}  // namespace

// C: 9 or 12 floats a record. first != 0 runs the first design (C == 9
// only).
extern "C" int iter_proj_launch(const float* img, const float* pts,
                                const float* p_init, float* p_out,
                                bool* conv_out, int B, int H, int W, int N,
                                int C, int first, int max_iter,
                                float lambda_init, float cost_thresh,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)B * N;
  if (total <= 0) return 0;
  const bool aligned = ((uintptr_t)img & 15) == 0;
  if ((C != 9 && C != 12) || (C == 12 && !aligned) || (first && C != 9)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (first) {
    iter_proj_first<<<blocks, threads, 0, s>>>(
        img, pts, p_init, p_out, conv_out, B, H, W, N, max_iter, lambda_init,
        cost_thresh);
  } else if (C == 12) {
    iter_proj_kernel<12><<<blocks, threads, 0, s>>>(
        img, pts, p_init, p_out, conv_out, B, H, W, N, max_iter, lambda_init,
        cost_thresh);
  } else {
    iter_proj_kernel<9><<<blocks, threads, 0, s>>>(
        img, pts, p_init, p_out, conv_out, B, H, W, N, max_iter, lambda_init,
        cost_thresh);
  }
  return (int)cudaGetLastError();
}
