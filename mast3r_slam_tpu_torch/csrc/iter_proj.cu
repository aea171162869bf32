// Per-point 2-DoF Levenberg-Marquardt ray projection.
//
// Replaces mast3r_slam_tpu/ops/matching.py::iter_proj (:117-186), which the
// JAX package kept in XLA (the TPU compiler crashed on its dynamic
// gathers); the original system ran it as a CUDA kernel too.
//
// img:    (B, H, W, 9) fp32 [ray(3), d ray/du (3), d ray/dv (3)].
// pts:    (B, N, 3) fp32 unit target directions.
// p_init: (B, N, 2) fp32 initial pixel positions.
// p_out:  (B, N, 2) fp32 refined positions; conv_out: (B, N) bool.
//
// The trajectory is the JAX one exactly: max_iter + 1 evaluations; the
// sample of the last ACCEPTED point is carried, so each iteration samples
// only the trial point; the first evaluation accepts the (clamped) init
// point against cost = inf; lambda x0.1 on acceptance, x10 otherwise;
// converged = cost < thresh from each iteration's best cost; det is not
// guarded (1/det may be inf, as in JAX). Clamps propagate NaN like
// jnp.clip; a NaN coordinate reads a clamped address and yields a NaN
// sample, so it is never accepted.
//
// Bound on the H100: memory latency of the dependent bilinear gathers.
// Bytes: each point reads 20 B and writes 9 B, plus 4 x 36 B of corner
// taps per evaluation from an image that (7.1 MB) stays in the 50 MB L2.
// Arithmetic is ~100 FLOP per evaluation. Design: one thread per point,
// the LM state in registers; consecutive threads hold neighbouring query
// pixels, whose samples land on neighbouring image rows, so the tap reads
// of a warp share cache lines. Built with -fmad=false to keep the plain
// version's rounding.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  // NaN passes through, like jnp.clip / torch.clamp
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void sample(const float* __restrict__ img, int H,
                                       int W, float u, float v, float s[9]) {
  float u11 = floorf(u);
  float v11 = floorf(v);
  float du = u - u11;
  float dv = v - v11;
  int iu = (int)u11;
  int iv = (int)v11;
  // memory safety only: in-range coordinates never trip these
  iu = iu < 0 ? 0 : (iu > W - 2 ? W - 2 : iu);
  iv = iv < 0 ? 0 : (iv > H - 2 ? H - 2 : iv);
  if (!(u11 == u11)) iu = 0;
  if (!(v11 == v11)) iv = 0;
  const float* q00 = img + ((long long)iv * W + iu) * 9;
  const float* q01 = q00 + 9;
  const float* q10 = q00 + (long long)W * 9;
  const float* q11 = q10 + 9;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    float top = q00[c] * (1.0f - du) + q01[c] * du;
    float bot = q10[c] * (1.0f - du) + q11[c] * du;
    s[c] = top * (1.0f - dv) + bot * dv;
  }
}

__device__ __forceinline__ void ray_err(const float s[9], const float t[3],
                                        float e[3]) {
  float n = sqrtf(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
  n = n > 1e-12f ? n : 1e-12f;
  e[0] = s[0] / n - t[0];
  e[1] = s[1] / n - t[1];
  e[2] = s[2] / n - t[2];
}

__global__ void iter_proj_kernel(const float* __restrict__ img,
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
    sample(im, H, W, u_t, v_t, s_t);
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
    const float* gx = s_a + 3;
    const float* gy = s_a + 6;
    float A00 = (gx[0] * gx[0] + gx[1] * gx[1] + gx[2] * gx[2]) + lam;
    float A01 = gx[0] * gy[0] + gx[1] * gy[1] + gx[2] * gy[2];
    float A11 = (gy[0] * gy[0] + gy[1] * gy[1] + gy[2] * gy[2]) + lam;
    float b0 = -(eb[0] * gx[0] + eb[1] * gx[1] + eb[2] * gx[2]);
    float b1 = -(eb[0] * gy[0] + eb[1] * gy[1] + eb[2] * gy[2]);
    float det = A00 * A11 - A01 * A01;
    float det_inv = 1.0f / det;
    float du = det_inv * (A11 * b0 - A01 * b1);
    float dv = det_inv * (-A01 * b0 + A00 * b1);
    u_t = clip(u_a + du, 1.0f, umax);
    v_t = clip(v_a + dv, 1.0f, vmax);
  }
  p_out[i * 2 + 0] = u_a;
  p_out[i * 2 + 1] = v_a;
  conv_out[i] = conv;
}

}  // namespace

extern "C" int iter_proj_launch(const float* img, const float* pts,
                                const float* p_init, float* p_out,
                                bool* conv_out, int B, int H, int W, int N,
                                int max_iter, float lambda_init,
                                float cost_thresh, void* stream) {
  long long total = (long long)B * N;
  int threads = 128;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    iter_proj_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        img, pts, p_init, p_out, conv_out, B, H, W, N, max_iter, lambda_init,
        cost_thresh);
  }
  return (int)cudaGetLastError();
}
