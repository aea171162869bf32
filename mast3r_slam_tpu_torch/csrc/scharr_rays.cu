// Scharr stencil, optionally fused with the per-pixel ray normalization.
//
// Replaces the Pallas kernel mast3r_slam_tpu/ops/pallas_gradient.py
// ::_scharr_kernel (the same function as ops/gradient.img_gradient, which
// ops/matching.prep_rays_grad calls on the matcher's main path).
//
// in:  (B, H, W, C) fp32, contiguous.
// out: (B, H, W, out_c) fp32. Per pixel, channels [gx_off, gx_off + C)
//      receive the x gradient, [gy_off, gy_off + C) the y gradient and, when
//      ray_off >= 0, [ray_off, ray_off + C) the (normalized) input.
// normalize != 0 (C == 3): every tap is L2-normalized first, so one launch
//      writes the (B, H, W, 9) [ray, gx, gy] image that iter_proj samples.
// Borders reflect by one pixel without repeating the edge (numpy "reflect").
//
// Bound on the H100: memory. At 384x512 the fused variant reads 2.4 MB and
// writes 7.1 MB; at 3.35 TB/s that is ~2.8 us, against ~0.3 MFLOP of
// arithmetic. Design: one thread per pixel, neighbouring threads on
// neighbouring pixels of a row so loads and stores coalesce; the eight
// neighbour reads hit L1/L2 (each input byte is fetched from DRAM about
// once). Normalizing the nine taps in each thread costs ~27 redundant
// sqrt/div per pixel, far below the memory time, and saves a second pass
// and the 2.4 MB round trip of a separate normalized image.
// The arithmetic keeps the plain version's operation order; the library is
// built with -fmad=false so no multiply-add is contracted and the kernel
// agrees with the plain PyTorch version to the last bit.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__global__ void scharr_kernel(const float* __restrict__ in,
                              float* __restrict__ out, int B, int H, int W,
                              int C, int out_c, int ray_off, int gx_off,
                              int gy_off, int normalize) {
  long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)B * H * W;
  if (pix >= total) return;
  int x = (int)(pix % W);
  int y = (int)((pix / W) % H);
  int b = (int)(pix / ((long long)W * H));
  const float* img = in + (long long)b * H * W * C;

  int xs[3] = {reflect(x - 1, W), x, reflect(x + 1, W)};
  int ys[3] = {reflect(y - 1, H), y, reflect(y + 1, H)};
  float* o = out + pix * out_c;

  if (normalize) {
    // C == 3: load and normalize the 3x3 taps
    float t[3][3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float* p = img + ((long long)ys[i] * W + xs[j]) * 3;
        float a = p[0], bb = p[1], c = p[2];
        float n = sqrtf(a * a + bb * bb + c * c);
        n = n > 1e-12f ? n : 1e-12f;
        t[i][j][0] = a / n;
        t[i][j][1] = bb / n;
        t[i][j][2] = c / n;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float gx = (1.0f / 32.0f) *
                 (3.0f * (t[0][2][c] - t[0][0][c]) +
                  10.0f * (t[1][2][c] - t[1][0][c]) +
                  3.0f * (t[2][2][c] - t[2][0][c]));
      float gy = (1.0f / 32.0f) *
                 (3.0f * (t[2][0][c] - t[0][0][c]) +
                  10.0f * (t[2][1][c] - t[0][1][c]) +
                  3.0f * (t[2][2][c] - t[0][2][c]));
      if (ray_off >= 0) o[ray_off + c] = t[1][1][c];
      o[gx_off + c] = gx;
      o[gy_off + c] = gy;
    }
    return;
  }

  for (int c = 0; c < C; ++c) {
#define TAP(i, j) img[((long long)ys[i] * W + xs[j]) * C + c]
    float gx = (1.0f / 32.0f) * (3.0f * (TAP(0, 2) - TAP(0, 0)) +
                                 10.0f * (TAP(1, 2) - TAP(1, 0)) +
                                 3.0f * (TAP(2, 2) - TAP(2, 0)));
    float gy = (1.0f / 32.0f) * (3.0f * (TAP(2, 0) - TAP(0, 0)) +
                                 10.0f * (TAP(2, 1) - TAP(0, 1)) +
                                 3.0f * (TAP(2, 2) - TAP(0, 2)));
    if (ray_off >= 0) o[ray_off + c] = TAP(1, 1);
#undef TAP
    o[gx_off + c] = gx;
    o[gy_off + c] = gy;
  }
}

}  // namespace

extern "C" int scharr_rays_launch(const float* in, float* out, int B, int H,
                                  int W, int C, int out_c, int ray_off,
                                  int gx_off, int gy_off, int normalize,
                                  void* stream) {
  long long total = (long long)B * H * W;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    scharr_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        in, out, B, H, W, C, out_c, ray_off, gx_off, gy_off, normalize);
  }
  return (int)cudaGetLastError();
}
