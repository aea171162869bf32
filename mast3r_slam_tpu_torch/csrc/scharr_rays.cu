// Scharr stencil, optionally fused with the per-pixel ray normalization.
//
// Replaces the Pallas kernel mast3r_slam_tpu/ops/pallas_gradient.py:31
// ::_scharr_kernel (the same function as ops/gradient.img_gradient, which
// ops/matching.prep_rays_grad calls on the matcher's main path).
//
// in:  (B, H, W, C) fp32, contiguous.
// out: (B, H, W, out_c) fp32. Per pixel, channels [gx_off, gx_off + C)
//      receive the x gradient, [gy_off, gy_off + C) the y gradient and, when
//      ray_off >= 0, [ray_off, ray_off + C) the (normalized) input.
// normalize != 0 (C == 3): every tap is L2-normalized first, so one launch
//      writes the [ray, gx, gy] image that iter_proj samples: out_c == 9, or
//      out_c == 12 with channels 9-11 zero (a 48-byte, 16-byte aligned pixel
//      record that iter_proj reads with vector loads).
// Borders reflect by one pixel without repeating the edge (numpy "reflect").
//
// Bound on the H100: memory. At 384x512 the fused variant reads 2.4 MB and
// writes 7.1 MB (9.4 MB padded); at 3.35 TB/s that is 2.8 us, against 0.3
// MFLOP of arithmetic.
//
// Two kernels:
// * scharr_tiled (normalize, C == 3; the matcher's path). A block owns a
//   TX x TY = 32 x 8 tile of output pixels. It copies the tile's input rows plus a
//   reflected one-pixel halo into shared memory (16-byte vector loads of
//   the row's floats where the rows are 16-byte aligned, else coalesced
//   scalar loads: every input float is read once), normalizes each pixel
//   there once, runs the stencil from shared memory, stages the output tile
//   in shared memory and writes each output row with 16-byte vector stores
//   (a tile whose x-origin is a multiple of 4 pixels starts 16-byte aligned
//   in both layouts: 4 x 36 B = 9 x 16 B). This removes what held the
//   per-pixel design back: 27 scalar loads a thread at a 12-byte stride (each
//   input byte asked for nine times through L1), nine normalizations a pixel
//   (9 sqrt and 27 IEEE divides, eight ninths of them repeated by the
//   neighbours), and nine scalar stores a thread at a 36-byte stride. A 64 x
//   4 tile was measured 5-6% slower (PERF.md); the block is held to 64
//   registers, as left to itself
//   ptxas gives it 93 and only two blocks fit a multiprocessor. What remains
//   is mostly the launch and the serial load -> normalize -> stencil ->
//   store chain of one wave of blocks, not the bytes.
// * scharr_per_pixel: one thread per pixel, the taps read from global
//   memory. It serves the plain-stencil mode (no normalization, any C) and,
//   with normalize, is the first design of the fused stencil, which
//   chip_smoke.py times as the yardstick of the tiled one.
//
// The arithmetic keeps the plain version's operation order, the norm is
// clamped as torch.clamp clamps (a NaN norm stays NaN), and the library is
// built with -fmad=false, so no multiply-add is contracted and both kernels
// agree with the plain PyTorch version to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// reflected index, clamped into the image for positions past a ragged
// tile's edge (their values are never stored)
__device__ __forceinline__ int src_index(int i, int n) {
  int r = reflect(i, n);
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

// x / max(|x|, 1e-12) in l2_normalize's order; a NaN norm propagates
__device__ __forceinline__ void normalize3(float& a, float& b, float& c) {
  float n = sqrtf(a * a + b * b + c * c);
  n = n < 1e-12f ? 1e-12f : n;
  a = a / n;
  b = b / n;
  c = c / n;
}

__device__ __forceinline__ float scharr_x(float a02, float a00, float a12,
                                          float a10, float a22, float a20) {
  return (1.0f / 32.0f) *
         (3.0f * (a02 - a00) + 10.0f * (a12 - a10) + 3.0f * (a22 - a20));
}

__device__ __forceinline__ float scharr_y(float a20, float a00, float a21,
                                          float a01, float a22, float a02) {
  return (1.0f / 32.0f) *
         (3.0f * (a20 - a00) + 10.0f * (a21 - a01) + 3.0f * (a22 - a02));
}

__global__ void scharr_per_pixel(const float* __restrict__ in,
                                 float* __restrict__ out, int B, int H,
                                 int W, int C, int out_c, int ray_off,
                                 int gx_off, int gy_off, int normalize) {
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
        t[i][j][0] = p[0];
        t[i][j][1] = p[1];
        t[i][j][2] = p[2];
        normalize3(t[i][j][0], t[i][j][1], t[i][j][2]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (ray_off >= 0) o[ray_off + c] = t[1][1][c];
      o[gx_off + c] = scharr_x(t[0][2][c], t[0][0][c], t[1][2][c],
                               t[1][0][c], t[2][2][c], t[2][0][c]);
      o[gy_off + c] = scharr_y(t[2][0][c], t[0][0][c], t[2][1][c],
                               t[0][1][c], t[2][2][c], t[0][2][c]);
    }
    return;
  }

  for (int c = 0; c < C; ++c) {
#define TAP(i, j) img[((long long)ys[i] * W + xs[j]) * C + c]
    if (ray_off >= 0) o[ray_off + c] = TAP(1, 1);
    o[gx_off + c] = scharr_x(TAP(0, 2), TAP(0, 0), TAP(1, 2), TAP(1, 0),
                             TAP(2, 2), TAP(2, 0));
    o[gy_off + c] = scharr_y(TAP(2, 0), TAP(0, 0), TAP(2, 1), TAP(0, 1),
                             TAP(2, 2), TAP(0, 2));
#undef TAP
  }
}

// The output tile of the fused kernel: TX x TY pixels a block.
constexpr int TX = 32, TY = 8;
static_assert(TX % 4 == 0, "tile width must be a multiple of 4 pixels");

// Shared-memory row of the input tile: pixel column c in [-1, TX] at float
// 4 + 3c, so the TX interior pixels start 16-byte aligned at float 4.
constexpr int RS = 3 * TX + 8;
__device__ __forceinline__ int tile_at(int c) { return 4 + 3 * c; }

// at least 1,024 threads a multiprocessor: at most 64 registers, no spills
template <int OUT_C>
__global__ void __launch_bounds__(TX * TY, 1024 / (TX * TY))
    scharr_tiled(const float* __restrict__ in, float* __restrict__ out,
                 int B, int H, int W) {
  static_assert(OUT_C == 9 || OUT_C == 12, "record of 9 or 12 floats");
  constexpr int NT = TX * TY;
  constexpr int ROWS = TY + 2;
  constexpr int RUN = 3 * TX;             // interior floats of a tile row
  constexpr int OUT_ROW = TX * OUT_C;     // output floats of a tile row
  __shared__ __align__(16) float tile[ROWS * RS];
  __shared__ __align__(16) float stage[TY * OUT_ROW];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const bool full = x0 + TX <= W;
  const bool vec_in = full && W % 4 == 0 && ((uintptr_t)in & 15) == 0;
  const bool vec_out =
      full && (W * OUT_C) % 4 == 0 && ((uintptr_t)out & 15) == 0;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* img = in + (long long)b * H * W * 3;
    // 1. the tile's input rows and the reflected halo, each float once
    if (vec_in) {
      constexpr int V = RUN / 4;
      for (int i = tid; i < ROWS * V; i += NT) {
        int r = i / V, k = i - r * V;
        int ys = src_index(y0 - 1 + r, H);
        float4 v = reinterpret_cast<const float4*>(
            img + ((long long)ys * W + x0) * 3)[k];
        *reinterpret_cast<float4*>(&tile[r * RS + 4 + 4 * k]) = v;
      }
    } else {
      for (int i = tid; i < ROWS * RUN; i += NT) {
        int r = i / RUN, k = i - r * RUN;
        int ys = src_index(y0 - 1 + r, H);
        int xs = src_index(x0 + k / 3, W);
        tile[r * RS + 4 + k] = img[((long long)ys * W + xs) * 3 + k % 3];
      }
    }
    for (int i = tid; i < ROWS * 6; i += NT) {
      int r = i / 6, side = (i / 3) & 1, k = i % 3;
      int c = side ? TX : -1;
      int ys = src_index(y0 - 1 + r, H);
      int xs = src_index(x0 + c, W);
      tile[r * RS + tile_at(c) + k] =
          img[((long long)ys * W + xs) * 3 + k];
    }
    __syncthreads();

    // 2. normalize every pixel of the tile once
    for (int p = tid; p < ROWS * (TX + 2); p += NT) {
      int r = p / (TX + 2), c = p - r * (TX + 2) - 1;
      float* q = &tile[r * RS + tile_at(c)];
      float a = q[0], bb = q[1], cc = q[2];
      normalize3(a, bb, cc);
      q[0] = a;
      q[1] = bb;
      q[2] = cc;
    }
    __syncthreads();

    // 3. the stencil from shared memory; the record staged in shared memory
    {
      const int tx = tid % TX, ty = tid / TX;
      const float* t0 = &tile[ty * RS + tile_at(tx - 1)];
      const float* t1 = t0 + RS;
      const float* t2 = t1 + RS;
      float rec[OUT_C];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        rec[c] = t1[3 + c];
        rec[3 + c] = scharr_x(t0[6 + c], t0[c], t1[6 + c], t1[c], t2[6 + c],
                              t2[c]);
        rec[6 + c] = scharr_y(t2[c], t0[c], t2[3 + c], t0[3 + c], t2[6 + c],
                              t0[6 + c]);
      }
      float* o = &stage[tid * OUT_C];
      if constexpr (OUT_C == 12) {
        // three 16-byte stores: a quarter-warp's 48-byte records fall on
        // distinct banks
        float4* o4 = reinterpret_cast<float4*>(o);
        o4[0] = make_float4(rec[0], rec[1], rec[2], rec[3]);
        o4[1] = make_float4(rec[4], rec[5], rec[6], rec[7]);
        o4[2] = make_float4(rec[8], 0.0f, 0.0f, 0.0f);
      } else {
#pragma unroll
        for (int k = 0; k < OUT_C; ++k) o[k] = rec[k];   // stride 9: no conflict
      }
    }
    __syncthreads();

    // 4. each output row of the tile, contiguous in global memory
    float* dst = out + ((long long)b * H * W) * OUT_C;
    if (vec_out) {
      constexpr int VQ = OUT_ROW / 4;
      for (int i = tid; i < TY * VQ; i += NT) {
        int r = i / VQ, k = i - r * VQ;
        int y = y0 + r;
        if (y < H) {
          reinterpret_cast<float4*>(dst + ((long long)y * W + x0) * OUT_C)[k] =
              reinterpret_cast<const float4*>(stage)[i];
        }
      }
    } else {
      for (int i = tid; i < TY * OUT_ROW; i += NT) {
        int r = i / OUT_ROW, k = i - r * OUT_ROW;
        int y = y0 + r, x = x0 + k / OUT_C;
        if (y < H && x < W) {
          dst[((long long)y * W + x0) * OUT_C + k] = stage[i];
        }
      }
    }
    __syncthreads();    // the next batch row reuses both tiles
  }
}

}  // namespace

// tiled != 0 runs the tiled kernel (normalize, C == 3, the [ray, gx, gy]
// record of out_c 9 or 12); 0 the per-pixel kernel (the only one without
// normalization).
extern "C" int scharr_rays_launch(const float* in, float* out, int B, int H,
                                  int W, int C, int out_c, int ray_off,
                                  int gx_off, int gy_off, int normalize,
                                  int tiled, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (tiled) {
    if (!normalize || C != 3 || (out_c != 9 && out_c != 12) || ray_off != 0 ||
        gx_off != 3 || gy_off != 6) {
      return (int)cudaErrorInvalidValue;
    }
    dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B < 65535 ? B : 65535);
    if (out_c == 12) {
      scharr_tiled<12><<<grid, TX * TY, 0, s>>>(in, out, B, H, W);
    } else {
      scharr_tiled<9><<<grid, TX * TY, 0, s>>>(in, out, B, H, W);
    }
    return (int)cudaGetLastError();
  }
  long long total = (long long)B * H * W;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  scharr_per_pixel<<<blocks, threads, 0, s>>>(in, out, B, H, W, C, out_c,
                                              ray_off, gx_off, gy_off,
                                              normalize);
  return (int)cudaGetLastError();
}
