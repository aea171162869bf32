// Coarse-to-fine dilated descriptor window search.
//
// Replaces mast3r_slam_tpu/ops/matching.py::refine_matches (:189-231),
// shipped in the JAX package as ops/window_gather.py
// ::refine_matches_full_unfold (:183). The JAX package kept it in XLA (the
// TPU compiler crashed on its dynamic gathers); the original system ran it
// as a CUDA kernel. The TPU layout tricks (phase-decimated full-window
// unfolds) are not carried over: each thread reads its window straight
// from the descriptor image.
//
// D11: (B, H, W, F) bf16 (as uint16 bits) or int8 descriptor image.
// D21: (B, N, F) query descriptors of the same type.
// p1:  (B, N, 2) int32 start pixels (u, v); out: (B, N, 2) int32.
//
// For d = dilation_max .. 1: score the (2r+1)^2 candidates
// (u0 + (j - r) d, v0 + (i - r) d), u fastest, by a dot product of the
// descriptors in fp32 (bf16 and int8 products are exact in fp32; the sum
// runs over f in order, as in the plain version); candidates outside the
// image score -inf; the FIRST maximum wins (argmax semantics, a NaN score
// counts as the maximum); the new centre is clamped into the image.
//
// Bound on the H100: memory. Per point the search reads the query (F
// values) and (2r+1)^2 candidate rows per level; the descriptor image
// (384x512x24 bf16 = 9.4 MB) stays in L2, so DRAM traffic is about one
// pass over D11, D21, p1 and the output. Design: one thread per query
// point, the query descriptor in registers (F is a template parameter),
// the running best in registers; neighbouring threads hold neighbouring
// query pixels whose windows overlap, so a warp's candidate reads share
// L1/L2 lines. Built with -fmad=false.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(uint16_t bits) {
  return __uint_as_float(((unsigned)bits) << 16);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename T, int F>
__global__ void refine_kernel(const T* __restrict__ D11,
                              const T* __restrict__ D21,
                              const int* __restrict__ p1,
                              int* __restrict__ out, int B, int H, int W,
                              int N, int radius, int dilation_max) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * N) return;
  int b = (int)(i / N);
  const T* img = D11 + (long long)b * H * W * F;
  float q[F];
#pragma unroll
  for (int c = 0; c < F; ++c) q[c] = to_f32(D21[i * F + c]);
  int u0 = p1[i * 2 + 0];
  int v0 = p1[i * 2 + 1];
  int k = 2 * radius + 1;

  for (int d = dilation_max; d >= 1; --d) {
    float best = -CUDART_INF_F;
    bool best_nan = false;
    int bi = 0, bj = 0;
    for (int ii = 0; ii < k; ++ii) {
      int v = v0 + (ii - radius) * d;
      for (int jj = 0; jj < k; ++jj) {
        int u = u0 + (jj - radius) * d;
        float s;
        if (u >= 0 && u < W && v >= 0 && v < H) {
          const T* row = img + ((long long)v * W + u) * F;
          s = 0.0f;
#pragma unroll
          for (int c = 0; c < F; ++c) s = s + to_f32(row[c]) * q[c];
        } else {
          s = -CUDART_INF_F;
        }
        if (best_nan) continue;
        if (s != s) {
          best_nan = true;
          bi = ii;
          bj = jj;
        } else if (s > best) {
          best = s;
          bi = ii;
          bj = jj;
        }
      }
    }
    int un = u0 + (bj - radius) * d;
    int vn = v0 + (bi - radius) * d;
    u0 = un < 0 ? 0 : (un > W - 1 ? W - 1 : un);
    v0 = vn < 0 ? 0 : (vn > H - 1 ? H - 1 : vn);
  }
  out[i * 2 + 0] = u0;
  out[i * 2 + 1] = v0;
}

template <typename T>
int launch_typed(const void* D11, const void* D21, const int* p1, int* out,
                 int B, int H, int W, int N, int F, int radius,
                 int dilation_max, cudaStream_t stream) {
  long long total = (long long)B * N;
  int threads = 128;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks == 0) return (int)cudaGetLastError();
  const T* a = (const T*)D11;
  const T* q = (const T*)D21;
#define LAUNCH(FF)                                                      \
  refine_kernel<T, FF><<<blocks, threads, 0, stream>>>(                 \
      a, q, p1, out, B, H, W, N, radius, dilation_max)
  switch (F) {
    case 8: LAUNCH(8); break;
    case 16: LAUNCH(16); break;
    case 24: LAUNCH(24); break;
    case 32: LAUNCH(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int refine_matches_launch(const void* D11, const void* D21,
                                     const int* p1, int* out, int B, int H,
                                     int W, int N, int F, int radius,
                                     int dilation_max, int is_int8,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_int8)
    return launch_typed<int8_t>(D11, D21, p1, out, B, H, W, N, F, radius,
                                dilation_max, s);
  return launch_typed<uint16_t>(D11, D21, p1, out, B, H, W, N, F, radius,
                                dilation_max, s);
}
