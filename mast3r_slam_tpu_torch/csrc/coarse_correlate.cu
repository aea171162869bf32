// Coarse descriptor correlation with a fused row argmax.
//
// Replaces mast3r_slam_tpu/ops/dense_matcher.py::coarse_correlate (:37): for
// every query row, the argmax over the coarse cells of the dot product with
// the stride-subsampled target descriptors, then the cell's center pixel as
// a full-resolution linear index (:76-80). The JAX package computes it as a
// tiled bf16 matrix product plus argmax in XLA and pays for the (rows x
// cells) score matrix in device memory; this kernel never writes it.
//
// D21 (b, n, F) bf16 queries; D11 (b, h, w, F) bf16 target image, read in
// place at every stride-th row and column (hc x wc cells); out (b, n) int32.
//
// Semantics kept from the JAX function:
//  * the score is the fp32 sum over the F features in order (products of two
//    bf16 values are exact in fp32), rounded to bf16 BEFORE the comparison
//    (preferred_element_type=bfloat16, :68-69), so ties are bf16 ties;
//  * argmax takes the first maximum in cell order and treats NaN as the
//    maximum (the first NaN wins), as jnp.argmax does;
//  * cell -> pixel: u = min(uc * stride + stride / 2, w - 1), same for v.
// The plain PyTorch version sums in the same order, so the two agree to the
// bit.
//
// Bound on the H100: operations (2 * n * cells * F per batch item; the bytes
// are the descriptors once, a few MB). This first version runs on the CUDA
// cores in fp32, not on the tensor cores. Design: a block owns 64 query rows
// (two per lane, kept in registers as fp32) and streams the cells through
// shared memory in tiles of 256; each of its 8 warps scans its own 32 cells
// of a tile, reading a cell as three broadcast 16-byte loads, and keeps a
// running (best score, lowest index) per row; the 8 partial winners of a row
// are merged through shared memory at the end. The cell descriptors (48
// bytes each, 590 KB per batch item at 96 x 128 cells) stay in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int R = 2;                 // query rows per lane
constexpr int ROWS = 32 * R;         // query rows per block
constexpr int TILE = 32 * WARPS;     // cells per shared-memory tile
constexpr int NO_IDX = 0x7fffffff;

struct Best {
  float score;    // bf16-rounded, as fp32; NaN once a NaN was seen
  int idx;
};

// a candidate replaces the running best if it is the first NaN, or larger
// (never on equality: the first maximum wins)
__device__ __forceinline__ void update(Best& b, float s, int idx) {
  if (b.score != b.score) return;              // a NaN already won
  if (s != s || s > b.score) {
    b.score = s;
    b.idx = idx;
  }
}

// merge the winner of a later or interleaved cell range: NaN beats numbers,
// larger beats smaller, equal scores go to the lower index
__device__ __forceinline__ void merge(Best& b, float s, int idx) {
  bool bn = b.score != b.score, sn = s != s;
  bool take;
  if (bn || sn) {
    take = sn && (!bn || idx < b.idx);
  } else {
    take = s > b.score || (s == b.score && idx < b.idx);
  }
  if (take) {
    b.score = s;
    b.idx = idx;
  }
}

__device__ __forceinline__ float bf16_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

template <int F>
__global__ void __launch_bounds__(THREADS)
coarse_correlate_kernel(const __nv_bfloat16* __restrict__ D21,
                        const __nv_bfloat16* __restrict__ D11,
                        int* __restrict__ out, int n, int h, int w, int hc,
                        int wc, int stride) {
  constexpr int PARTS = F / 8;       // 16-byte pieces of a descriptor
  __shared__ uint4 tile[TILE * PARTS];
  __shared__ float s_score[WARPS][ROWS];
  __shared__ int s_idx[WARPS][ROWS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bi = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int nc = hc * wc;

  // this lane's query rows, as fp32
  float q[R][F];
  Best best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int row = row0 + r * 32 + lane;
    best[r].score = __int_as_float(0xff800000);   // -inf
    best[r].idx = NO_IDX;
    const uint4* src =
        (const uint4*)(D21 + ((long long)bi * n + (row < n ? row : 0)) * F);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      uint4 v = src[p];
      q[r][8 * p + 0] = bf16_lo(v.x);
      q[r][8 * p + 1] = bf16_hi(v.x);
      q[r][8 * p + 2] = bf16_lo(v.y);
      q[r][8 * p + 3] = bf16_hi(v.y);
      q[r][8 * p + 4] = bf16_lo(v.z);
      q[r][8 * p + 5] = bf16_hi(v.z);
      q[r][8 * p + 6] = bf16_lo(v.w);
      q[r][8 * p + 7] = bf16_hi(v.w);
    }
  }

  const __nv_bfloat16* img = D11 + (long long)bi * h * w * F;
  for (int t0 = 0; t0 < nc; t0 += TILE) {
    // stage TILE cells: thread -> one 16-byte piece at a time
    for (int i = tid; i < TILE * PARTS; i += THREADS) {
      int cell = t0 + i / PARTS;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (cell < nc) {
        int vc = cell / wc, uc = cell - vc * wc;
        const uint4* src = (const uint4*)(
            img + ((long long)(vc * stride) * w + uc * stride) * F);
        v = src[i % PARTS];
      }
      tile[i] = v;
    }
    __syncthreads();

    const int c0 = warp * 32;
    const int c1 = min(32, nc - t0 - c0);       // uniform in the warp
    for (int c = 0; c < c1; ++c) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        uint4 v = tile[(c0 + c) * PARTS + p];   // broadcast read
        float d[8] = {bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y),
                      bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w), bf16_hi(v.w)};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r] = __fadd_rn(acc[r], __fmul_rn(q[r][8 * p + k], d[k]));
          }
        }
      }
      const int cell = t0 + c0 + c;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = __bfloat162float(__float2bfloat16_rn(acc[r]));
        update(best[r], s, cell);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    s_score[warp][r * 32 + lane] = best[r].score;
    s_idx[warp][r * 32 + lane] = best[r].idx;
  }
  __syncthreads();
  if (tid < ROWS) {
    // tid = r * 32 + lane  <->  row0 + r * 32 + lane
    int row = row0 + tid;
    if (row < n) {
      Best b{s_score[0][tid], s_idx[0][tid]};
      for (int wv = 1; wv < WARPS; ++wv) {
        merge(b, s_score[wv][tid], s_idx[wv][tid]);
      }
      int cell = b.idx == NO_IDX ? 0 : b.idx;   // every score was -inf
      int vc = cell / wc, uc = cell - vc * wc;
      int u = min(uc * stride + stride / 2, w - 1);
      int v = min(vc * stride + stride / 2, h - 1);
      out[(long long)bi * n + row] = v * w + u;
    }
  }
}

}  // namespace

extern "C" int coarse_correlate_launch(const void* D21, const void* D11,
                                       int* out, int b, int n, int h, int w,
                                       int f, int stride, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b == 0 || n == 0) return (int)cudaGetLastError();
  const int hc = (h + stride - 1) / stride, wc = (w + stride - 1) / stride;
  dim3 grid((n + ROWS - 1) / ROWS, b);
  const __nv_bfloat16* q = (const __nv_bfloat16*)D21;
  const __nv_bfloat16* t = (const __nv_bfloat16*)D11;
  switch (f) {
    case 8:
      coarse_correlate_kernel<8><<<grid, THREADS, 0, st>>>(q, t, out, n, h, w,
                                                           hc, wc, stride);
      break;
    case 16:
      coarse_correlate_kernel<16><<<grid, THREADS, 0, st>>>(q, t, out, n, h,
                                                            w, hc, wc, stride);
      break;
    case 24:
      coarse_correlate_kernel<24><<<grid, THREADS, 0, st>>>(q, t, out, n, h,
                                                            w, hc, wc, stride);
      break;
    case 32:
      coarse_correlate_kernel<32><<<grid, THREADS, 0, st>>>(q, t, out, n, h,
                                                            w, hc, wc, stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
