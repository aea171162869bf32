// Coarse descriptor correlation with a fused row argmax, on the tensor
// cores.
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
//  * the score is the fp32 sum of the F exact products, rounded to bf16
//    BEFORE the comparison (preferred_element_type=bfloat16, :68-69), so
//    ties are bf16 ties;
//  * argmax takes the first maximum in cell order and treats NaN as the
//    maximum (the first NaN wins), as jnp.argmax does;
//  * cell -> pixel: u = min(uc * stride + stride / 2, w - 1), same for v.
// The tensor cores add the products in an order of their own (as XLA's
// product does), so a score can land one bf16 step from the plain PyTorch
// version's and an index can differ where that flips a tie;
// ops/dense_matcher.py::check_coarse_correlate states the rule both are
// held to.
//
// Bound on the H100: operations (2 * n * cells * F per batch item; the
// bytes are the descriptors once, a few MB). The product itself is cheap on
// the tensor cores; what sets the pace is the work per score on the CUDA
// cores, whose compare and min/max instructions run at half the fp32 rate,
// and the stream of all cells from L2 into every block. Design:
//  * wgmma.mma_async m64n64k16, bf16 with fp32 accumulation. A warpgroup
//    owns 64 query rows and keeps them as A fragments in registers for the
//    whole kernel (K padded to a multiple of 16 with zero registers); B is
//    read from shared memory through a matrix descriptor. A block is 3
//    warpgroups, 192 rows: 128 blocks at 12,288 rows x 2 and 512 at 49,152
//    x 2 fill 132 multiprocessors to 97%, one block each;
//  * the cells of D11[:, ::stride, ::stride] are read in place, 48 bytes
//    each, with cp.async into a ring of tiles, so the next tiles load while
//    this one is multiplied. A tile has the layout wgmma reads without
//    swizzling: groups of 8 cells, each group one 128-byte core matrix (8
//    cells x 8 features) per chunk of 8 features; the chunks that pad K
//    are zeroed once and never written again;
//  * inside a tile the product of the next 64 cells runs while the CUDA
//    cores work through this one's 32 accumulators a thread (two sets);
//  * two sweeps over the cells instead of one that keeps an index per
//    score. Sweep 1 keeps only a running fp32 maximum (rounding to bf16 is
//    monotonic: the maximum of the rounded scores is the rounded maximum),
//    one max.NaN.f32 a score. Sweep 2 repeats the product (same
//    instructions, same bits) and compares every score with a per-row fp32
//    threshold, one compare a score and no rounding; only the rare score
//    that passes branches to record its cell, the lowest cell wins. A row
//    belongs to one warp, so the merges are two shuffles in a quad.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WGS = 3;                     // warpgroups a block, 64 rows each
constexpr int THREADS = 128 * WGS;
constexpr int ROWS = 64 * WGS;             // query rows of a block
constexpr int SUBS = 8;                    // 64-cell sub-tiles per ring tile
constexpr int TILE = 64 * SUBS;            // cells per tile of the ring
constexpr int STAGES = 3;
static_assert(STAGES >= 2, "a tile loads while another is multiplied");
constexpr int NO_IDX = 0x7fffffff;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// makes this thread's shared-memory writes visible to the tensor cores
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// the accumulators are written behind the compiler's back: pin every read
// of them after this point
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 rows x 64 cells, fp32) = or += A (registers, 64 x 16 bf16) x B
// (shared memory, 16 x 64 bf16 through its descriptor, K-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const unsigned* a,
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// max that keeps NaN (fmaxf would drop it): max.NaN.f32
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// greater or unordered: true for s > t, and when either is NaN
__device__ __forceinline__ bool above(float s, float t) { return !(s <= t); }

// The threshold of sweep 2 for a row whose fp32 maximum is m: above(score,
// threshold) holds exactly for the scores that round to the same bf16 value
// as m, the row's maximum after rounding, without rounding any of them.
// That is every score from the midpoint between that bf16 value and the
// next lower one upwards; the midpoint itself rounds to whichever of the two
// has an even mantissa. +inf when the maximum is NaN (only NaN is unordered
// with +inf) and NaN when every score is -inf (every cell passes, the first
// wins).
__device__ __forceinline__ float threshold(float m) {
  if (m != m) return CUDART_INF_F;
  const unsigned x = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(m));
  if (x == 0xff80u) return CUDART_NAN_F;
  const unsigned mag = x & 0x7fffu;
  const bool below_zero = (x & 0x8000u) != 0u || mag == 0u;   // midpoint < 0
  // fp32 bits of the midpoint: halfway between magnitudes mag - 1 and mag
  // above zero, mag and mag + 1 below (mag = 0: between -tiny and 0)
  unsigned mid = below_zero ? (0x80000000u | ((mag << 16) + 0x8000u))
                            : (((mag - 1u) << 16) + 0x8000u);
  if ((x & 1u) == 0u) {            // the midpoint rounds up to the maximum:
    mid = below_zero ? mid + 1u : mid - 1u;   // one fp32 step lower passes
  }
  return __uint_as_float(mid);
}

template <int F>
__global__ void __launch_bounds__(THREADS, 1)
coarse_correlate_kernel(const __nv_bfloat16* __restrict__ D21,
                        const __nv_bfloat16* __restrict__ D11,
                        int* __restrict__ out, int n, int h, int w, int hc,
                        int wc, unsigned wc_magic, int stride) {
  constexpr int PARTS = F / 8;               // 16-byte pieces of a descriptor
  constexpr int KS = (F + 15) / 16;          // k16 steps, K padded with zeros
  constexpr int CH = 2 * KS;                 // 16-byte chunks per padded cell
  // a tile holds TILE / 8 groups of 8 cells; a group is CH core matrices
  // (8 cells x 16 bytes, 128 bytes), one per chunk of 8 features
  constexpr int GROUP_BYTES = CH * 128;
  constexpr int STAGE_BYTES = (TILE / 8) * GROUP_BYTES;
  constexpr uint64_t DESC_HI =
      ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(GROUP_BYTES >> 4) << 32);

  extern __shared__ uint4 ring_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(ring_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bi = blockIdx.y;
  const int row_lo = blockIdx.x * ROWS + warp * 16 + g;   // and row_lo + 8
  const int nc = hc * wc;
  const int ntiles = (nc + TILE - 1) / TILE;

  // the padding chunks stay zero for the whole kernel
  for (int i = tid; i < STAGES * STAGE_BYTES / 16; i += THREADS) {
    ring_raw[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // A fragments: rows row_lo and row_lo + 8, K padded with zeros
  unsigned a[KS][4];
  {
    const int r0 = row_lo < n ? row_lo : 0;        // rows past the end: any
    const int r1 = row_lo + 8 < n ? row_lo + 8 : 0;   // row, never written
    const unsigned* lo =
        reinterpret_cast<const unsigned*>(D21 + ((long long)bi * n + r0) * F);
    const unsigned* hi =
        reinterpret_cast<const unsigned*>(D21 + ((long long)bi * n + r1) * F);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      a[s][0] = lo[8 * s + tq];
      a[s][1] = hi[8 * s + tq];
      const bool upper = 16 * s + 8 < F;     // features 16 s + 8 .. + 15
      a[s][2] = upper ? lo[8 * s + 4 + tq] : 0u;
      a[s][3] = upper ? hi[8 * s + 4 + tq] : 0u;
    }
  }
  __syncthreads();                           // zero fill before the copies

  const __nv_bfloat16* img = D11 + (long long)bi * h * w * F;

  auto stage = [&](int t) {
    if (t < ntiles) {
      unsigned char* slot = ring + (t % STAGES) * STAGE_BYTES;
      for (int piece = tid; piece < TILE * PARTS; piece += THREADS) {
        const int in_tile = piece / PARTS;
        const int p = piece - in_tile * PARTS;
        const int cell = t * TILE + in_tile;
        uint4* dst = reinterpret_cast<uint4*>(      // group, chunk, cell
            slot + (in_tile >> 3) * GROUP_BYTES + p * 128 +
            (in_tile & 7) * 16);
        if (cell < nc) {
          int vc = (int)__umulhi((unsigned)cell, wc_magic);
          int uc = cell - vc * wc;           // the magic number may be one off
          if (uc < 0) {
            --vc;
            uc += wc;
          } else if (uc >= wc) {
            ++vc;
            uc -= wc;
          }
          const uint4* src = reinterpret_cast<const uint4*>(
              img + ((long long)(vc * stride) * w + uc * stride) * F);
          cp_async16(dst, src + p);
        } else {
          *dst = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
  };

  // start the product of this warpgroup's 64 rows with sub-tile sub of slot
  auto start_product = [&](const unsigned char* slot, int sub, float (&d)[32]) {
    const unsigned addr = (unsigned)__cvta_generic_to_shared(
        slot + sub * 8 * GROUP_BYTES);
    const uint64_t desc = DESC_HI | (uint64_t)((addr & 0x3ffffu) >> 4);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      // k step s starts two core matrices (256 bytes, 16 in the address
      // field) further
      wgmma_m64n64k16(d, a[s], desc + (uint64_t)(16 * s), s > 0);
    }
    wgmma_commit();
  };

  // a pass over all cells; body(cell0, masked, d): d[4 j + e] is column
  // cell0 + 8 j + 2 tq + (e & 1) of row row_lo (e < 2) or row_lo + 8.
  // Inside a tile the product of the next sub-tile runs while the body
  // reads this one's accumulators. Every sub-tile of a tile is multiplied,
  // whatever nc: cells past the end are zeros in shared memory and masked
  // by the body, so the chain of products has no branch.
  auto sweep = [&](auto&& body) {
    float d0[32], d1[32];
#pragma unroll 1
    for (int s = 0; s < STAGES - 1; ++s) stage(s);
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<STAGES - 2>();
      fence_async_shared();
      __syncthreads();             // tile t landed; tile t - 1 is done with
      stage(t + STAGES - 1);
      const unsigned char* slot = ring + (t % STAGES) * STAGE_BYTES;
      start_product(slot, 0, d0);
#pragma unroll
      for (int sub = 0; sub < SUBS; ++sub) {
        float (&cur)[32] = (sub & 1) ? d1 : d0;
        float (&nxt)[32] = (sub & 1) ? d0 : d1;
        if (sub + 1 < SUBS) {
          start_product(slot, sub + 1, nxt);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_acc(cur);
        const int cell0 = t * TILE + sub * 64;
        body(cell0, cell0 + 64 > nc, cur);
      }
    }
    cp_async_wait<0>();
    __syncthreads();               // the ring is free for the next sweep
  };

  // sweep 1: the fp32 maxima of rows row_lo and row_lo + 8
  float run0 = -CUDART_INF_F, run1 = -CUDART_INF_F;
  sweep([&](int cell0, bool masked, float (&d)[32]) {
    if (masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cell0 + 8 * j + 2 * tq;
        if (col >= nc) d[4 * j] = d[4 * j + 2] = -CUDART_INF_F;
        if (col + 1 >= nc) d[4 * j + 1] = d[4 * j + 3] = -CUDART_INF_F;
      }
    }
    float m0[8], m1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0[j] = max_nan(d[4 * j], d[4 * j + 1]);
      m1[j] = max_nan(d[4 * j + 2], d[4 * j + 3]);
    }
#pragma unroll
    for (int span = 4; span > 0; span >>= 1) {
#pragma unroll
      for (int j = 0; j < span; ++j) {
        m0[j] = max_nan(m0[j], m0[j + span]);
        m1[j] = max_nan(m1[j], m1[j + span]);
      }
    }
    run0 = max_nan(run0, m0[0]);
    run1 = max_nan(run1, m1[0]);
  });
  run0 = max_nan(run0, __shfl_xor_sync(0xffffffffu, run0, 1));
  run0 = max_nan(run0, __shfl_xor_sync(0xffffffffu, run0, 2));
  run1 = max_nan(run1, __shfl_xor_sync(0xffffffffu, run1, 1));
  run1 = max_nan(run1, __shfl_xor_sync(0xffffffffu, run1, 2));
  const float thr0 = threshold(run0), thr1 = threshold(run1);

  // sweep 2: the lowest cell whose score passes its row's threshold
  int idx0 = NO_IDX, idx1 = NO_IDX;
  sweep([&](int cell0, bool masked, float (&d)[32]) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      any |= above(d[4 * j], thr0) | above(d[4 * j + 1], thr0) |
             above(d[4 * j + 2], thr1) | above(d[4 * j + 3], thr1);
    }
    if (any) {                     // rare: a score that rounds to the maximum
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        const int col = cell0 + 8 * j + 2 * tq;
        const bool in0 = !masked || col < nc, in1 = !masked || col + 1 < nc;
        if (in1 && above(d[4 * j + 1], thr0)) idx0 = min(idx0, col + 1);
        if (in0 && above(d[4 * j], thr0)) idx0 = min(idx0, col);
        if (in1 && above(d[4 * j + 3], thr1)) idx1 = min(idx1, col + 1);
        if (in0 && above(d[4 * j + 2], thr1)) idx1 = min(idx1, col);
      }
    }
  });
  idx0 = min(idx0, __shfl_xor_sync(0xffffffffu, idx0, 1));
  idx0 = min(idx0, __shfl_xor_sync(0xffffffffu, idx0, 2));
  idx1 = min(idx1, __shfl_xor_sync(0xffffffffu, idx1, 1));
  idx1 = min(idx1, __shfl_xor_sync(0xffffffffu, idx1, 2));
  if (tq < 2) {
    const int row = row_lo + 8 * tq;
    if (row < n) {
      int cell = tq == 0 ? idx0 : idx1;
      if (cell == NO_IDX) cell = 0;
      const int vc = cell / wc, uc = cell - vc * wc;
      const int u = min(uc * stride + stride / 2, w - 1);
      const int v = min(vc * stride + stride / 2, h - 1);
      out[(long long)bi * n + row] = v * w + u;
    }
  }
}

template <int F>
int launch_f(const __nv_bfloat16* q, const __nv_bfloat16* t, int* out, int b,
             int n, int h, int w, int stride, cudaStream_t st) {
  constexpr int KS = (F + 15) / 16;
  constexpr int RING_BYTES = STAGES * (TILE / 8) * (2 * KS * 128);
  static bool attr_set = false;          // once per kernel instance
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        coarse_correlate_kernel<F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int hc = (h + stride - 1) / stride, wc = (w + stride - 1) / stride;
  dim3 grid((n + ROWS - 1) / ROWS, b);
  // cell / wc as a multiply by floor(2^32 / wc) + 1: at most one off while
  // cells * wc < 2^32
  if ((long long)hc * wc * wc >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  const unsigned wc_magic =
      wc == 1 ? 0xffffffffu : (unsigned)((1ull << 32) / (unsigned)wc) + 1u;
  coarse_correlate_kernel<F><<<grid, THREADS, RING_BYTES, st>>>(
      q, t, out, n, h, w, hc, wc, wc_magic, stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coarse_correlate_launch(const void* D21, const void* D11,
                                       int* out, int b, int n, int h, int w,
                                       int f, int stride, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b == 0 || n == 0) return (int)cudaGetLastError();
  const __nv_bfloat16* q = (const __nv_bfloat16*)D21;
  const __nv_bfloat16* t = (const __nv_bfloat16*)D11;
  switch (f) {
    case 8: return launch_f<8>(q, t, out, b, n, h, w, stride, st);
    case 16: return launch_f<16>(q, t, out, b, n, h, w, stride, st);
    case 24: return launch_f<24>(q, t, out, b, n, h, w, stride, st);
    case 32: return launch_f<32>(q, t, out, b, n, h, w, stride, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
