// fp32 convolution as an implicit GEMM on the tensor cores, in split TF32
// (3xTF32), at fp32 accuracy.
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions
// (mast3r_slam_tpu/models/dpt.py through models/layers.py::conv2d) to XLA.
// It was added because the DPT heads of a configuration with fp32 heads
// (vitl512_base) run their convolutions in fp32, which cuDNN runs on the
// CUDA cores (67 TFLOP/s peak on the H100): there they were the largest
// device item of a frame. ops/conv.py holds the wrapper, the routing rule
// and the plain PyTorch version of this arithmetic.
//
// y[b, oy, ox, n] = sum over (r, s, c) of
//     x[b, oy * stride + r - pad, ox * stride + s - pad, c] * w[n, r, s, c]
// plus bias[n]; x and y channels-last (NCHW tensors in channels_last memory
// format), w (N, R, S, C) (the weight in channels_last memory format), taps
// outside the image are zeros.
//
// Arithmetic: every fp32 operand v is split into hi = tf32(v), rounded to
// nearest with ties away from zero (cvt.rna's rule, written out so that
// the plain version repeats it bit for bit), and lo = tf32(v - hi), which
// the tensor cores round toward zero (they read the top 19 bits of an fp32
// operand): |hi + lo - v| <= 2^-21 |v|, unbiased (lo takes either sign).
// Each k step of 8 adds A_lo B_hi, then A_hi B_lo, then A_hi B_hi into an
// fp32 accumulator on the tensor cores; lo lo, about 2^-22 of a product,
// is left out. The tensor cores round their
// fp32 sums toward zero, which over a long K drifts: measured on the H100,
// one accumulator over K = 2,304 read 18.7x cuDNN fp32's error against a
// float64 convolution. So each chunk of 32 channels (12 products of k 8)
// starts a fresh accumulator, and the chunk's sum is added to the running
// total with an fp32 add (round to nearest) on the CUDA cores: 0.71x
// cuDNN's error at worst over the DPT's shapes. The bias is added to the
// finished sum. Where K is split (below), the partial sums are added in the
// order of their K ranges, then the bias.
//
// Bound on the H100: operations, 3 x 2 M N K TF32 FLOP at 495 TFLOP/s
// (M = output pixels, N = output channels, K = R S C); the bytes (x, w and
// y once) bound only the 1x1 convolutions to few channels. Design:
//  * a block computes 128 pixels x BN channels (BN = 128, 64, 32 or 16
//    from N) as two warpgroups of 64 rows, with wgmma m64nBNk8 tf32; both
//    operands come from shared memory through descriptors, K-major with
//    the 128-byte swizzle (a row of a chunk is 32 floats, 128 bytes);
//  * K runs in chunks of 32 channels of one tap (C padded to a multiple of
//    32 with zeros), loaded by cp.async into a ring of STAGES raw tiles
//    (zero fill for padding taps, rows past M and channels past N). While
//    the tensor cores multiply chunk t, the block issues the load of chunk
//    t + STAGES - 1 and splits chunk t + 1 (hi in place, lo into one of two
//    side buffers); then it waits for chunk t, adds its sum, and meets the
//    other warps at the chunk's one barrier;
//  * few output tiles and a long K (small maps: the DPT's coarse levels at
//    batch 1) split K over gridDim.y into ranges of whole chunks; the
//    partial sums go to a workspace and a second kernel adds them in range
//    order, then the bias.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                    // pixels a block: 2 x 64 rows
constexpr int BK = 32;                     // channels a chunk: 128 bytes
constexpr int THREADS = 256;
constexpr int STAGES = 4;                  // raw tiles in the ring
static_assert(STAGES >= 3, "chunk t + 1 is split while chunk t multiplies");
constexpr int ROW_BYTES = BK * 4;          // a tile row: one swizzle span
constexpr int ATOM_BYTES = 8 * ROW_BYTES;  // 8 rows: the swizzle's atom
constexpr int A_BYTES = BM * ROW_BYTES;
// descriptor bits above the address: leading byte offset 1 (unused by a
// swizzled K-major layout), stride byte offset (the next 8 rows)
// ATOM_BYTES, layout 1 = 128-byte swizzle
constexpr uint64_t DESC_HI = ((uint64_t)1 << 16) |
                             ((uint64_t)(ATOM_BYTES >> 4) << 32) |
                             ((uint64_t)1 << 62);

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int SLOT = A_BYTES + B_BYTES;   // a chunk's A then B
  static constexpr int SMEM = (STAGES + 2) * SLOT;  // ring + 2 lo buffers
  static constexpr int MIN_BLOCKS = BN <= 16 ? 2 : 1;
  static_assert(SLOT % ATOM_BYTES == 0, "tiles start on swizzle atoms");
};

// the byte of 16-byte piece j (floats 4 j .. 4 j + 3) of row r in a
// 128-byte-swizzled K-major tile
__device__ __forceinline__ int swz(int r, int j) {
  return r * ROW_BYTES + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint64_t desc(const unsigned char* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  return DESC_HI | (uint64_t)((addr & 0x3ffffu) >> 4);
}

// 16 bytes from global to shared memory; zeros where !valid
__device__ __forceinline__ void cp_async16(unsigned char* smem,
                                           const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(n)
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
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// hi = v rounded to the nearest tf32 value, ties away from zero (what
// cvt.rna.tf32.f32 gives), low 13 bits cleared; lo = v - hi, exact, whose
// low 13 bits the tensor cores drop (rounding lo toward zero). inf and
// NaN give a NaN lo, so a non-finite input gives a NaN output.
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
  lo = v - hi;
}

// D (64 x N, fp32) = A (64 x 8 tf32) x B (8 x N tf32) + (scale ? D : 0),
// A and B from shared memory through their descriptors
template <int N>
struct Mma;

template <>
struct Mma<16> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct Mma<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale));
  }
};

template <int BN>
__global__ void __launch_bounds__(THREADS, Tile<BN>::MIN_BLOCKS)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int H,
            int W, int C, int N, int S, int stride, int pad, int Ho, int Wo,
            int M, int ck, int nk, int per_split, int n_tiles) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's atoms must start on 1024-byte shared addresses
  const unsigned base_addr = (unsigned)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((1024u - (base_addr & 1023u)) & 1023u);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;                  // warpgroup: rows 64 wg ..
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int q0 = blockIdx.y * per_split;     // this block's chunks
  const int nq = min(nk - q0, per_split);
  const int taps = nk / ck;                  // R S

  // this thread's copies: pieces j and j + 4 (floats 4 j ..) of rows
  // 8 grp + r8, grp = warp + 8 i; the 8 lanes of a j fill 8 rows
  const int r8 = lane & 7;
  const int j0 = lane >> 3;
  int a_iy[2], a_ix[2];
  long long a_img[2];
  bool a_in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 8 * (warp + 8 * i) + r8;
    a_in[i] = m < M;
    const int mm = a_in[i] ? m : 0;
    const int b = mm / (Ho * Wo);
    const int rem = mm - b * (Ho * Wo);
    const int oy = rem / Wo;
    const int ox = rem - oy * Wo;
    a_iy[i] = oy * stride - pad;
    a_ix[i] = ox * stride - pad;
    a_img[i] = (long long)b * H * W * C;
  }

  auto load = [&](int q, int slot) {
    unsigned char* base = smem + slot * T::SLOT;
    const int tap = q / ck;
    const int c0 = (q - tap * ck) * BK;
    const int r = tap / S;
    const int s = tap - r * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 8 * (warp + 8 * i) + r8;
      const int iy = a_iy[i] + r;
      const int ix = a_ix[i] + s;
      const bool pix = a_in[i] && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* px = x + a_img[i] + ((long long)iy * W + ix) * C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + 4 * h;
        const int c = c0 + 4 * j;
        const bool ok = pix && c < C;
        cp_async16(base + swz(row, j), ok ? px + c : x, ok);
      }
    }
    unsigned char* bt = base + A_BYTES;
#pragma unroll
    for (int i = 0; i < (BN + 63) / 64; ++i) {
      const int grp = warp + 8 * i;
      if (grp < BN / 8) {
        const int row = 8 * grp + r8;
        const int n = n0 + row;
        const float* pw = w + ((long long)n * taps + tap) * C;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = j0 + 4 * h;
          const int c = c0 + 4 * j;
          const bool ok = n < N && c < C;
          cp_async16(bt + swz(row, j), ok ? pw + c : w, ok);
        }
      }
    }
  };

  // a landed chunk: hi in place, lo into side buffer lo_slot (the same
  // offsets: the split is elementwise)
  auto split_chunk = [&](int slot, int lo_slot) {
    float4* raw = reinterpret_cast<float4*>(smem + slot * T::SLOT);
    float4* lo =
        reinterpret_cast<float4*>(smem + (STAGES + lo_slot) * T::SLOT);
#pragma unroll 8
    for (int i = tid; i < T::SLOT / 16; i += THREADS) {
      const float4 v = raw[i];
      float4 h, l;
      split(v.x, h.x, l.x);
      split(v.y, h.y, l.y);
      split(v.z, h.z, l.z);
      split(v.w, h.w, l.w);
      raw[i] = h;
      lo[i] = l;
    }
  };

  float acc[BN / 2];                         // the chunk's sum
  float total[BN / 2];                       // the chunks' sums so far
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.0f;

  // chunk t: in ring slot t % STAGES (hi) and side buffer t & 1 (lo); per
  // k step the two cross terms, then hi hi, the first into a fresh
  // accumulator
  auto multiply = [&](int t) {
    const unsigned char* hi = smem + (t % STAGES) * T::SLOT;
    const unsigned char* lo = smem + (STAGES + (t & 1)) * T::SLOT;
    const int rows = wg * 64 * ROW_BYTES;     // this warpgroup's 64 rows
    const uint64_t ah = desc(hi + rows), al = desc(lo + rows);
    const uint64_t bh = desc(hi + A_BYTES), bl = desc(lo + A_BYTES);
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
      // k step k: 32 bytes further along the swizzled rows, 2 in the
      // descriptor's address field
      const uint64_t dk = (uint64_t)(2 * k);
      Mma<BN>::run(acc, al + dk, bh + dk, k == 0 ? 0 : 1);
      Mma<BN>::run(acc, ah + dk, bl + dk, 1);
      Mma<BN>::run(acc, ah + dk, bh + dk, 1);
    }
  };

#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nq) load(q0 + i, i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();                 // chunk 0 landed
  split_chunk(0, 0);
  fence_async_shared();
  cp_async_wait<STAGES - 3>();
  __syncthreads();                 // chunk 0 split, chunk 1 landed
#pragma unroll 1
  for (int t = 0; t < nq; ++t) {
    wgmma_fence();
    multiply(t);
    wgmma_commit();
    // while the tensor cores multiply chunk t: chunk t + STAGES - 1 loaded
    // into chunk t - 1's ring slot, chunk t + 1 split
    const int tn = t + STAGES - 1;
    if (tn < nq) load(q0 + tn, tn % STAGES);
    cp_async_commit();
    if (t + 1 < nq) split_chunk((t + 1) % STAGES, (t + 1) & 1);
    fence_async_shared();
    wgmma_wait<0>();               // chunk t multiplied
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] = total[i] + acc[i];
    cp_async_wait<STAGES - 3>();   // chunk t + 2 landed
    __syncthreads();               // ... for every thread; chunk t + 1
  }                                // split; chunk t done everywhere

  // total[4 j + e] is row g + 8 (e >> 1), column 8 j + 2 tq + (e & 1) of
  // this warp's 16 rows
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bool partial = gridDim.y > 1;
  float* dst = out + (partial ? (long long)blockIdx.y * M * N : 0ll);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * (warp & 3) + g + 8 * h;
    if (m >= M) continue;
    float* row = dst + (long long)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      float v0 = total[4 * j + 2 * h];
      float v1 = total[4 * j + 2 * h + 1];
      if (!partial && bias != nullptr) {
        if (n < N) v0 = v0 + bias[n];
        if (n + 1 < N) v1 = v1 + bias[n + 1];
      }
      if ((N & 1) == 0 && n + 1 < N) {
        *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
      } else {
        if (n < N) row[n] = v0;
        if (n + 1 < N) row[n + 1] = v1;
      }
    }
  }
}

// y = the partial sums of the K ranges added in range order, then the bias
__global__ void reduce_kernel(const float* __restrict__ ws,
                              const float* __restrict__ bias,
                              float* __restrict__ y, long long mn, int N,
                              int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int z = 1; z < splits; ++z) v = v + ws[z * mn + i];
    if (bias != nullptr) v = v + bias[i % N];
    y[i] = v;
  }
}

template <int BN>
int launch_bn(const float* x, const float* w, const float* bias, float* y,
              float* ws, int H, int W, int C, int N, int S, int stride,
              int pad, int Ho, int Wo, int M, int ck, int nk, int per_split,
              int splits, cudaStream_t st) {
  constexpr int smem = Tile<BN>::SMEM + 1024;   // + the atoms' alignment
  static bool attr_set = false;            // once per kernel instance
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_tiles = (N + BN - 1) / BN;
  const long long blocks = (long long)n_tiles * ((M + BM - 1) / BM);
  if (blocks > 0x7fffffffll || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)blocks, splits);
  conv_kernel<BN><<<grid, THREADS, smem, st>>>(
      x, w, bias, splits > 1 ? ws : y, H, W, C, N, S, stride, pad, Ho, Wo,
      M, ck, nk, per_split, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  const long long want = (mn + 255) / 256;
  const int rblocks = (int)(want < 2048 ? want : 2048);
  reduce_kernel<<<rblocks, 256, 0, st>>>(ws, bias, y, mn, N, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// ops/conv.py::plan chooses bn, per_split (chunks of 32 channels a K
// range) and splits (the K ranges, none empty); ws holds splits x M x N
// floats where splits > 1. Returns a cudaError_t.
extern "C" int conv2d_3xtf32_launch(const void* x, const void* w,
                                    const void* bias, void* y, void* ws,
                                    int B, int H, int W, int C, int N, int R,
                                    int S, int stride, int pad, int Ho,
                                    int Wo, int bn, int per_split,
                                    int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long m = (long long)B * Ho * Wo;
  if (m == 0 || N == 0) return (int)cudaGetLastError();
  const int ck = (C + BK - 1) / BK;
  const int nk = R * S * ck;
  if (m > 0x7fffffffll || C % 4 != 0 || stride < 1 || pad < 0 ||
      per_split < 1 || splits != (nk + per_split - 1) / per_split ||
      (splits > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  float* yf = (float*)y;
  float* wsf = (float*)ws;
  const int M = (int)m;
#define CONV_ARGS xf, wf, bf, yf, wsf, H, W, C, N, S, stride, pad, Ho, Wo, \
                  M, ck, nk, per_split, splits, st
  switch (bn) {
    case 128: return launch_bn<128>(CONV_ARGS);
    case 64: return launch_bn<64>(CONV_ARGS);
    case 32: return launch_bn<32>(CONV_ARGS);
    case 16: return launch_bn<16>(CONV_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CONV_ARGS
}
