// 2-D rotary position embedding of q and k in one launch.
//
// Replaces mast3r_slam_tpu/models/rope.py::rope_2d (:33, with _rope_1d :19)
// as the attention code calls it on q and on k (models/vit.py:57-58 and
// :68-69), followed by the cast to the attention dtype (:59, :70). In the
// JAX package this is XLA elementwise code; the original system had a CUDA
// kernel for it (cuRoPE2D).
//
// The head dim d splits in half: the first half rotates by the token's y,
// the second by its x; within a half, feature i pairs with i + d/4. With
// the precomputed tables cos, sin (b, n, d) of models/rope.py::rope_tables:
//   out[i]       = x[i]       * cos[i]       + (-x[i + d/4]) * sin[i]
//   out[i + d/4] = x[i + d/4] * cos[i + d/4] +   x[i]        * sin[i + d/4]
// for i in the first quarter of each half. Every product and sum is rounded
// on its own (the library is built with -fmad=false), so the result equals
// the plain PyTorch version bit for bit; the cast to bf16 rounds to nearest
// even, as torch does.
//
// q and k are read in place through their strides (the views of the fused
// qkv projection, or of a split-heads reshape): only the feature axis must
// be dense. Outputs are dense (b, heads, n, d). q and k may have different
// token counts and different tables (cross attention).
//
// Bound on the H100: bytes (q and k read once, written once, the tables
// read once); 6 FLOP per element. Design: one thread per VEC features of a
// quarter and their VEC partners, so each input element is loaded once;
// with VEC = 4 every access is 16 bytes (8 for bf16 stores), and the eight
// threads of a d = 64 row cover its 256 bytes. blockIdx.y picks q or k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Side {
  const float* x;      // (b, heads, n, d) through strides, feature stride 1
  const float* cos;    // (bt, n, d) dense, bt = 1 or b
  const float* sin;
  void* out;           // (b, heads, n, d) dense
  long long sb, sh, sn;   // element strides of x
  long long tb;           // batch stride of the tables (0: shared)
  int n;
};

__device__ __forceinline__ float rot(float x, float c, float xr, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(xr, s));
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* dst) {
  if constexpr (VEC == 4) {
    float4 v = *(const float4*)p;
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                           __float2bfloat16_rn(v[1]));
    __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                           __float2bfloat16_rn(v[3]));
    uint2 w;
    w.x = *(unsigned*)&lo;
    w.y = *(unsigned*)&hi;
    *(uint2*)p = w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

template <typename T, int VEC>
__global__ void rope_qk_kernel(Side q, Side k, int b, int heads, int d) {
  const Side sd = blockIdx.y == 0 ? q : k;
  const int quarter = d / 4;
  const int per_row = 2 * (quarter / VEC);      // threads per (b, head, n)
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)b * heads * sd.n * per_row;
  if (t >= total) return;
  int j = (int)(t % per_row);
  long long row = t / per_row;
  int ni = (int)(row % sd.n);
  long long bh = row / sd.n;
  int hi = (int)(bh % heads);
  int bi = (int)(bh / heads);
  int half = j / (quarter / VEC);
  int i = half * 2 * quarter + (j % (quarter / VEC)) * VEC;

  const float* x = sd.x + bi * sd.sb + hi * sd.sh + ni * sd.sn;
  long long trow = bi * sd.tb + (long long)ni * d;
  const float* c = sd.cos + trow;
  const float* s = sd.sin + trow;
  T* out = (T*)sd.out + row * d;

  float xa[VEC], xb[VEC], ca[VEC], cb[VEC], sa[VEC], sb_[VEC];
  load_vec<VEC>(x + i, xa);
  load_vec<VEC>(x + i + quarter, xb);
  load_vec<VEC>(c + i, ca);
  load_vec<VEC>(c + i + quarter, cb);
  load_vec<VEC>(s + i, sa);
  load_vec<VEC>(s + i + quarter, sb_);
  float oa[VEC], ob[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    oa[v] = rot(xa[v], ca[v], -xb[v], sa[v]);
    ob[v] = rot(xb[v], cb[v], xa[v], sb_[v]);
  }
  store_vec<VEC>(out + i, oa);
  store_vec<VEC>(out + i + quarter, ob);
}

template <typename T, int VEC>
int launch(const Side& q, const Side& k, int b, int heads, int d,
           cudaStream_t st) {
  const int threads = 256;
  long long per_row = 2 * (d / 4 / VEC);
  long long nmax = q.n > k.n ? q.n : k.n;
  long long total = (long long)b * heads * nmax * per_row;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks == 0) return (int)cudaGetLastError();
  rope_qk_kernel<T, VEC><<<dim3(blocks, 2), threads, 0, st>>>(q, k, b, heads,
                                                              d);
  return (int)cudaGetLastError();
}

}  // namespace

// q_s*/k_s*: element strides of q and k over (batch, head, token); tb_q,
// tb_k: batch strides of the tables in elements (0: one table for the whole
// batch). out_bf16: 1 writes bf16, 0 fp32. vec4: 1 when d % 16 == 0 and
// every pointer and stride allows 16-byte accesses.
extern "C" int rope_qk_launch(const float* q, const float* k,
                              const float* cos_q, const float* sin_q,
                              const float* cos_k, const float* sin_k,
                              void* q_out, void* k_out, long long q_sb,
                              long long q_sh, long long q_sn, long long k_sb,
                              long long k_sh, long long k_sn, long long tb_q,
                              long long tb_k, int b, int heads, int nq,
                              int nk, int d, int out_bf16, int vec4,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Side sq{q, cos_q, sin_q, q_out, q_sb, q_sh, q_sn, tb_q, nq};
  Side sk{k, cos_k, sin_k, k_out, k_sb, k_sh, k_sn, tb_k, nk};
  if (out_bf16) {
    return vec4 ? launch<__nv_bfloat16, 4>(sq, sk, b, heads, d, st)
                : launch<__nv_bfloat16, 1>(sq, sk, b, heads, d, st);
  }
  return vec4 ? launch<float, 4>(sq, sk, b, heads, d, st)
              : launch<float, 1>(sq, sk, b, heads, d, st);
}
