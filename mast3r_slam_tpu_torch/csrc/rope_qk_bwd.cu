// The gradient of rope_qk (csrc/rope_qk.cu) with respect to q and k, in
// one launch.
//
// Replaces the vector-Jacobian product that jax.value_and_grad derives for
// mast3r_slam_tpu/models/rope.py::rope_2d (:33) as the attention code calls
// it (models/vit.py:57-59, :68-70) when scripts/distill_oracle.py trains
// the network (:114-133). The forward per pair (i, i + d/4) of a half is
//   out[i]       = x[i]       * cos[i]       + (-x[i + d/4]) * sin[i]
//   out[i + d/4] = x[i + d/4] * cos[i + d/4] +   x[i]        * sin[i + d/4]
// so with the output's gradient g:
//   dx[i]        = g[i]       * cos[i]       +   g[i + d/4]  * sin[i + d/4]
//   dx[i + d/4]  = g[i + d/4] * cos[i + d/4] + (-g[i])       * sin[i]
// the forward rotation with sin negated (within a half the tables repeat:
// cos and sin of feature i equal those of i + d/4). Every product and sum is
// rounded on its own (-fmad=false), and each dx is the sum of the same two
// rounded products that autograd adds through the plain version
// (models/rope.py::rope_qk_plain), so the two are equal bit for bit.
//
// g is the gradient of rope_qk's output, dense (b, heads, n, d) in the
// output's dtype (fp32 or bf16, widened exactly); dx is dense fp32. q and k
// may have different token counts and tables (cross attention).
//
// Bound on the H100: bytes, those of the forward (g of q and k read once,
// dx written once, the tables read once); 6 FLOP per element. Design: the
// forward's, one thread per VEC features of a quarter and their VEC
// partners, so each element is loaded once; with VEC = 4 every fp32 access
// is 16 bytes (8 for bf16 loads). blockIdx.y picks q or k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Side {
  const void* g;       // (b, heads, n, d) dense, fp32 or bf16
  const float* cos;    // (bt, n, d) dense, bt = 1 or b
  const float* sin;
  float* dx;           // (b, heads, n, d) dense
  long long tb;        // batch stride of the tables (0: shared)
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
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* dst) {
  if constexpr (VEC == 4) {
    uint2 w = *(const uint2*)p;
    __nv_bfloat162 lo = *(__nv_bfloat162*)&w.x;
    __nv_bfloat162 hi = *(__nv_bfloat162*)&w.y;
    dst[0] = __low2float(lo); dst[1] = __high2float(lo);
    dst[2] = __low2float(hi); dst[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = __bfloat162float(p[i]);
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

template <typename T, int VEC>
__global__ void rope_qk_bwd_kernel(Side q, Side k, int b, int heads, int d) {
  const Side sd = blockIdx.y == 0 ? q : k;
  const int quarter = d / 4;
  const int per_row = 2 * (quarter / VEC);      // threads per (b, head, n)
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)b * heads * sd.n * per_row;
  if (t >= total) return;
  int j = (int)(t % per_row);
  long long row = t / per_row;
  int ni = (int)(row % sd.n);
  int bi = (int)(row / sd.n / heads);
  int half = j / (quarter / VEC);
  int i = half * 2 * quarter + (j % (quarter / VEC)) * VEC;

  const T* g = (const T*)sd.g + row * d;
  long long trow = bi * sd.tb + (long long)ni * d;
  const float* c = sd.cos + trow;
  const float* s = sd.sin + trow;
  float* dx = sd.dx + row * d;

  float ga[VEC], gb[VEC], ca[VEC], cb[VEC], sa[VEC], sb[VEC];
  load_vec<VEC>(g + i, ga);
  load_vec<VEC>(g + i + quarter, gb);
  load_vec<VEC>(c + i, ca);
  load_vec<VEC>(c + i + quarter, cb);
  load_vec<VEC>(s + i, sa);
  load_vec<VEC>(s + i + quarter, sb);
  float da[VEC], db[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    da[v] = rot(ga[v], ca[v], gb[v], sb[v]);
    db[v] = rot(gb[v], cb[v], -ga[v], sa[v]);
  }
  store_vec<VEC>(dx + i, da);
  store_vec<VEC>(dx + i + quarter, db);
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
  rope_qk_bwd_kernel<T, VEC><<<dim3(blocks, 2), threads, 0, st>>>(
      q, k, b, heads, d);
  return (int)cudaGetLastError();
}

}  // namespace

// g_q, g_k: dense gradients of rope_qk's outputs (bf16 when in_bf16, else
// fp32); dq, dk: dense fp32 outputs. tb_q, tb_k: batch strides of the
// tables in elements (0: one table for the whole batch). vec4: 1 when
// d % 16 == 0 and every pointer allows 16-byte accesses.
extern "C" int rope_qk_bwd_launch(const void* g_q, const void* g_k,
                                  const float* cos_q, const float* sin_q,
                                  const float* cos_k, const float* sin_k,
                                  float* dq, float* dk, long long tb_q,
                                  long long tb_k, int b, int heads, int nq,
                                  int nk, int d, int in_bf16, int vec4,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Side sq{g_q, cos_q, sin_q, dq, tb_q, nq};
  Side sk{g_k, cos_k, sin_k, dk, tb_k, nk};
  if (in_bf16) {
    return vec4 ? launch<__nv_bfloat16, 4>(sq, sk, b, heads, d, st)
                : launch<__nv_bfloat16, 1>(sq, sk, b, heads, d, st);
  }
  return vec4 ? launch<float, 4>(sq, sk, b, heads, d, st)
              : launch<float, 1>(sq, sk, b, heads, d, st);
}
