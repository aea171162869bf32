// Row gather: out[n, :] = table[idx[n], :].
//
// Replaces the two Pallas row-gather probes of
// scripts/probe_pallas_gather.py: variant_a (:38, pallas_call :43: the
// table in VMEM and jnp.take inside the kernel) and variant_b (:52, :67:
// the table in HBM and one async DMA per row). Both compute this one
// function and differ only in how the TPU moved the rows, so one kernel
// replaces both. On the port's path it is slam/ba.py::_gather_points
// (JAX ba.py:72-85), the 4-wide [X, C] row gather of bundle adjustment.
//
// table: (R, C) fp32.  idx: (N,) int32, trusted in [0, R) as in JAX.
// out:   (N, C) fp32.
//
// Bound on the H100: bytes (N C read + N C written + 4 N of indices); no
// arithmetic. Design: one thread per 16 bytes of output where C is a
// multiple of 4 and the buffers are 16-byte aligned (vec4 = 1), so a row of
// 4 floats is one load and one store and wider rows are read by
// neighbouring threads; else one thread per element. The index is read
// once per thread and stays in L1 for the threads of the same row.

#include <cuda_runtime.h>

namespace {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int* __restrict__ idx,
                                   V* __restrict__ out, long long total,
                                   int C) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long n = i / C;
  int c = (int)(i - n * C);
  out[i] = table[(long long)idx[n] * C + c];
}

}  // namespace

extern "C" int gather_rows_launch(const float* table, const int* idx,
                                  float* out, int N, int C, int vec4,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (vec4) {
    int C4 = C / 4;
    long long total = (long long)N * C4;
    unsigned blocks = (unsigned)((total + threads - 1) / threads);
    if (blocks > 0) {
      gather_rows_kernel<float4><<<blocks, threads, 0, st>>>(
          (const float4*)table, idx, (float4*)out, total, C4);
    }
  } else {
    long long total = (long long)N * C;
    unsigned blocks = (unsigned)((total + threads - 1) / threads);
    if (blocks > 0) {
      gather_rows_kernel<float><<<blocks, threads, 0, st>>>(table, idx, out,
                                                            total, C);
    }
  }
  return (int)cudaGetLastError();
}
