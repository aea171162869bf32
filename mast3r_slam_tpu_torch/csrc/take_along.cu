// take_along_axis of a 2-D fp32 array with int32 indices.
//
// Replaces the Pallas probe variant_c of scripts/probe_pallas_gather.py
// (:76, pallas_call :83: jnp.take_along_axis(t, idx, axis=0) on equal
// (1024, 128) shapes, the one gather the TPU compiler accepted). On the
// port's path it is the axis-1 gather of slam/factor_graph.py::_gate_edges
// (JAX factor_graph.py:127-130): Qii at the match index of every pixel.
//
// axis 0: t (R, C), idx (N, C): out[i, j] = t[idx[i, j], j].
// axis 1: t (B, L), idx (B, P): out[b, p] = t[b, idx[b, p]].
// Indices are trusted in range, as in JAX.
//
// Bound on the H100: bytes (4 read of idx, 4 gathered, 4 written per
// element); no arithmetic. Design: one thread per output element;
// neighbouring threads read neighbouring indices and write neighbouring
// outputs, and the gathered reads share cache lines as far as the indices
// are local (matches of neighbouring pixels are).

#include <cuda_runtime.h>

namespace {

template <int AXIS>
__global__ void take_along_kernel(const float* __restrict__ t,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, long long total,
                                  int t_cols, int i_cols) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long row = i / i_cols;
  int col = (int)(i - row * i_cols);
  long long src = AXIS == 0 ? (long long)idx[i] * t_cols + col
                            : row * t_cols + idx[i];
  out[i] = t[src];
}

}  // namespace

extern "C" int take_along_launch(const float* t, const int* idx, float* out,
                                 int axis, int t_cols, int i_rows,
                                 int i_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  long long total = (long long)i_rows * i_cols;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks == 0) return (int)cudaGetLastError();
  if (axis == 0) {
    take_along_kernel<0><<<blocks, threads, 0, st>>>(t, idx, out, total,
                                                     t_cols, i_cols);
  } else {
    take_along_kernel<1><<<blocks, threads, 0, st>>>(t, idx, out, total,
                                                     t_cols, i_cols);
  }
  return (int)cudaGetLastError();
}
