// take_along_axis of 2-D fp32 arrays with int32 indices, one or two
// problems of one shape in one launch.
//
// Replaces the Pallas probe variant_c of scripts/probe_pallas_gather.py
// (:76, pallas_call :83: jnp.take_along_axis(t, idx, axis=0) on equal
// (1024, 128) shapes, the one gather the TPU compiler accepted). On the
// port's path it is the axis-1 gather of slam/factor_graph.py::_gate_edges
// (JAX factor_graph.py:127-130): Qii at the match index of every pixel in
// one direction and Qjj in the other, both problems in one launch.
//
// axis 0: t (R, C), idx (N, C): out[i, j] = t[idx[i, j], j].
// axis 1: t (B, L), idx (B, P): out[b, p] = t[b, idx[b, p]].
// Indices are trusted in range, as in JAX.
//
// Bound on the H100: bytes (4 read of idx, 4 gathered, 4 written per
// element); no arithmetic. At the gate's shape, two (2, 196608) problems
// (9.4 MB), everything sits in L2. On uniform random indices each 4-byte
// gather pulls its own 32-byte L2 sector, and those sectors bound the
// kernel; on an edge's match indices neighbouring outputs gather
// neighbouring values and share sectors. Design:
// - both gate directions in one launch: blockIdx.z picks the problem;
// - the row comes from blockIdx.y (a grid-stride loop over rows past the
//   grid's height), so no thread divides;
// - each thread moves 4 consecutive outputs: one int4 load of indices,
//   4 independent __ldg gathers, one float4 store. A row's first columns
//   up to the 16-byte boundary and its last (C mod 4) columns go one at a
//   time, and so does a whole row whose indices and outputs are not
//   aligned alike modulo 16 bytes (no column count or pointer is refused);
// - the grid is at most one wave (occupancy x SMs) and threads loop over
//   the row's 4-column groups with a grid stride.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Problem {
  const float* t;
  const int* idx;
  float* out;
};

constexpr int kMaxThreads = 256;

template <int AXIS>
__global__ void __launch_bounds__(kMaxThreads)
    take_along_kernel(Problem p0, Problem p1, int t_cols, int i_rows,
                      int i_cols) {
  const Problem p = blockIdx.z == 0 ? p0 : p1;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.y; row < i_rows; row += gridDim.y) {
    const long long base = (long long)row * i_cols;
    const int* __restrict__ irow = p.idx + base;
    float* __restrict__ orow = p.out + base;
    const float* __restrict__ trow =
        AXIS == 1 ? p.t + (long long)row * t_cols : p.t;
    // columns [0, head) and [tail, i_cols) one at a time, the rest by 4
    const uintptr_t ia = (uintptr_t)irow, oa = (uintptr_t)orow;
    int head = ((ia - oa) & 15) == 0 ? (int)(((16 - (ia & 15)) & 15) >> 2)
                                     : i_cols;
    head = head < i_cols ? head : i_cols;
    const int groups = (i_cols - head) >> 2;
    const int tail = head + 4 * groups;
    const int4* __restrict__ i4 = reinterpret_cast<const int4*>(irow + head);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(orow + head);
    for (int g = tid; g < groups; g += stride) {
      const int4 k = __ldg(i4 + g);
      float4 v;
      if (AXIS == 1) {
        v.x = __ldg(trow + k.x);
        v.y = __ldg(trow + k.y);
        v.z = __ldg(trow + k.z);
        v.w = __ldg(trow + k.w);
      } else {
        const int c = head + 4 * g;
        v.x = __ldg(trow + (long long)k.x * t_cols + c);
        v.y = __ldg(trow + (long long)k.y * t_cols + c + 1);
        v.z = __ldg(trow + (long long)k.z * t_cols + c + 2);
        v.w = __ldg(trow + (long long)k.w * t_cols + c + 3);
      }
      o4[g] = v;
    }
    const int n_scalar = head + (i_cols - tail);
    for (int s = tid; s < n_scalar; s += stride) {
      const int c = s < head ? s : tail + (s - head);
      const int k = __ldg(irow + c);
      orow[c] = AXIS == 1 ? __ldg(trow + k)
                          : __ldg(trow + (long long)k * t_cols + c);
    }
  }
}

// blocks of `threads` threads that fit on one SM at once, per axis
int blocks_per_sm(int axis, int threads) {
  static int cache[2][kMaxThreads / 32 + 1];
  int& v = cache[axis][threads / 32];
  if (v == 0) {
    int n = 0;
    cudaError_t e =
        axis == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &n, take_along_kernel<0>, threads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &n, take_along_kernel<1>, threads, 0);
    if (e != cudaSuccess || n < 1) return 1;
    v = n;
  }
  return v;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

}  // namespace

// n_problems 1 or 2; problem 1's pointers are read only when it is 2. Both
// problems have t of (t_rows, t_cols) and idx/out of (i_rows, i_cols).
extern "C" int take_along_launch(const float* t0, const int* idx0,
                                 float* out0, const float* t1,
                                 const int* idx1, float* out1,
                                 int n_problems, int axis, int t_cols,
                                 int i_rows, int i_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (i_rows <= 0 || i_cols <= 0 || n_problems <= 0) {
    return (int)cudaGetLastError();
  }
  const Problem p0{t0, idx0, out0};
  const Problem p1 = n_problems > 1 ? Problem{t1, idx1, out1} : p0;
  // threads: the row's 4-column groups, rounded up to a warp, at most 256
  const int groups = (i_cols + 3) / 4;
  int threads = ((groups + 31) / 32) * 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  const long long wave =
      (long long)sm_count() * blocks_per_sm(axis, threads);
  long long gy = i_rows < 65535 ? i_rows : 65535;
  if (gy * n_problems > wave) gy = wave >= n_problems ? wave / n_problems : 1;
  long long gx = (groups + threads - 1) / threads;
  const long long room = wave / (gy * n_problems);
  gx = gx < room ? gx : (room > 0 ? room : 1);
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)n_problems);
  if (axis == 0) {
    take_along_kernel<0><<<grid, threads, 0, st>>>(p0, p1, t_cols, i_rows,
                                                   i_cols);
  } else {
    take_along_kernel<1><<<grid, threads, 0, st>>>(p0, p1, t_cols, i_rows,
                                                   i_cols);
  }
  return (int)cudaGetLastError();
}
