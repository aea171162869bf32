// One Gauss-Newton linearization of the frame -> keyframe Sim(3) tracker:
// the 7x7 normal matrix H, the gradient g and the cost, in one pass over
// the matched points.
//
// Replaces mast3r_slam_tpu/slam/tracker.py::_gn_step_t (:60-79) fused with
// _act_t (:102), _ray_dist_t (:109), _ray_dist_pose_jacobian_t (:116) and
// _calib_pose_jacobian_t (:131), which the JAX package left to XLA as a
// chain of component-major elementwise ops and a (7, dN) x (dN, 7) matmul.
//
// T:    (8,) fp32 pose [t, q, s].        Xf:  (N, 3) fp32 frame points.
// tgt:  (d, N) fp32 keyframe targets, d = 4 [ray, dist] (mode 0) or
//       d = 3 [u, v, log z] (mode 1).    si:  (d, N) fp32 sqrt-information.
// part: (264, 36) fp32 scratch.          out: (57,) fp32 = [H (49), g (7),
//                                               cost].
//
// Bound on the H100: bytes. A point reads 12 + 8 d bytes and does ~400
// FLOP, all in registers; 196,608 points are 8.7 MB, 2.6 us at 3.35 TB/s.
// Design: a fixed grid of 256-thread blocks strides over the points, each
// thread keeps the 36 sums in registers, blocks reduce with shuffles into
// `part`, and a second one-block kernel adds the blocks' sums in block
// order. No atomics, so two calls on the same inputs give the same bits.
// Built with -fmad=false like the other kernels.

#include <cuda_runtime.h>

#include "gn_math.cuh"
#include "reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 264;   // two blocks for each of the 132 SMs

template <int MODE>
__global__ void gn_step_partial(const float* __restrict__ T,
                                const float* __restrict__ Xf,
                                const float* __restrict__ tgt,
                                const float* __restrict__ si,
                                float* __restrict__ part, int N,
                                float huber_k, gnm::Intr intr) {
  constexpr int NR = MODE == 0 ? 4 : 3;
  const gnm::Pose P = gnm::load_pose(T);
  float acc[gnm::NACC_GN];
#pragma unroll
  for (int v = 0; v < gnm::NACC_GN; ++v) acc[v] = 0.0f;
  const int step = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N; i += step) {
    float X[3] = {Xf[3 * (long long)i], Xf[3 * (long long)i + 1],
                  Xf[3 * (long long)i + 2]};
    float t[NR], s[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      t[r] = tgt[(long long)r * N + i];
      s[r] = si[(long long)r * N + i];
    }
    gnm::gn_point<MODE>(P, X, t, s, huber_k, intr, acc);
  }
  red::block_sum_store<gnm::NACC_GN>(
      acc, part + (long long)blockIdx.x * gnm::NACC_GN);
}

__global__ void gn_step_finish(const float* __restrict__ part, int blocks,
                               float* __restrict__ out) {
  __shared__ float sums[gnm::NACC_GN];
  const int k = threadIdx.x;
  if (k < gnm::NACC_GN) {
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b) s += part[b * gnm::NACC_GN + k];
    sums[k] = s;
  }
  __syncthreads();
  if (k < 49) {
    out[k] = sums[gnm::upper_index(k / 7, k % 7)];
  } else if (k < 56) {
    out[k] = -sums[gnm::NH + (k - 49)];
  } else if (k == 56) {
    out[k] = 0.5f * sums[gnm::NACC_GN - 1];
  }
}

int gn_step_blocks(int N) {
  int b = (N + THREADS - 1) / THREADS;
  if (b < 1) b = 1;
  return b > MAX_BLOCKS ? MAX_BLOCKS : b;
}

}  // namespace

extern "C" int gn_step_launch(const float* T, const float* Xf,
                              const float* tgt, const float* si, float* part,
                              float* out, int N, int mode, float huber_k,
                              float fx, float fy, float cx, float cy,
                              float border, float umax, float vmax,
                              float z_eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  gnm::Intr intr = {fx, fy, cx, cy, border, umax, vmax, z_eps};
  int blocks = gn_step_blocks(N);
  if (mode == 0) {
    gn_step_partial<0><<<blocks, THREADS, 0, st>>>(T, Xf, tgt, si, part, N,
                                                   huber_k, intr);
  } else {
    gn_step_partial<1><<<blocks, THREADS, 0, st>>>(T, Xf, tgt, si, part, N,
                                                   huber_k, intr);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gn_step_finish<<<1, 64, 0, st>>>(part, blocks, out);
  return (int)cudaGetLastError();
}
