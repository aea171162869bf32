// Per-edge Hessian and gradient of the global Sim(3) bundle adjustment:
// for every edge (i, j) of the factor graph, the sum over its matched
// points of the robustly weighted J^T J (7x7) and J^T r (7) with respect to
// the relative pose Tij.
//
// Replaces mast3r_slam_tpu/slam/ba.py::_edge_terms (:203-298) with the
// residual closures of _edge_terms_rays (:320), _edge_terms_calib (:358)
// and _edge_terms_points (:340): the confidence gates (:259-265), the
// sqrt-weights and Huber IRLS (:266-269), the raw 7-column Jacobian and
// the contraction to S0 (E, 7, 7) and g0 (E, 7) (:276-284). The JAX package
// scanned point chunks of component-major (E, r, 7, C) Jacobians through
// matmuls; the original system ran one CUDA block per edge. The per-edge
// conjugation S = M S0 M^T stays in PyTorch (slam/ba.py).
//
// Tij:  (E, 8) fp32 relative poses Ti^-1 Tj.
// XCi:  (E, P, 4) fp32 [X, C] of keyframe i gathered at the match index.
// XCj:  (E, P, 4) fp32 [X, C] of keyframe j at the measurement pixels.
// sidx: (E, P) int32 match index into keyframe i's image (calib mode).
// vm:   (E, P_full) uint8 and Q: (E, P_full) fp32, read at column
//       p * stride (the measurement pixels are every stride-th one).
// mask: (E,) fp32 edge mask.
// part: (E, bpe, 35) fp32 scratch.  S0: (E, 7, 7), g0: (E, 7) fp32.
//
// Bound on the H100: bytes. A point reads 41 bytes (45 in calib mode) and
// does ~450 FLOP in registers; 8 edges x 196,608 points are 64 MB, 19 us
// at 3.35 TB/s, against 0.7 GFLOP, 11 us at the fp32 peak. Design: `bpe`
// blocks per edge stride over the edge's points with one float4 load per
// side, each thread keeps the 35 sums in registers, blocks reduce with
// shuffles into `part`, and a second kernel (one block per edge) adds the
// blocks' sums in block order. No atomics: two calls give the same bits.
// Built with -fmad=false like the other kernels.

#include <cuda_runtime.h>

#include "gn_math.cuh"
#include "reduce.cuh"

namespace {

constexpr int THREADS = 256;

struct Sigma {
  float s[4];
};

template <int MODE>
__global__ void ba_edge_partial(const float* __restrict__ Tij,
                                const float4* __restrict__ XCi,
                                const float4* __restrict__ XCj,
                                const int* __restrict__ sidx,
                                const unsigned char* __restrict__ vm,
                                const float* __restrict__ Q,
                                const float* __restrict__ mask,
                                float* __restrict__ part, int P, int P_full,
                                int stride, int img_w, Sigma sig,
                                gnm::BAGate gate, gnm::Intr intr) {
  const int e = blockIdx.y;
  const gnm::Pose pose = gnm::load_pose(Tij + 8 * (long long)e);
  const float edge_mask = mask[e];
  float acc[gnm::NACC_BA];
#pragma unroll
  for (int v = 0; v < gnm::NACC_BA; ++v) acc[v] = 0.0f;
  const int step = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P; p += step) {
    const long long o = (long long)e * P + p;
    const long long of = (long long)e * P_full + (long long)p * stride;
    const float4 a = XCi[o];
    const float4 b = XCj[o];
    const float Xi[3] = {a.x, a.y, a.z};
    const float Xj[3] = {b.x, b.y, b.z};
    const int si = MODE == 1 ? sidx[o] : 0;
    gnm::ba_point<MODE>(pose, Xi, a.w, Xj, b.w, Q[of], vm[of] != 0, si,
                        img_w, edge_mask, sig.s, gate, intr, acc);
  }
  red::block_sum_store<gnm::NACC_BA>(
      acc, part + ((long long)e * gridDim.x + blockIdx.x) * gnm::NACC_BA);
}

__global__ void ba_edge_finish(const float* __restrict__ part, int bpe,
                               float* __restrict__ S0,
                               float* __restrict__ g0) {
  __shared__ float sums[gnm::NACC_BA];
  const int e = blockIdx.x;
  const int k = threadIdx.x;
  if (k < gnm::NACC_BA) {
    const float* p = part + (long long)e * bpe * gnm::NACC_BA;
    float s = 0.0f;
    for (int b = 0; b < bpe; ++b) s += p[b * gnm::NACC_BA + k];
    sums[k] = s;
  }
  __syncthreads();
  if (k < 49) {
    S0[(long long)e * 49 + k] = sums[gnm::upper_index(k / 7, k % 7)];
  } else if (k < 56) {
    g0[(long long)e * 7 + (k - 49)] = sums[gnm::NH + (k - 49)];
  }
}

}  // namespace

extern "C" int ba_edge_terms_launch(
    const float* Tij, const float* XCi, const float* XCj, const int* sidx,
    const unsigned char* vm, const float* Q, const float* mask, float* part,
    float* S0, float* g0, int E, int P, int P_full, int stride, int bpe,
    int mode, int img_w, float sig0, float sig1, float sig2, float sig3,
    float Q_conf, float C_conf, float huber_k, float fx, float fy, float cx,
    float cy, float border, float umax, float vmax, float z_eps,
    void* stream) {
  if (E <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  Sigma sig = {{sig0, sig1, sig2, sig3}};
  gnm::BAGate gate = {Q_conf, C_conf, huber_k};
  gnm::Intr intr = {fx, fy, cx, cy, border, umax, vmax, z_eps};
  dim3 grid((unsigned)bpe, (unsigned)E);
  const float4* xi = (const float4*)XCi;
  const float4* xj = (const float4*)XCj;
  if (mode == 0) {
    ba_edge_partial<0><<<grid, THREADS, 0, st>>>(
        Tij, xi, xj, sidx, vm, Q, mask, part, P, P_full, stride, img_w, sig,
        gate, intr);
  } else if (mode == 1) {
    ba_edge_partial<1><<<grid, THREADS, 0, st>>>(
        Tij, xi, xj, sidx, vm, Q, mask, part, P, P_full, stride, img_w, sig,
        gate, intr);
  } else {
    ba_edge_partial<2><<<grid, THREADS, 0, st>>>(
        Tij, xi, xj, sidx, vm, Q, mask, part, P, P_full, stride, img_w, sig,
        gate, intr);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ba_edge_finish<<<(unsigned)E, 64, 0, st>>>(part, bpe, S0, g0);
  return (int)cudaGetLastError();
}
