// The tracker's whole frame -> keyframe Sim(3) Gauss-Newton solve in one
// persistent kernel: per iteration the 7x7 normal matrix H, the gradient g
// and the cost over the matched points, the equilibrated 7x7 Cholesky
// solve, the retraction and the convergence test, up to max_iters.
//
// Replaces mast3r_slam_tpu/slam/tracker.py::_run_gn (:171-195), the
// lax.while_loop around _gn_step_t (:60-79) with _solve7 (:81-99),
// sim3.retr and robust.converged, fused with the residual chain _act_t
// (:102), _ray_dist_t (:109) and the pose Jacobians (:116, :131), which
// the JAX package left to XLA.
//
// T0:   (8,) fp32 initial pose [t, q, s].  Xf: (N, 3) fp32 frame points.
// tgt:  (d, N) fp32 keyframe targets, d = 4 [ray, dist] (mode 0) or
//       d = 3 [u, v, log z] (mode 1).    si: (d, N) fp32 sqrt-information.
// part: (max_blocks * 36 + 16) fp32 scratch: per-block sums, then the
//       shared state (the pose of the next iteration and the "done" flag).
// out:  (66,) fp32 = [T (8), cost, H (49), g (7), cost] (the final pose,
//       the cost of the last linearization, and that linearization).
// iters: (1,) int32.  failed: (1,) bool.
//
// Design. One cooperative launch (cudaLaunchCooperativeKernel) of as many
// 256-thread blocks as fit on the card at once, from the occupancy of the
// kernel as built (queried once per device and mode; a larger grid would
// hang at the grid barrier), at most one block per 256 points. Per iteration
// every block reads the pose, stages its tiles of Xf through shared memory
// as 16-byte loads (Xf is (N, 3): a tile of 256 points is 192 float4),
// reads tgt and si as coalesced rows, keeps the 36 sums of its points in
// registers and reduces them with shuffles in a fixed tree into its slot
// of `part`; grid barrier; block 0 adds the blocks' slots in a fixed order
// (red::slot_sums: sums over warps, blocks over lanes, then a shuffle
// tree) and
// its thread 0 runs the solve, the retraction and the convergence test
// (gnm::gn_finish) and writes the new pose and the done flag; grid
// barrier; every block reads the flag. One block computes the finish and
// a second barrier publishes it, rather than every block computing it
// from all the slots: with 2-4 blocks per multiprocessor every block would
// read the 20-80 KB of slots each iteration. No atomics: the same inputs
// on the same grid give the same bits.
//
// Bound on the H100: a point reads 12 + 8 d bytes and does ~40 + 105 d
// FLOP; 196,608 points are 7.1 / 8.7 MB (2.1 / 2.6 us at 3.35 TB/s) and
// 0.07 / 0.09 GFLOP (1.0 / 1.4 us at the 67 TFLOP/s fp32 peak) for
// d = 3 / 4: one linearization is bound by its bytes. Built with
// -fmad=false, every FLOP is one instruction (2.1 / 2.7 us at 33.5 T/s of
// instructions). The frame's 7-9 MB stay in the 50 MB L2, so from the second
// iteration on the reads come from L2. Each iteration adds two grid
// barriers and the one-thread solve.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "gn_math.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 16;

struct GNArgs {
  const float* T0;
  const float* Xf;
  const float* tgt;
  const float* si;
  float* part;
  float* out;
  int* iters;
  unsigned char* failed;
  int N;
  int max_iters;
  float huber_k;
  float rel_error;
  float delta_norm;
  gnm::Intr intr;
};

// This block's share of one linearization: tiles tile = blockIdx.x,
// blockIdx.x + gridDim.x, ... of 256 points, one point a thread
template <int MODE>
__device__ __forceinline__ void accumulate(const GNArgs& a,
                                           const gnm::Pose& P, float* acc,
                                           float* xs) {
  constexpr int NR = MODE == 0 ? 4 : 3;
  const int n_tiles = (a.N + THREADS - 1) / THREADS;
  const bool vec = (reinterpret_cast<uintptr_t>(a.Xf) & 15) == 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * THREADS;
    const int cnt = min(THREADS, a.N - base);
    __syncthreads();   // the last tile's reads of xs are done
    if (vec && cnt == THREADS) {
      const float4* src =
          reinterpret_cast<const float4*>(a.Xf + 3LL * base);
      if (threadIdx.x < 3 * THREADS / 4)
        reinterpret_cast<float4*>(xs)[threadIdx.x] = __ldg(src + threadIdx.x);
    } else {
      for (int k = threadIdx.x; k < 3 * cnt; k += THREADS)
        xs[k] = __ldg(a.Xf + 3LL * base + k);
    }
    __syncthreads();
    if (threadIdx.x < cnt) {
      const long long i = base + threadIdx.x;
      const float X[3] = {xs[3 * threadIdx.x], xs[3 * threadIdx.x + 1],
                          xs[3 * threadIdx.x + 2]};
      float t[NR], s[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        t[r] = __ldg(a.tgt + r * (long long)a.N + i);
        s[r] = __ldg(a.si + r * (long long)a.N + i);
      }
      gnm::gn_point<MODE>(P, X, t, s, a.huber_k, a.intr, acc);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) gn_solve(GNArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) float xs[3 * THREADS];
  __shared__ float pose[8];
  __shared__ float sums[gnm::NACC_GN];
  float* state = a.part + gridDim.x * gnm::NACC_GN;   // [T (8), done]
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  // the loop's state, kept by the lead thread
  gnm::Sim3 T = gnm::sim3_load(a.T0);
  float old_cost = INFINITY;
  bool failed = false;
  if (lead) {
    gnm::sim3_store(T, a.out);
    a.out[8] = INFINITY;
    *a.iters = 0;
    *a.failed = 0;
  }
  for (int it = 0; it < a.max_iters; ++it) {
    if (threadIdx.x < 8)
      pose[threadIdx.x] =
          it == 0 ? a.T0[threadIdx.x] : __ldcg(state + threadIdx.x);
    __syncthreads();
    const gnm::Pose P = gnm::load_pose(pose);
    float acc[gnm::NACC_GN];
#pragma unroll
    for (int v = 0; v < gnm::NACC_GN; ++v) acc[v] = 0.0f;
    accumulate<MODE>(a, P, acc, xs);
    red::block_sum_store<gnm::NACC_GN>(
        acc, a.part + blockIdx.x * gnm::NACC_GN);
    grid.sync();
    if (blockIdx.x == 0) {
      red::slot_sums<gnm::NACC_GN>(a.part, gridDim.x, sums);
      __syncthreads();
      if (lead) {
        float lin[57];
        gnm::gn_linearization(sums, lin);
        const bool done = gnm::gn_finish(lin, T, old_cost, failed,
                                         a.rel_error, a.delta_norm);
        gnm::sim3_store(T, state);
        state[8] = done ? 1.0f : 0.0f;
        gnm::sim3_store(T, a.out);
        a.out[8] = lin[56];
        for (int k = 0; k < 57; ++k) a.out[9 + k] = lin[k];
        *a.iters = it + 1;
        *a.failed = failed ? 1 : 0;
      }
    }
    grid.sync();
    if (__ldcg(state + 8) != 0.0f) break;
  }
}

const void* kernel_of(int mode) {
  return mode == 0 ? (const void*)gn_solve<0> : (const void*)gn_solve<1>;
}

// Blocks of the cooperative grid for `mode`: resident blocks per
// multiprocessor of the kernel as built x multiprocessors, cached per
// device. Returns a negative CUDA error code on failure.
int grid_limit(int mode) {
  static int cached[MAX_DEVICES][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < MAX_DEVICES && cached[dev][mode] > 0) return cached[dev][mode];
  int coop = 0, per_sm = 0, sms = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      kernel_of(mode),
                                                      THREADS, 0);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int blocks = per_sm * sms;
  if (blocks <= 0) return -(int)cudaErrorCooperativeLaunchTooLarge;
  if (dev < MAX_DEVICES) cached[dev][mode] = blocks;
  return blocks;
}

}  // namespace

// max_blocks: the blocks `part` has room for. The grid is the smallest of
// that, the cooperative limit and one block per 256 points.
extern "C" int gn_step_launch(const float* T0, const float* Xf,
                              const float* tgt, const float* si, float* part,
                              float* out, int* iters, unsigned char* failed,
                              int N, int mode, int max_iters, int max_blocks,
                              float huber_k, float rel_error,
                              float delta_norm, float fx, float fy, float cx,
                              float cy, float border, float umax, float vmax,
                              float z_eps, void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  const int limit = grid_limit(mode);
  if (limit < 0) return -limit;
  int blocks = (N + THREADS - 1) / THREADS;
  if (blocks > limit) blocks = limit;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  GNArgs a = {T0,        Xf,    tgt,     si,        part,       out,
              iters,     failed, N,      max_iters, huber_k,    rel_error,
              delta_norm, {fx, fy, cx, cy, border, umax, vmax, z_eps}};
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_of(mode), dim3((unsigned)blocks), dim3(THREADS), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
