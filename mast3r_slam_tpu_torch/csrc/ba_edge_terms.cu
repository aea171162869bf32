// The linear system of one global Sim(3) bundle-adjustment iteration in one
// launch: for every edge (i, j) the robustly weighted sums S0 = J^T J (7x7)
// and g0 = J^T r (7) over its matched points with respect to Tij, their
// conjugation by the inverse adjoint of Ti into the edge's 14x14 Hessian
// block [[S, -S], [-S, S]] and 14-vector [-M g0, M g0], and the assembly
// of all edges into the dense 7K x 7K system.
//
// Replaces mast3r_slam_tpu/slam/ba.py::_edge_terms (:203-298) with the
// residual closures of _edge_terms_rays (:320), _edge_terms_calib (:358)
// and _edge_terms_points (:340), the per-edge Tij = Ti^-1 Tj and
// _adj_inv_matrix (:180), and _assemble (:394-429). The JAX package
// scanned point chunks of component-major (E, r, 7, C) Jacobians through
// matmuls and scattered the blocks with .at[].add; the original system ran
// one CUDA block per edge.
//
// T:    system mode (K, 8) fp32 T_WCs; raw mode (E, 8) fp32 Tij.
// ii, jj: (E,) int32 edge endpoints (system mode).
// XCi:  (E, P, 4) fp32 [X, C] of keyframe i gathered at the match index.
// XCj:  (E, P, 4) fp32 [X, C] of keyframe j at the measurement pixels.
// sidx: (E, P) int32 match index into keyframe i's image (calib mode).
// wq:   (E, P) fp32 sqrt(Q) where the pose-independent gates pass, else 0
//       (slam/ba.py::_edge_weights, once per solve).
// mask: (E,) fp32 edge mask.   part: (E, bpe, 35) fp32 scratch.
// count: (E,) int32, zero before the launch and zero after it.
// The assembly plan (system mode; slam/ba.py::_assembly_plan, once per
// solve), over the 4 E contributions c = t E + e (block type t of edge e):
//   order (4E,) int32: the contributions by destination block, then by c;
//   run_of (4E,) int32: the run (destination block) of contribution c, -1
//     where it touches a pinned or inactive pose (the sentinel);
//   run_start, run_len, run_key (4E,) int32: run h's first position in
//     order, its length and its block row * K + col;
//   block_run (K * K,) int32: the run of each 7x7 block of Hd, -1 if none;
//   run_count (4E,) int32, zero before the launch and zero after it.
// Hout, gout: system mode (E, 14, 14) and (E, 14); raw mode S0 (E, 7, 7)
//       and g0 (E, 7).   Hd (7K, 7K), gd (7K): the assembled system.
//
// Design. bpe blocks per edge, sized by the wrapper from the card (about
// three blocks per multiprocessor over all edges, at most one per 256
// points), so that two edges fill the card as well as forty. Each block
// computes Tij (and its thread 0 later M) from T_WCs itself, strides over
// the edge's points with two float4 loads and one float (plus the index in
// calib mode), keeps the 35 sums in registers and reduces them with
// shuffles into its slot of `part`. Then __threadfence and an integer
// counter per edge: the last block of an edge adds the edge's slots in a
// fixed order (red::slot_sums, through L2), conjugates, and writes the
// edge's blocks. Then it adds one to the integer counter of each of the
// edge's four destination blocks (run_count); the block that adds the last
// contribution of a run sums that run in the plain version's order (four
// index_put_ calls in edge order), 49 threads for the 7x7 block and, on a
// diagonal block, 7 more for that pose's gradient. So the assembly spreads
// over the edges' last blocks instead of waiting for the last edge. Every
// block writes the zeros of a grid-stride share of Hd and gd, where
// block_run says that no run writes. Pinned and inactive poses go to the
// sentinel, which is dropped. The blocks that finish a counter reset it,
// so the next launch starts clean. No float atomics: the same inputs on
// the same grid give the same bits. Any edge count.
//
// Bound on the H100: a point reads 36 bytes (40 in calib mode) and does
// ~60 + 105 r FLOP (r = 4 or 3 rows). At E = 8 edges of 196,608 points:
// 57 MB (17 us at 3.35 TB/s) against 0.6-0.8 GFLOP (9-12 us at the
// 67 TFLOP/s fp32 peak): the bytes bound it. Built with -fmad=false, every
// FLOP is one instruction (18-23 us at 33.5 T/s of instructions).

#include <cuda_runtime.h>

#include "gn_math.cuh"
#include "reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct BAArgs {
  const float* T;
  const int* ii;
  const int* jj;
  const float4* XCi;
  const float4* XCj;
  const int* sidx;
  const float* wq;
  const float* mask;
  float* part;
  int* count;
  const int* order;
  const int* run_of;
  const int* run_start;
  const int* run_len;
  const int* run_key;
  const int* block_run;
  int* run_count;
  float* Hout;
  float* gout;
  float* Hd;
  float* gd;
  int E, P, bpe, raw, img_w, K_cap;
  float sig[4];
  float huber_k;
  gnm::Intr intr;
};

// The edge's last block: one more contribution to each of the edge's
// destination blocks; the runs that this completes are summed here.
__device__ void assemble_runs(const BAArgs& a, int e, int* runs) {
  const int tid = threadIdx.x;
  if (tid < 4) {
    const int h = a.run_of[tid * a.E + e];
    int mine = -1;
    if (h >= 0 && atomicAdd(a.run_count + h, 1) == a.run_len[h] - 1) {
      a.run_count[h] = 0;
      mine = h;
    }
    runs[tid] = mine;
  }
  __syncthreads();
  if (runs[0] < 0 && runs[1] < 0 && runs[2] < 0 && runs[3] < 0) return;
  __threadfence();
  const long long D = 7LL * a.K_cap;
  for (int q = 0; q < 4; ++q) {
    const int h = runs[q];
    if (h < 0) continue;
    const int key = a.run_key[h], start = a.run_start[h], len = a.run_len[h];
    const long long r0 = 7LL * (key / a.K_cap), c0 = 7LL * (key % a.K_cap);
    if (tid < 49)
      a.Hd[(r0 + tid / 7) * D + c0 + tid % 7] =
          gnm::run_sum(a.order, start, len, a.Hout, a.E, tid);
    else if (tid < 56 && r0 == c0)
      a.gd[r0 + tid - 49] =
          gnm::run_grad(a.order, start, len, a.gout, a.E, tid - 49);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) ba_edge_system(BAArgs a) {
  __shared__ float sums[gnm::NACC_BA];
  __shared__ float M[49], S0[49], A[49], g0[7];
  __shared__ int last, runs[4];
  const int e = blockIdx.y;
  const int tid = threadIdx.x;
  if (!a.raw) {   // this block's share of the zeros of Hd and gd
    const int K = a.K_cap;
    const long long D = 7LL * K, nt = (long long)a.E * a.bpe * THREADS;
    const long long at = ((long long)e * a.bpe + blockIdx.x) * THREADS + tid;
    for (long long c = at; c < D * D; c += nt)
      if (a.block_run[(c / D / 7) * K + c % D / 7] < 0) a.Hd[c] = 0.0f;
    for (long long c = at; c < D; c += nt)
      if (a.block_run[(c / 7) * K + c / 7] < 0) a.gd[c] = 0.0f;
  }
  gnm::Sim3 Ti, Tij;
  if (a.raw) {
    Tij = Ti = gnm::sim3_load(a.T + 8LL * e);
  } else {
    Ti = gnm::sim3_load(a.T + 8LL * a.ii[e]);
    Tij = gnm::sim3_mul(gnm::sim3_inv(Ti),
                        gnm::sim3_load(a.T + 8LL * a.jj[e]));
  }
  float Tf[8];
  gnm::sim3_store(Tij, Tf);
  const gnm::Pose pose = gnm::load_pose(Tf);
  const float edge_mask = a.mask[e];
  float acc[gnm::NACC_BA];
#pragma unroll
  for (int v = 0; v < gnm::NACC_BA; ++v) acc[v] = 0.0f;
  const int step = a.bpe * THREADS;
  for (int p = blockIdx.x * THREADS + tid; p < a.P; p += step) {
    const long long o = (long long)e * a.P + p;
    const float4 xi = __ldg(a.XCi + o);
    const float4 xj = __ldg(a.XCj + o);
    const float Xi[3] = {xi.x, xi.y, xi.z};
    const float Xj[3] = {xj.x, xj.y, xj.z};
    const int s = MODE == 1 ? __ldg(a.sidx + o) : 0;
    gnm::ba_point<MODE>(pose, Xi, Xj, __ldg(a.wq + o), s, a.img_w,
                        edge_mask, a.sig, a.huber_k, a.intr, acc);
  }
  red::block_sum_store<gnm::NACC_BA>(
      acc, a.part + ((long long)e * a.bpe + blockIdx.x) * gnm::NACC_BA);

  // the last block of this edge adds the edge's slots in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(a.count + e, 1) == a.bpe - 1;
    if (last) a.count[e] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  red::slot_sums<gnm::NACC_BA>(
      a.part + (long long)e * a.bpe * gnm::NACC_BA, a.bpe, sums);
  __syncthreads();
  if (tid < 49) {
    const float v = sums[gnm::upper_index(tid / 7, tid % 7)];
    if (a.raw) a.Hout[49LL * e + tid] = v;
    S0[tid] = v;
  }
  if (tid < 7) {
    const float v = sums[gnm::NH + tid];
    if (a.raw) a.gout[7LL * e + tid] = v;
    g0[tid] = v;
  }
  if (a.raw) return;
  if (tid == 0) gnm::adj_inv_matrix(Ti, M);
  __syncthreads();
  if (tid < 49) A[tid] = gnm::conj_left(M, S0, tid / 7, tid % 7);
  __syncthreads();
  if (tid < 49)
    gnm::edge_block_store(gnm::conj_right(A, M, tid / 7, tid % 7), tid / 7,
                          tid % 7, a.Hout + 196LL * e);
  if (tid < 7) {
    const float gj = gnm::conj_vec(M, g0, tid);
    a.gout[14LL * e + tid] = -gj;
    a.gout[14LL * e + 7 + tid] = gj;
  }

  __threadfence();
  __syncthreads();
  assemble_runs(a, e, runs);
}

}  // namespace

extern "C" int ba_edge_terms_launch(
    const float* T, const int* ii, const int* jj, const float* XCi,
    const float* XCj, const int* sidx, const float* wq, const float* mask,
    float* part, int* count, const int* order, const int* run_of,
    const int* run_start, const int* run_len, const int* run_key,
    const int* block_run, int* run_count, float* Hout, float* gout,
    float* Hd, float* gd, int E, int P, int bpe, int raw, int mode,
    int img_w, int K_cap, float sig0, float sig1, float sig2, float sig3,
    float huber_k, float fx, float fy, float cx, float cy, float border,
    float umax, float vmax, float z_eps, void* stream) {
  if (E <= 0) return 0;
  BAArgs a = {T,         ii,        jj,      (const float4*)XCi,
              (const float4*)XCj,   sidx,    wq,       mask,
              part,      count,     order,   run_of,   run_start,
              run_len,   run_key,   block_run, run_count,
              Hout,      gout,      Hd,      gd,       E,
              P,         bpe,       raw,     img_w,    K_cap,
              {sig0, sig1, sig2, sig3}, huber_k,
              {fx, fy, cx, cy, border, umax, vmax, z_eps}};
  const dim3 grid((unsigned)bpe, (unsigned)E);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    ba_edge_system<0><<<grid, THREADS, 0, st>>>(a);
  } else if (mode == 1) {
    ba_edge_system<1><<<grid, THREADS, 0, st>>>(a);
  } else {
    ba_edge_system<2><<<grid, THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
