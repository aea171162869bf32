// Host build of the device arithmetic of mast3r_slam_tpu_torch/csrc/
// gn_math.cuh, for tests/test_torch_gn_math.py (built there with
// g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC). Each function runs
// the same gnm:: functions the kernels run; where a kernel spreads work
// over threads and blocks, the loop here does the same steps one after
// the other.

#include "gn_math.cuh"

namespace {

gnm::Intr intr_of(const float* k) {
  return {k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]};
}

}  // namespace

extern "C" {

int h_solve7(const float* H, const float* g, float* tau) {
  return gnm::solve7(H, g, tau) ? 1 : 0;
}

void h_retr(const float* T, const float* xi, float* out) {
  gnm::sim3_store(gnm::sim3_retr(gnm::sim3_load(T), xi), out);
}

// Ti^-1 Tj, as every block of the BA kernel computes it
void h_rel(const float* Ti, const float* Tj, float* out) {
  gnm::sim3_store(gnm::sim3_mul(gnm::sim3_inv(gnm::sim3_load(Ti)),
                                gnm::sim3_load(Tj)),
                  out);
}

int h_converged(float rel_error, float delta_norm, float old_cost,
                float new_cost, const float* tau) {
  return gnm::converged(rel_error, delta_norm, old_cost, new_cost, tau) ? 1
                                                                         : 0;
}

// The last block of an edge: M from Ti, S = (M S0) M^T, the 14x14 layout
// and [-M g0, M g0]; S0 (7x7, full), g0 (7)
void h_edge_conj(const float* Ti, const float* S0, const float* g0,
                 float* H14, float* g14) {
  float M[49], A[49];
  gnm::adj_inv_matrix(gnm::sim3_load(Ti), M);
  for (int k = 0; k < 49; ++k) A[k] = gnm::conj_left(M, S0, k / 7, k % 7);
  for (int k = 0; k < 49; ++k)
    gnm::edge_block_store(gnm::conj_right(A, M, k / 7, k % 7), k / 7, k % 7,
                          H14);
  for (int i = 0; i < 7; ++i) {
    float gj = gnm::conj_vec(M, g0, i);
    g14[i] = -gj;
    g14[7 + i] = gj;
  }
}

// The assembly: Hd (7K, 7K) and gd (7K) from the edge blocks
// H14 (E, 14, 14) and g14 (E, 14) and the first n_runs runs of the plan
// (slam/ba.py::_assembly_plan); the kernel sums each run in the block that
// completes it and writes zeros where no run writes
void h_assemble(const float* H14, const float* g14, const int* order,
                const int* run_start, const int* run_len, const int* run_key,
                int n_runs, int E, int K, float* Hd, float* gd) {
  const long long D = 7LL * K;
  for (long long c = 0; c < D * D; ++c) Hd[c] = 0.0f;
  for (long long r = 0; r < D; ++r) gd[r] = 0.0f;
  for (int h = 0; h < n_runs; ++h) {
    const long long r0 = 7LL * (run_key[h] / K), c0 = 7LL * (run_key[h] % K);
    for (int k = 0; k < 49; ++k)
      Hd[(r0 + k / 7) * D + c0 + k % 7] =
          gnm::run_sum(order, run_start[h], run_len[h], H14, E, k);
    if (r0 == c0)
      for (int r = 0; r < 7; ++r)
        gd[r0 + r] = gnm::run_grad(order, run_start[h], run_len[h], g14, E, r);
  }
}

// One edge's 35 sums in point order, then S0 (7x7, full) and g0 (7), as
// the BA kernel's blocks and the last block of the edge compute them
void h_edge_sums(int mode, const float* Tij, const float* XCi,
                 const float* XCj, const int* sidx, const float* wq,
                 float edge_mask, int P, const float* sig, float huber_k,
                 int img_w, const float* intr, float* S0, float* g0) {
  float acc[gnm::NACC_BA] = {};
  const gnm::Pose pose = gnm::load_pose(Tij);
  const gnm::Intr k = intr_of(intr);
  for (int p = 0; p < P; ++p) {
    const float* a = XCi + 4 * p;
    const float* b = XCj + 4 * p;
    if (mode == 0)
      gnm::ba_point<0>(pose, a, b, wq[p], 0, img_w, edge_mask, sig, huber_k,
                       k, acc);
    else if (mode == 1)
      gnm::ba_point<1>(pose, a, b, wq[p], sidx[p], img_w, edge_mask, sig,
                       huber_k, k, acc);
    else
      gnm::ba_point<2>(pose, a, b, wq[p], 0, img_w, edge_mask, sig, huber_k,
                       k, acc);
  }
  for (int i = 0; i < 49; ++i) S0[i] = acc[gnm::upper_index(i / 7, i % 7)];
  for (int i = 0; i < 7; ++i) g0[i] = acc[gnm::NH + i];
}

// The tracker's solve with one block: per iteration the 36 sums of every
// point in order (gnm::gn_point), then the finish of the kernel's lead
// thread (gnm::gn_finish). Returns the iterations run; T_out (8), cost,
// failed.
int h_track(int mode, const float* T0, const float* Xf, const float* tgt,
            const float* si, int N, float huber_k, const float* intr,
            int max_iters, float rel_error, float delta_norm, float* T_out,
            float* cost, int* failed_out) {
  const gnm::Intr k = intr_of(intr);
  gnm::Sim3 T = gnm::sim3_load(T0);
  float old_cost = INFINITY;
  bool failed = false;
  int it = 0;
  *cost = INFINITY;
  while (it < max_iters) {
    float Tf[8];
    gnm::sim3_store(T, Tf);
    const gnm::Pose P = gnm::load_pose(Tf);
    float acc[gnm::NACC_GN] = {};
    for (int i = 0; i < N; ++i) {
      float t[4], s[4];
      for (int r = 0; r < (mode == 0 ? 4 : 3); ++r) {
        t[r] = tgt[r * N + i];
        s[r] = si[r * N + i];
      }
      if (mode == 0)
        gnm::gn_point<0>(P, Xf + 3 * i, t, s, huber_k, k, acc);
      else
        gnm::gn_point<1>(P, Xf + 3 * i, t, s, huber_k, k, acc);
    }
    float lin[57];
    gnm::gn_linearization(acc, lin);
    const bool done =
        gnm::gn_finish(lin, T, old_cost, failed, rel_error, delta_norm);
    *cost = lin[56];
    ++it;
    if (done) break;
  }
  gnm::sim3_store(T, T_out);
  *failed_out = failed ? 1 : 0;
  return it;
}

}  // extern "C"
