// Gauss-Newton arithmetic shared by gn_step.cu (tracker) and
// ba_edge_terms.cu (global bundle adjustment):
//
// * per point: Sim(3) action, the three residuals with their closed-form
//   7-column pose Jacobians, the Huber weight, and the accumulation of one
//   point's rows into the upper triangle of the 7x7 normal matrix;
// * per tracker iteration: the equilibrated 7x7 Cholesky solve, the Sim(3)
//   retraction and the convergence test (slam/tracker.py::_solve7,
//   lie/sim3.py::retr, robust.py::converged);
// * per BA edge: Ti^-1 Tj, the inverse-adjoint conjugation of the edge's
//   7x7 sums and its [[S, -S], [-S, S]] layout, and the sums of the
//   assembly into the dense system in the plain version's order
//   (slam/ba.py::_edge_terms, _assemble).
//
// Everything here is plain float arithmetic in the operation order of the
// plain PyTorch versions (slam/tracker.py, slam/ba.py, lie/sim3.py), which
// follow the JAX package (slam/tracker.py:60-195, slam/ba.py:88-152,
// :180-298, :394-429, lie/sim3.py). No term is skipped for being
// structurally zero: 0 * NaN must stay NaN, as it does in the plain
// versions. The file includes nothing but <math.h>, so it also compiles as
// host C++ (g++ -ffp-contract=off): tests/test_torch_gn_math.py runs the
// same functions on the CPU through tests/gn_math_harness.cpp.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define GNM_HD __host__ __device__ __forceinline__
#else
#define GNM_HD inline
#endif

// A load of data that other blocks of the same launch wrote: through L2,
// never a stale L1 line (a plain load on the host)
#if defined(__CUDA_ARCH__)
#define GNM_LOAD_L2(p) __ldcg(p)
#else
#define GNM_LOAD_L2(p) (*(p))
#endif

namespace gnm {

constexpr int NH = 28;          // upper triangle of a symmetric 7x7
constexpr int NACC_BA = 35;     // NH + 7 gradient entries
constexpr int NACC_GN = 36;     // NH + 7 gradient entries + cost

struct Intr {
  float fx, fy, cx, cy;
  float border;   // pixel border (may be negative)
  float umax;     // w - 1 - border
  float vmax;     // h - 1 - border
  float z_eps;
};

struct Pose {
  float t[3];
  float R[9];
  float s;
};

// max(a, lo) that keeps NaN, like torch.clamp(min=lo) and jnp.maximum
// (fmaxf would return lo)
GNM_HD float max_nan(float a, float lo) {
  return (a != a) ? a : (a > lo ? a : lo);
}

// robust.huber: 1 inside k, k / |r| outside; NaN stays NaN
GNM_HD float huber_w(float r, float k) {
  float a = fabsf(r);
  return a < k ? 1.0f : k / max_nan(a, 1e-30f);
}

// T = [tx ty tz qx qy qz qw s]; R as sim3.quat_to_matrix builds it
GNM_HD Pose load_pose(const float* T) {
  Pose P;
  P.t[0] = T[0];
  P.t[1] = T[1];
  P.t[2] = T[2];
  float x = T[3], y = T[4], z = T[5], w = T[6];
  P.s = T[7];
  float x2 = x * x, y2 = y * y, z2 = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  P.R[0] = 1.0f - 2.0f * (y2 + z2);
  P.R[1] = 2.0f * (xy - wz);
  P.R[2] = 2.0f * (xz + wy);
  P.R[3] = 2.0f * (xy + wz);
  P.R[4] = 1.0f - 2.0f * (x2 + z2);
  P.R[5] = 2.0f * (yz - wx);
  P.R[6] = 2.0f * (xz - wy);
  P.R[7] = 2.0f * (yz + wx);
  P.R[8] = 1.0f - 2.0f * (x2 + y2);
  return P;
}

// Y = s (R X) + t
GNM_HD void act(const Pose& P, const float X[3], float Y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float rx = (P.R[3 * i] * X[0] + P.R[3 * i + 1] * X[1]) +
               P.R[3 * i + 2] * X[2];
    Y[i] = P.s * rx + P.t[i];
  }
}

// [ray(3), dist]; a point at the origin gives NaN rays, as in the plain
// versions
GNM_HD void ray_dist(const float Y[3], float rd[4]) {
  float d = sqrtf((Y[0] * Y[0] + Y[1] * Y[1]) + Y[2] * Y[2]);
  rd[0] = Y[0] / d;
  rd[1] = Y[1] / d;
  rd[2] = Y[2] / d;
  rd[3] = d;
}

// d[ray, dist] / d(left Sim3 perturbation), from rd = [r, d]
GNM_HD void ray_jac(const float rd[4], float J[4][7]) {
  float rx = rd[0], ry = rd[1], rz = rd[2], d = rd[3];
  float di = 1.0f / d;
  J[0][0] = (1.0f - rx * rx) * di;
  J[0][1] = -rx * ry * di;
  J[0][2] = -rx * rz * di;
  J[0][3] = 0.0f;
  J[0][4] = rz;
  J[0][5] = -ry;
  J[0][6] = 0.0f;
  J[1][0] = -rx * ry * di;
  J[1][1] = (1.0f - ry * ry) * di;
  J[1][2] = -ry * rz * di;
  J[1][3] = -rz;
  J[1][4] = 0.0f;
  J[1][5] = rx;
  J[1][6] = 0.0f;
  J[2][0] = -rx * rz * di;
  J[2][1] = -ry * rz * di;
  J[2][2] = (1.0f - rz * rz) * di;
  J[2][3] = ry;
  J[2][4] = -rx;
  J[2][5] = 0.0f;
  J[2][6] = 0.0f;
  J[3][0] = rx;
  J[3][1] = ry;
  J[3][2] = rz;
  J[3][3] = 0.0f;
  J[3][4] = 0.0f;
  J[3][5] = 0.0f;
  J[3][6] = d;
}

// [u, v, log z] and the in-image & in-front test
GNM_HD bool calib_proj(const float Y[3], const Intr& k, float pz[3]) {
  bool valid_z = Y[2] > k.z_eps;
  float z_safe = valid_z ? Y[2] : 1.0f;
  float zi = 1.0f / z_safe;
  float u = k.fx * Y[0] * zi + k.cx;
  float v = k.fy * Y[1] * zi + k.cy;
  pz[0] = u;
  pz[1] = v;
  pz[2] = valid_z ? logf(z_safe) : 0.0f;
  return (u > k.border) && (u < k.umax) && (v > k.border) && (v < k.vmax) &&
         valid_z;
}

// d[u, v, log z] / d(left Sim3 perturbation); zero rows behind the camera
GNM_HD void calib_jac(const float Y[3], const Intr& k, float J[3][7]) {
  float x = Y[0], y = Y[1], zc = Y[2];
  bool valid = zc > k.z_eps;
  float zi = valid ? 1.0f / zc : 0.0f;
  float xz = x * zi;
  float yz = y * zi;
  float one = valid ? 1.0f : 0.0f;
  float fx = k.fx, fy = k.fy;
  J[0][0] = fx * zi;
  J[0][1] = 0.0f;
  J[0][2] = -fx * xz * zi;
  J[0][3] = -fx * xz * yz;
  J[0][4] = fx * (one + xz * xz);
  J[0][5] = -fx * yz;
  J[0][6] = 0.0f;
  J[1][0] = 0.0f;
  J[1][1] = fy * zi;
  J[1][2] = -fy * yz * zi;
  J[1][3] = -fy * (one + yz * yz);
  J[1][4] = fy * xz * yz;
  J[1][5] = fy * xz;
  J[1][6] = 0.0f;
  J[2][0] = 0.0f;
  J[2][1] = 0.0f;
  J[2][2] = zi;
  J[2][3] = yz;
  J[2][4] = -xz;
  J[2][5] = 0.0f;
  J[2][6] = one;
}

// d(Y) / d(left Sim3 perturbation) = [I | -skew(Y) | Y]
GNM_HD void point_jac(const float Y[3], float J[3][7]) {
  float x = Y[0], y = Y[1], zc = Y[2];
  J[0][0] = 1.0f;
  J[0][1] = 0.0f;
  J[0][2] = 0.0f;
  J[0][3] = 0.0f;
  J[0][4] = zc;
  J[0][5] = -y;
  J[0][6] = x;
  J[1][0] = 0.0f;
  J[1][1] = 1.0f;
  J[1][2] = 0.0f;
  J[1][3] = -zc;
  J[1][4] = 0.0f;
  J[1][5] = x;
  J[1][6] = y;
  J[2][0] = 0.0f;
  J[2][1] = 0.0f;
  J[2][2] = 1.0f;
  J[2][3] = y;
  J[2][4] = -x;
  J[2][5] = 0.0f;
  J[2][6] = zc;
}

// One residual row: A = a * J_row (7), b = a * e;
// acc[0:28] += upper(A A^T), acc[28:35] += b * A. Returns b.
GNM_HD float accum_row(float a, float e, const float Jrow[7], float* acc) {
  float A[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) A[c] = a * Jrow[c];
  float b = a * e;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int j = i; j < 7; ++j) {
      acc[k] += A[i] * A[j];
      ++k;
    }
  }
#pragma unroll
  for (int c = 0; c < 7; ++c) acc[NH + c] += b * A[c];
  return b;
}

// Position of (i, j) of a symmetric 7x7 in the packed upper triangle
GNM_HD int upper_index(int i, int j) {
  if (i > j) {
    int t = i;
    i = j;
    j = t;
  }
  return i * 7 - (i * (i - 1)) / 2 + (j - i);
}

// -- tracker (frame -> keyframe), one point --------------------------------
//
// MODE 0: ray + distance, 4 rows, tgt = [ray_k, dist_k].
// MODE 1: pixel + log depth, 3 rows, tgt = [u_k, v_k, log z_k]; the rows'
//         sqrt-information is zeroed where the point projects outside.
// si: per-row sqrt-information; acc: NACC_GN accumulators. The Jacobian of
// the residual tgt - f(T X) is -J_f; the gradient's sign is applied when
// the sums are finished.
template <int MODE>
GNM_HD void gn_point(const Pose& P, const float X[3], const float* tgt,
                     const float* si, float huber_k, const Intr& k,
                     float* acc) {
  constexpr int NR = MODE == 0 ? 4 : 3;
  float Y[3];
  act(P, X, Y);
  float f[4];
  float J[4][7];
  float gate = 1.0f;
  if (MODE == 0) {
    ray_dist(Y, f);
    ray_jac(f, J);
  } else {
    gate = calib_proj(Y, k, f) ? 1.0f : 0.0f;
    calib_jac(Y, k, J);
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float res = tgt[r] - f[r];
    float w = MODE == 0 ? si[r] : gate * si[r];
    float rsi = w * sqrtf(huber_w(w * res, huber_k));
    float Jn[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) Jn[c] = -J[r][c];
    float b = accum_row(rsi, res, Jn, acc);
    acc[NACC_GN - 1] += b * b;
  }
}

// -- bundle adjustment, one matched point of one edge ----------------------
//
// MODE 0 rays (4 rows), 1 calib (3 rows), 2 points (3 rows). Xi: the
// matched point of keyframe i; Xj: the measurement pixel's point of
// keyframe j, moved by P = Tij. wq: sqrt(Q) where the match passed the
// pose-independent gates (valid match, Q and both confidences above their
// thresholds), else 0 (slam/ba.py::_edge_weights); sig: 1 / sigma per row.
// safe_idx: index of the matched pixel in keyframe i (calib only).
template <int MODE>
GNM_HD void ba_point(const Pose& P, const float Xi[3], const float Xj[3],
                     float wq, int safe_idx, int img_w, float edge_mask,
                     const float* sig, float huber_k, const Intr& k,
                     float* acc) {
  constexpr int NR = MODE == 0 ? 4 : 3;
  float Y[3];
  act(P, Xj, Y);
  float err[4];
  float J[4][7];
  bool extra = true;
  if (MODE == 0) {
    float rd_i[4], rd_j[4];
    ray_dist(Xi, rd_i);
    ray_dist(Y, rd_j);
#pragma unroll
    for (int r = 0; r < 4; ++r) err[r] = rd_j[r] - rd_i[r];
    ray_jac(rd_j, J);
  } else if (MODE == 1) {
    float u_t = (float)(safe_idx % img_w);
    float v_t = (float)(safe_idx / img_w);
    float pz[3];
    bool valid_proj = calib_proj(Y, k, pz);
    float zi = Xi[2];
    bool valid_zi = zi > k.z_eps;
    float log_zi = valid_zi ? logf(zi) : 0.0f;
    err[0] = pz[0] - u_t;
    err[1] = pz[1] - v_t;
    err[2] = pz[2] - log_zi;
    calib_jac(Y, k, J);
    extra = valid_proj && valid_zi;
  } else {
#pragma unroll
    for (int r = 0; r < 3; ++r) err[r] = Y[r] - Xi[r];
    point_jac(Y, J);
  }
  // sig * wq is sig * sqrt(Q) where the gates pass and sig * 0 = 0 where
  // they fail: the same bits as the plain version's where(valid, sig *
  // sqrt(Q), 0)
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float sw = extra ? sig[r] * wq : 0.0f;
    float w = huber_w(sw * err[r], huber_k) * sw * sw;
    w = w * edge_mask;
    float rw = sqrtf(w);
    accum_row(rw, err[r], J[r], acc);
  }
}

// -- Sim(3) on [tx ty tz qx qy qz qw s] (lie/sim3.py) -----------------------

struct Sim3 {
  float t[3];
  float q[4];   // x y z w
  float s;
};

GNM_HD Sim3 sim3_load(const float* T) {
  Sim3 S;
  for (int i = 0; i < 3; ++i) S.t[i] = T[i];
  for (int i = 0; i < 4; ++i) S.q[i] = T[3 + i];
  S.s = T[7];
  return S;
}

GNM_HD void sim3_store(const Sim3& S, float* T) {
  for (int i = 0; i < 3; ++i) T[i] = S.t[i];
  for (int i = 0; i < 4; ++i) T[3 + i] = S.q[i];
  T[7] = S.s;
}

GNM_HD void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// R(q) v = v + w uv + qv x uv, uv = 2 qv x v (sim3.quat_act)
GNM_HD void quat_act(const float q[4], const float v[3], float out[3]) {
  float uv[3], c[3];
  cross3(q, v, uv);
  for (int i = 0; i < 3; ++i) uv[i] = 2.0f * uv[i];
  cross3(q, uv, c);
  for (int i = 0; i < 3; ++i) out[i] = (v[i] + q[3] * uv[i]) + c[i];
}

// Hamilton product (sim3.quat_mul)
GNM_HD void quat_mul(const float a[4], const float b[4], float out[4]) {
  float xi = a[0], yi = a[1], zi = a[2], wi = a[3];
  float xj = b[0], yj = b[1], zj = b[2], wj = b[3];
  out[0] = ((wi * xj + xi * wj) + yi * zj) - zi * yj;
  out[1] = ((wi * yj - xi * zj) + yi * wj) + zi * xj;
  out[2] = ((wi * zj + xi * yj) - yi * xj) + zi * wj;
  out[3] = ((wi * wj - xi * xj) - yi * yj) - zi * zj;
}

// Ta * Tb with the quaternion renormalized (sim3.mul)
GNM_HD Sim3 sim3_mul(const Sim3& a, const Sim3& b) {
  Sim3 r;
  float q[4];
  quat_mul(a.q, b.q, q);
  float n = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) r.q[i] = q[i] / n;
  float at[3];
  quat_act(a.q, b.t, at);
  for (int i = 0; i < 3; ++i) r.t[i] = a.s * at[i] + a.t[i];
  r.s = a.s * b.s;
  return r;
}

// sim3.inv
GNM_HD Sim3 sim3_inv(const Sim3& a) {
  Sim3 r;
  r.q[0] = -a.q[0];
  r.q[1] = -a.q[1];
  r.q[2] = -a.q[2];
  r.q[3] = a.q[3];
  r.s = 1.0f / a.s;
  float v[3];
  quat_act(r.q, a.t, v);
  for (int i = 0; i < 3; ++i) r.t[i] = -r.s * v[i];
  return r;
}

// sim3.exp_so3_quat
GNM_HD void exp_so3_quat(const float phi[3], float q[4]) {
  float theta_sq = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
  float theta_p4 = theta_sq * theta_sq;
  bool small = theta_sq < 1e-6f;
  float theta = sqrtf(small ? 1.0f : theta_sq);
  float imag = small ? (0.5f - theta_sq / 48.0f) + theta_p4 / 3840.0f
                     : sinf(0.5f * theta) / theta;
  float real = small ? (1.0f - theta_sq / 8.0f) + theta_p4 / 384.0f
                     : cosf(0.5f * theta);
  for (int i = 0; i < 3; ++i) q[i] = imag * phi[i];
  q[3] = real;
}

// A, B, C of W = C I + A Phi + B Phi^2 (sim3._w_coefficients), with its
// small-angle, small-sigma and tiny-sigma branches
GNM_HD void w_coefficients(float theta_sq, float theta, float sigma,
                           float scale, float& A, float& B, float& C) {
  bool s_tiny = fabsf(sigma) < 1e-20f;
  bool s_small = fabsf(sigma) < 0.1f;
  bool t_small = theta < 1e-2f;
  float safe_theta_sq = t_small ? 1.0f : theta_sq;
  float safe_theta = t_small ? 1.0f : theta;
  float safe_sigma = s_tiny ? 1.0f : sigma;
  float sigma_sq = sigma * sigma;
  float em1 = expm1f(sigma);
  C = s_tiny ? 1.0f + 0.5f * sigma : em1 / safe_sigma;
  const float c3 = (float)(1.0 / 3.0), c8 = (float)(1.0 / 8.0);
  const float c30 = (float)(1.0 / 30.0), c6 = (float)(1.0 / 6.0);
  const float c20 = (float)(1.0 / 20.0), c72 = (float)(1.0 / 72.0);
  float A_ts = (((0.5f - theta_sq / 24.0f) + sigma * c3) + sigma_sq * c8) +
               sigma * sigma_sq * c30;
  float B_ts = (((c6 - theta_sq / 120.0f) + sigma * c8) + sigma_sq * c20) +
               sigma * sigma_sq * c72;
  float safe_sigma_sq = s_small ? 1.0f : sigma_sq;
  float A_tl = (sigma * scale - em1) / safe_sigma_sq;
  float B_tl = ((0.5f * sigma_sq * scale + em1) - sigma * scale) /
               (safe_sigma_sq * safe_sigma);
  float A_t = s_small ? A_ts : A_tl;
  float B_t = s_small ? B_ts : B_tl;
  float a = scale * sinf(theta);
  float b = scale * cosf(theta);
  float c = theta_sq + sigma_sq;
  float safe_c = t_small ? 1.0f : c;
  float A_g = (a * sigma + (1.0f - b) * theta) / (safe_theta * safe_c);
  float B_g = (C - ((b - 1.0f) * sigma + a * theta) / safe_c) / safe_theta_sq;
  A = t_small ? A_t : A_g;
  B = t_small ? B_t : B_g;
}

// sim3.exp: [tau, omega, sigma] -> embedded
GNM_HD Sim3 sim3_exp(const float xi[7]) {
  Sim3 r;
  const float* tau = xi;
  const float* phi = xi + 3;
  float sigma = xi[6];
  float scale = expf(sigma);
  exp_so3_quat(phi, r.q);
  float theta_sq = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
  float theta = theta_sq < 1e-12f ? 0.0f : sqrtf(theta_sq);
  float A, B, C;
  w_coefficients(theta_sq, theta, sigma, scale, A, B, C);
  float pt[3], ppt[3];
  cross3(phi, tau, pt);
  cross3(phi, pt, ppt);
  for (int i = 0; i < 3; ++i) r.t[i] = (C * tau[i] + A * pt[i]) + B * ppt[i];
  r.s = scale;
  return r;
}

// left retraction exp(xi) * T (sim3.retr)
GNM_HD Sim3 sim3_retr(const Sim3& T, const float xi[7]) {
  return sim3_mul(sim3_exp(xi), T);
}

// -- tracker: one iteration's solve, retraction and convergence test -------

// x - x is 0 for finite x, NaN for inf and NaN (no fast-math here)
GNM_HD bool is_finite(float x) { return x - x == 0.0f; }

// Jacobi-equilibrated Cholesky of the 7x7 system with a 1e-8 ridge
// (tracker._solve7): ok needs a factorization with positive pivots, a
// finite step and max diag(H) > 0 (an all-zero H factors thanks to the
// ridge but must fail). tau = 0 where not ok.
GNM_HD bool solve7(const float H[49], const float g[7], float tau[7]) {
  float dinv[7];
  bool diag_nan = false;
  float dmax = -INFINITY;
  for (int i = 0; i < 7; ++i) {
    float h = H[8 * i];
    dinv[i] = 1.0f / sqrtf(max_nan(h, 1e-12f));
    if (h != h) diag_nan = true;
    else if (h > dmax) dmax = h;
  }
  float L[49];
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j <= i; ++j) {
      float v = (H[7 * i + j] * dinv[i]) * dinv[j];
      L[7 * i + j] = i == j ? v + 1e-8f : v;
    }
  bool ok = !diag_nan && dmax > 0.0f;
  for (int j = 0; j < 7 && ok; ++j) {
    float s = L[8 * j];
    for (int k = 0; k < j; ++k) s -= L[7 * j + k] * L[7 * j + k];
    if (!(s > 0.0f)) {
      ok = false;
      break;
    }
    s = sqrtf(s);
    L[8 * j] = s;
    for (int i = j + 1; i < 7; ++i) {
      float v = L[7 * i + j];
      for (int k = 0; k < j; ++k) v -= L[7 * i + k] * L[7 * j + k];
      L[7 * i + j] = v / s;
    }
  }
  float y[7];
  for (int i = 0; i < 7; ++i) {
    float v = g[i] * dinv[i];
    for (int k = 0; k < i; ++k) v -= L[7 * i + k] * y[k];
    y[i] = v / L[8 * i];
  }
  for (int i = 6; i >= 0; --i) {
    float v = y[i];
    for (int k = i + 1; k < 7; ++k) v -= L[7 * k + i] * tau[k];
    tau[i] = v / L[8 * i];
  }
  for (int i = 0; i < 7; ++i) {
    tau[i] = tau[i] * dinv[i];
    ok = ok && is_finite(tau[i]);
  }
  if (!ok)
    for (int i = 0; i < 7; ++i) tau[i] = 0.0f;
  return ok;
}

// relative cost decrease or step norm below its threshold
// (robust.converged); a non-finite old cost never counts as converged by
// the cost
GNM_HD bool converged(float rel_error, float delta_norm, float old_cost,
                      float new_cost, const float tau[7]) {
  bool finite_old = is_finite(old_cost);
  float safe_old = (finite_old && old_cost != 0.0f) ? old_cost : 1.0f;
  float rel_dec = fabsf((old_cost - new_cost) / safe_old);
  if (!finite_old) rel_dec = INFINITY;
  float s = 0.0f;
  for (int i = 0; i < 7; ++i) s += tau[i] * tau[i];
  return (rel_dec < rel_error) || (sqrtf(s) < delta_norm);
}

// The NACC_GN sums of one linearization -> [H (49), g (7), cost]
GNM_HD void gn_linearization(const float* sums, float lin[57]) {
  for (int k = 0; k < 49; ++k) lin[k] = sums[upper_index(k / 7, k % 7)];
  for (int c = 0; c < 7; ++c) lin[49 + c] = -sums[NH + c];
  lin[56] = 0.5f * sums[NACC_GN - 1];
}

// One iteration of the tracker's loop after its linearization
// (tracker._run_gn; JAX tracker.py:175-186): T <- retr(T, tau) if the
// solve is ok, failed |= !ok, old_cost <- cost. Returns whether the loop
// ends here (converged or failed).
GNM_HD bool gn_finish(const float lin[57], Sim3& T, float& old_cost,
                      bool& failed, float rel_error, float delta_norm) {
  float tau[7];
  bool ok = solve7(lin, lin + 49, tau);
  if (ok) T = sim3_retr(T, tau);
  float cost = lin[56];
  bool conv = converged(rel_error, delta_norm, old_cost, cost, tau);
  failed = failed || !ok;
  old_cost = cost;
  return conv || !ok;
}

// -- bundle adjustment: per-edge conjugation and the assembly ---------------

// The 7x7 M with M v == sim3.apply_adj_inv_T(T, v) (ba._adj_inv_matrix)
GNM_HD void adj_inv_matrix(const Sim3& T, float M[49]) {
  float Tf[8];
  sim3_store(T, Tf);
  Pose R = load_pose(Tf);
  float s_inv = 1.0f / T.s;
  for (int k = 0; k < 49; ++k) M[k] = 0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      // skew(t) @ R, row i: [[0, -tz, ty], [tz, 0, -tx], [-ty, tx, 0]]
      float sk[3];
      sk[0] = i == 0 ? 0.0f : (i == 1 ? T.t[2] : -T.t[1]);
      sk[1] = i == 0 ? -T.t[2] : (i == 1 ? 0.0f : T.t[0]);
      sk[2] = i == 0 ? T.t[1] : (i == 1 ? -T.t[0] : 0.0f);
      float sR = (sk[0] * R.R[j] + sk[1] * R.R[3 + j]) + sk[2] * R.R[6 + j];
      M[7 * i + j] = s_inv * R.R[3 * i + j];
      M[7 * (3 + i) + j] = s_inv * sR;
      M[7 * (3 + i) + 3 + j] = R.R[3 * i + j];
    }
  for (int j = 0; j < 3; ++j) {
    float tR = (T.t[0] * R.R[j] + T.t[1] * R.R[3 + j]) + T.t[2] * R.R[6 + j];
    M[7 * 6 + j] = s_inv * tR;
  }
  M[48] = 1.0f;
}

// (M S0)[i][j], then S[i][j] = (A M^T)[i][j], then (M g0)[i]: the order of
// the plain version's M @ S0 @ M^T and M @ g0
GNM_HD float conj_left(const float M[49], const float S0[49], int i, int j) {
  float s = 0.0f;
  for (int k = 0; k < 7; ++k) s += M[7 * i + k] * S0[7 * k + j];
  return s;
}

GNM_HD float conj_right(const float A[49], const float M[49], int i, int j) {
  float s = 0.0f;
  for (int k = 0; k < 7; ++k) s += A[7 * i + k] * M[7 * j + k];
  return s;
}

GNM_HD float conj_vec(const float M[49], const float g0[7], int i) {
  float s = 0.0f;
  for (int k = 0; k < 7; ++k) s += M[7 * i + k] * g0[k];
  return s;
}

// S[i][j] into the edge's 14x14 block [[S, -S], [-S, S]]
GNM_HD void edge_block_store(float s, int i, int j, float* H14) {
  H14[14 * i + j] = s;
  H14[14 * i + 7 + j] = -s;
  H14[14 * (7 + i) + j] = -s;
  H14[14 * (7 + i) + 7 + j] = s;
}

// The assembly follows a plan made once per solve (slam/ba.py::
// _assembly_plan). Contribution c = t E + e is block type t (0: (i, i),
// 1: (i, j), 2: (j, i), 3: (j, j)) of edge e. `order` lists the
// contributions sorted by destination 7x7 block and, within one block, by
// c: the order in which the plain version's four index_put_ calls add
// them. A run is the contributions to one destination block.

// Offset of entry k of contribution type t in its edge's 14x14 block
GNM_HD int contrib_offset(int t, int k) {
  return 14 * ((t < 2 ? 0 : 7) + k / 7) + ((t & 1) == 0 ? 0 : 7) + k % 7;
}

// Both sums below load GNM_BATCH values before they add them in order, so
// that the loads of a batch are in flight together
constexpr int GNM_BATCH = 8;

// Entry k of a destination block: the len contributions of its run, from
// position start of order on, in order
GNM_HD float run_sum(const int* order, int start, int len, const float* H14,
                     int E, int k) {
  float sum = 0.0f;
  for (int j0 = 0; j0 < len; j0 += GNM_BATCH) {
    float x[GNM_BATCH];
#pragma unroll
    for (int q = 0; q < GNM_BATCH; ++q) {
      const int c = j0 + q < len ? order[start + j0 + q] : 0;
      x[q] = j0 + q < len
                 ? GNM_LOAD_L2(H14 + 196 * (c % E) + contrib_offset(c / E, k))
                 : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < GNM_BATCH; ++q)
      if (j0 + q < len) sum += x[q];
  }
  return sum;
}

// Entry r of slot a's gradient, from the run of its diagonal block (a, a):
// gi of the run's type-0 contributions (the edges with si == a, in edge
// order), then gj of its type-3 ones (sj == a), as the plain version's two
// index_put_ calls add them
GNM_HD float run_grad(const int* order, int start, int len, const float* g14,
                      int E, int r) {
  float sum = 0.0f;
  for (int j0 = 0; j0 < len; j0 += GNM_BATCH) {
    bool use[GNM_BATCH];
    float x[GNM_BATCH];
#pragma unroll
    for (int q = 0; q < GNM_BATCH; ++q) {
      const int c = j0 + q < len ? order[start + j0 + q] : 0;
      const int t = c / E;
      use[q] = j0 + q < len && (t == 0 || t == 3);
      x[q] = use[q] ? GNM_LOAD_L2(g14 + 14 * (c % E) + (t == 0 ? 0 : 7) + r)
                    : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < GNM_BATCH; ++q)
      if (use[q]) sum += x[q];
  }
  return sum;
}

}  // namespace gnm
