// Per-point Gauss-Newton arithmetic shared by gn_step.cu (tracker) and
// ba_edge_terms.cu (global bundle adjustment): Sim(3) action, the three
// residuals with their closed-form 7-column pose Jacobians, the Huber
// weight, and the accumulation of one point's rows into the upper triangle
// of the 7x7 normal matrix.
//
// Everything here is plain float arithmetic in the operation order of the
// plain PyTorch versions (slam/tracker.py::gn_step_plain,
// slam/ba.py::ba_edge_terms_plain), which follow the JAX package
// (slam/tracker.py:60-150, slam/ba.py:88-152, :259-285). No term is
// skipped for being structurally zero: 0 * NaN must stay NaN, as it does in
// the plain versions. The functions also compile as host C++, so the
// arithmetic can be exercised without a GPU.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define GNM_HD __host__ __device__ __forceinline__
#else
#define GNM_HD inline
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
// keyframe j, moved by P = Tij. sig: 1 / sigma per row. safe_idx: index of
// the matched pixel in keyframe i (calib only).
struct BAGate {
  float Q_conf, C_conf, huber_k;
};

template <int MODE>
GNM_HD void ba_point(const Pose& P, const float Xi[3], float Ci,
                     const float Xj[3], float Cj, float Q, bool vmatch,
                     int safe_idx, int img_w, float edge_mask,
                     const float* sig, const BAGate& gt, const Intr& k,
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
  bool valid = vmatch && (Q > gt.Q_conf) && (Ci > gt.C_conf) &&
               (Cj > gt.C_conf) && extra;
  float sq = sqrtf(Q);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float sw = valid ? sig[r] * sq : 0.0f;
    float w = huber_w(sw * err[r], gt.huber_k) * sw * sw;
    w = w * edge_mask;
    float rw = sqrtf(w);
    accum_row(rw, err[r], J[r], acc);
  }
}

}  // namespace gnm
