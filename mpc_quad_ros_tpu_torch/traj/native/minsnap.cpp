// Minimum-snap polynomial trajectory optimizer: the native core of
// mpc_quad_ros_tpu_torch/traj/native_minsnap.py (a copy of the JAX package's
// traj/native/minsnap.cpp, so that the port builds its own library).
//
// Waypoints + v_max/a_max in, piecewise 7th-order x/y/z/yaw polynomials out:
// the math of ../minsnap.py, its test oracle.  Per axis, minimise the snap
// integral subject to waypoint interpolation, rest boundaries and C^4
// continuity: an equality-constrained QP solved through its KKT system (dense
// LU with partial pivoting; at <= 300 unknowns a hand-rolled LU is plenty).
// Segment durations start from a trapezoidal-speed guess and are refined by
// uniform time scaling until the sampled max speed/acceleration meet the
// limits.  C API: minsnap_solve, bound with ctypes.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kOrder = 8;  // coefficients per segment (7th-order polynomial)

// ----------------------------------------------------------------------
// Dense linear solve: LU with partial pivoting.  A is n x n (row major),
// b length n; solution overwrites b.  Returns false if singular.
bool lu_solve(std::vector<double>& A, std::vector<double>& b, int n) {
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int col = 0; col < n; ++col) {
    // pivot
    int p = col;
    double best = std::fabs(A[col * n + col]);
    for (int r = col + 1; r < n; ++r) {
      double v = std::fabs(A[r * n + col]);
      if (v > best) { best = v; p = r; }
    }
    if (best < 1e-14) return false;
    if (p != col) {
      for (int k = 0; k < n; ++k) std::swap(A[col * n + k], A[p * n + k]);
      std::swap(b[col], b[p]);
    }
    const double d = A[col * n + col];
    for (int r = col + 1; r < n; ++r) {
      const double f = A[r * n + col] / d;
      if (f == 0.0) continue;
      A[r * n + col] = 0.0;
      for (int k = col + 1; k < n; ++k) A[r * n + k] -= f * A[col * n + k];
      b[r] -= f * b[col];
    }
  }
  // back substitution
  for (int r = n - 1; r >= 0; --r) {
    double s = b[r];
    for (int k = r + 1; k < n; ++k) s -= A[r * n + k] * b[k];
    b[r] = s / A[r * n + r];
  }
  return true;
}

// Gram matrix of the snap inner product on tau in [0,1].
void snap_gram_unit(double Q[kOrder][kOrder]) {
  std::memset(Q, 0, sizeof(double) * kOrder * kOrder);
  for (int i = 4; i < kOrder; ++i) {
    for (int k = 4; k < kOrder; ++k) {
      const double ci = i * (i - 1) * (i - 2) * (i - 3);
      const double ck = k * (k - 1) * (k - 2) * (k - 3);
      Q[i][k] = ci * ck / (i + k - 7);
    }
  }
}

// Row evaluating the m-th tau-derivative at tau.
void deriv_row(int m, double tau, double row[kOrder]) {
  std::memset(row, 0, sizeof(double) * kOrder);
  for (int k = m; k < kOrder; ++k) {
    double fac = 1.0;
    for (int j = 0; j < m; ++j) fac *= (k - j);
    row[k] = fac * std::pow(tau, k - m);
  }
}

// Min-snap KKT solve for one axis.  way: K+1 waypoints, T: K durations.
// out: K * kOrder real-time ascending-power coefficients.
bool solve_axis(const std::vector<double>& way, const std::vector<double>& T,
                std::vector<double>& out) {
  const int K = static_cast<int>(T.size());
  const int n = kOrder * K;

  double Qu[kOrder][kOrder];
  snap_gram_unit(Qu);

  // constraint rows
  struct Con { int seg1; double row1[kOrder]; int seg2; double row2[kOrder]; double b; };
  std::vector<Con> cons;
  double row[kOrder], row2[kOrder];

  for (int j = 0; j < K; ++j) {
    Con c1{}; c1.seg1 = j; c1.seg2 = -1; deriv_row(0, 0.0, c1.row1); c1.b = way[j];
    cons.push_back(c1);
    Con c2{}; c2.seg1 = j; c2.seg2 = -1; deriv_row(0, 1.0, c2.row1); c2.b = way[j + 1];
    cons.push_back(c2);
  }
  for (int m = 1; m < 4; ++m) {
    Con c1{}; c1.seg1 = 0; c1.seg2 = -1; deriv_row(m, 0.0, c1.row1); c1.b = 0.0;
    cons.push_back(c1);
    Con c2{}; c2.seg1 = K - 1; c2.seg2 = -1; deriv_row(m, 1.0, c2.row1); c2.b = 0.0;
    cons.push_back(c2);
  }
  for (int j = 0; j + 1 < K; ++j) {
    for (int m = 1; m <= 4; ++m) {
      Con c{};
      c.seg1 = j; deriv_row(m, 1.0, row);
      const double s1 = std::pow(T[j], m);
      for (int k = 0; k < kOrder; ++k) c.row1[k] = row[k] / s1;
      c.seg2 = j + 1; deriv_row(m, 0.0, row2);
      const double s2 = std::pow(T[j + 1], m);
      for (int k = 0; k < kOrder; ++k) c.row2[k] = -row2[k] / s2;
      c.b = 0.0;
      cons.push_back(c);
    }
  }

  const int mcon = static_cast<int>(cons.size());
  const int dim = n + mcon;
  std::vector<double> KKT(static_cast<size_t>(dim) * dim, 0.0);
  std::vector<double> rhs(dim, 0.0);

  // 2Q + eps*I
  for (int j = 0; j < K; ++j) {
    const double scale = 2.0 / std::pow(T[j], 7);
    for (int a = 0; a < kOrder; ++a)
      for (int b2 = 0; b2 < kOrder; ++b2)
        KKT[(size_t)(j * kOrder + a) * dim + (j * kOrder + b2)] = scale * Qu[a][b2];
    for (int a = 0; a < kOrder; ++a)
      KKT[(size_t)(j * kOrder + a) * dim + (j * kOrder + a)] += 1e-9;
  }
  // A and A^T
  for (int c = 0; c < mcon; ++c) {
    const Con& cn = cons[c];
    const int r = n + c;
    for (int k = 0; k < kOrder; ++k) {
      const int col1 = cn.seg1 * kOrder + k;
      KKT[(size_t)r * dim + col1] = cn.row1[k];
      KKT[(size_t)col1 * dim + r] = cn.row1[k];
      if (cn.seg2 >= 0) {
        const int col2 = cn.seg2 * kOrder + k;
        KKT[(size_t)r * dim + col2] = cn.row2[k];
        KKT[(size_t)col2 * dim + r] = cn.row2[k];
      }
    }
    rhs[r] = cn.b;
  }

  if (!lu_solve(KKT, rhs, dim)) return false;

  out.assign(n, 0.0);
  for (int j = 0; j < K; ++j) {
    double p = 1.0;
    for (int k = 0; k < kOrder; ++k) {
      out[j * kOrder + k] = rhs[j * kOrder + k] / p;  // tau -> real time
      p *= T[j];
    }
  }
  return true;
}

// Horner evaluation of the m-th derivative at local time t.
double poly_eval_deriv(const double* c, int m, double t) {
  double buf[kOrder];
  for (int k = 0; k < kOrder; ++k) buf[k] = c[k];
  int len = kOrder;
  for (int d = 0; d < m; ++d) {
    for (int k = 1; k < len; ++k) buf[k - 1] = buf[k] * k;
    len -= 1;
  }
  double v = 0.0;
  for (int k = len - 1; k >= 0; --k) v = v * t + buf[k];
  return v;
}

}  // namespace

extern "C" {

// waypoints: n_wp x 3 row-major.  out_durations: (n_wp-1).  out_coeffs:
// (n_wp-1) x 4 x 8 row-major (x, y, z, yaw ascending powers, real time).
// Returns 0 on success.
int minsnap_solve(const double* waypoints, int n_wp, double v_max, double a_max,
                  int max_scaling_iters, double* out_durations, double* out_coeffs) {
  if (n_wp < 2 || v_max <= 0 || a_max <= 0) return 1;
  const int K = n_wp - 1;

  // trapezoidal initial durations
  std::vector<double> T(K);
  for (int j = 0; j < K; ++j) {
    double d = 0.0;
    for (int ax = 0; ax < 3; ++ax) {
      const double diff = waypoints[(j + 1) * 3 + ax] - waypoints[j * 3 + ax];
      d += diff * diff;
    }
    d = std::sqrt(d);
    if (d < 1e-3) d = 1e-3;
    T[j] = (d < v_max * v_max / a_max) ? 2.0 * std::sqrt(d / a_max)
                                       : d / v_max + v_max / a_max;
  }

  std::vector<double> coeffs[3];
  auto build = [&]() -> bool {
    for (int ax = 0; ax < 3; ++ax) {
      std::vector<double> way(n_wp);
      for (int i = 0; i < n_wp; ++i) way[i] = waypoints[i * 3 + ax];
      if (!solve_axis(way, T, coeffs[ax])) return false;
    }
    return true;
  };
  if (!build()) return 2;

  for (int it = 0; it < max_scaling_iters; ++it) {
    // sample max |v|, |a|
    double total = 0.0;
    for (int j = 0; j < K; ++j) total += T[j];
    double dt = total / 2000.0;
    if (dt < 1e-3) dt = 1e-3;
    double vmax_cur = 0.0, amax_cur = 0.0;
    int seg = 0;
    double seg_start = 0.0;
    for (double t = 0.0; t < total; t += dt) {
      while (seg + 1 < K && t >= seg_start + T[seg]) { seg_start += T[seg]; ++seg; }
      const double tau = t - seg_start;
      double v2 = 0.0, a2 = 0.0;
      for (int ax = 0; ax < 3; ++ax) {
        const double* c = &coeffs[ax][seg * kOrder];
        const double v = poly_eval_deriv(c, 1, tau);
        const double a = poly_eval_deriv(c, 2, tau);
        v2 += v * v;
        a2 += a * a;
      }
      if (v2 > vmax_cur) vmax_cur = v2;
      if (a2 > amax_cur) amax_cur = a2;
    }
    vmax_cur = std::sqrt(vmax_cur);
    amax_cur = std::sqrt(amax_cur);
    double s = vmax_cur / v_max;
    const double sa = std::sqrt(amax_cur / a_max);
    if (sa > s) s = sa;
    if (s >= 0.99 && s <= 1.01) break;
    if (s < 0.5) s = 0.5;
    if (s > 2.0) s = 2.0;
    for (int j = 0; j < K; ++j) T[j] *= s;
    if (!build()) return 2;
  }

  for (int j = 0; j < K; ++j) {
    out_durations[j] = T[j];
    for (int ax = 0; ax < 3; ++ax)
      for (int k = 0; k < kOrder; ++k)
        out_coeffs[(j * 4 + ax) * kOrder + k] = coeffs[ax][j * kOrder + k];
    for (int k = 0; k < kOrder; ++k)  // yaw polynomial = 0
      out_coeffs[(j * 4 + 3) * kOrder + k] = 0.0;
  }
  return 0;
}

}  // extern "C"
