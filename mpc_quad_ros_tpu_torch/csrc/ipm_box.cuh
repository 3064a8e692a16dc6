// The box-QP primal-dual interior point of one scenario, run by one team.
//
// Replaces the IPM core mpc_quad_ros_tpu/ops/pallas/qp_kernel.py::
// ipm_box_solve (inlined in the J-fed fused kernel).  The algorithm is kept,
// the TPU blocking is not: no panel-8 Cholesky, no masked iota selects.
//
//   min 1/2 z'Hz + g'z  s.t.  lb <= z <= ub,   z in R^nz
//
// - Jacobi scaling s = rsqrt(max(diag H, 1e-12)): H' = (H s_i) s_j, g' = g s,
//   lb' = lb / s, ub' = ub / s;
// - cold start: z at the box midpoint, unit duals;
// - exactly `iters` iterations of: mu = 0.1 (sl.zl + su.zu) / (2 nz);
//   r = Hz + g - zl + zu; Cholesky of H + diag(zl/sl + zu/su) with pivots
//   rsqrt(max(., 1e-12)); forward and back substitution; dual steps; the
//   fraction-to-the-boundary step (0.995); slack floor 1e-10 max(width, 1),
//   dual floor 1e-12;
// - result clip(z, lb', ub') * s in the original variables.
//
// Matrices are row-major with leading dimension ld = nz + 1 (odd, so a
// warp's lanes walking a column hit distinct shared-memory banks); only the
// lower triangle of the factor is used.  Vectors are indexed by lane:
// lane l owns entries l, l + size, ...  Every loop that reads what another
// lane wrote is preceded by team.sync().
#pragma once

#include "common.cuh"

namespace mpcq {

template <typename T> struct IpmWork {
  T *Hs, *Lm;                                 // nz x ld each
  T *s, *g, *lb, *ub, *z, *sl, *su, *zl, *zu;  // nz each
  T *res, *y, *sli, *sui, *dinv, *dz, *dzl, *dzu;
  static constexpr int n_vectors = 17;
};

template <typename T> MPCQ_HD T step_ratio(T v, T dv) {
  return dv < T(0) ? -v / dv : T(INFINITY);
}

// H (nz x ld, full symmetric), g, lb, ub: the unscaled QP.  Writes the
// solution to z_out (nz).
template <typename T, typename Team>
MPCQ_HD void ipm_box_solve(const Team& tm, int nz, int ld, int iters, const T* H,
                           const T* g0, const T* lb0, const T* ub0, const IpmWork<T>& w,
                           T* z_out) {
  const int ln = tm.lane, NL = Team::size;

  // ---- Jacobi scaling and cold start ----
  for (int i = ln; i < nz; i += NL) w.s[i] = m_rsqrt(floor_at(H[i * ld + i], T(1e-12)));
  tm.sync();
  for (int e = ln; e < nz * nz; e += NL) {
    int i = e / nz, j = e % nz;
    w.Hs[i * ld + j] = H[i * ld + j] * w.s[i] * w.s[j];
  }
  for (int i = ln; i < nz; i += NL) {
    T s = w.s[i];
    T lb = lb0[i] / s, ub = ub0[i] / s;
    T z = T(0.5) * (lb + ub);
    w.g[i] = g0[i] * s;
    w.lb[i] = lb;
    w.ub[i] = ub;
    w.z[i] = z;
    w.zl[i] = T(1);
    w.zu[i] = T(1);
    w.sl[i] = z - lb;
    w.su[i] = ub - z;
  }
  tm.sync();

  for (int it = 0; it < iters; ++it) {
    // ---- barrier target ----
    T pl = T(0), pu = T(0);
    for (int i = ln; i < nz; i += NL) {
      pl = pl + w.sl[i] * w.zl[i];
      pu = pu + w.su[i] * w.zu[i];
    }
    T mu = T(0.1) * ((tm.sum(pl) + tm.sum(pu)) / T(2 * nz));

    // ---- residual, barrier diagonal, Newton right-hand side and matrix ----
    for (int i = ln; i < nz; i += NL) {
      const T* Hi = w.Hs + i * ld;
      T Hz = Hi[0] * w.z[0];
      for (int j = 1; j < nz; ++j) Hz = Hz + Hi[j] * w.z[j];
      T sl = w.sl[i], su = w.su[i], zl = w.zl[i], zu = w.zu[i];
      T r = Hz + w.g[i] - zl + zu;
      T sli = T(1) / sl, sui = T(1) / su;
      w.sli[i] = sli;
      w.sui[i] = sui;
      w.res[i] = -r + (mu - sl * zl) * sli - (mu - su * zu) * sui;
      T* Li = w.Lm + i * ld;
      for (int j = 0; j < i; ++j) Li[j] = Hi[j];
      Li[i] = Hi[i] + (zl * sli + zu * sui);
    }
    tm.sync();

    // ---- right-looking Cholesky, lower triangle; the diagonal of the
    // factor is kept only as its reciprocal dinv ----
    for (int j = 0; j < nz; ++j) {
      T dj = m_rsqrt(floor_at(w.Lm[j * ld + j], T(1e-12)));
      for (int i = j + 1 + ln; i < nz; i += NL) w.Lm[i * ld + j] = w.Lm[i * ld + j] * dj;
      if (ln == 0) w.dinv[j] = dj;
      tm.sync();
      for (int i = j + 1 + ln; i < nz; i += NL) {
        T* Li = w.Lm + i * ld;
        T lij = Li[j];
        for (int k = j + 1; k <= i; ++k) Li[k] = Li[k] - lij * w.Lm[k * ld + j];
      }
      tm.sync();
    }

    // ---- forward substitution L y = res (column-oriented) ----
    for (int j = 0; j < nz; ++j) {
      T yj = w.res[j] * w.dinv[j];
      for (int i = j + 1 + ln; i < nz; i += NL) w.res[i] = w.res[i] - w.Lm[i * ld + j] * yj;
      if (ln == 0) w.y[j] = yj;
      tm.sync();
    }
    // ---- back substitution L^T dz = y (column-oriented, y overwritten) ----
    for (int j = nz - 1; j >= 0; --j) {
      T dzj = w.y[j] * w.dinv[j];
      for (int i = ln; i < j; i += NL) w.y[i] = w.y[i] - w.Lm[j * ld + i] * dzj;
      if (ln == 0) w.dz[j] = dzj;
      tm.sync();
    }

    // ---- dual steps and fraction-to-the-boundary ----
    T pmin = T(INFINITY);
    for (int i = ln; i < nz; i += NL) {
      T sl = w.sl[i], su = w.su[i], zl = w.zl[i], zu = w.zu[i], dz = w.dz[i];
      T dzl = (mu - sl * zl - zl * dz) * w.sli[i];
      T dzu = (mu - su * zu + zu * dz) * w.sui[i];
      w.dzl[i] = dzl;
      w.dzu[i] = dzu;
      pmin = nan_min(pmin, nan_min(nan_min(step_ratio(sl, dz), step_ratio(su, -dz)),
                                   nan_min(step_ratio(zl, dzl), step_ratio(zu, dzu))));
    }
    T alpha = nan_min(T(1), T(0.995) * tm.min(pmin));

    for (int i = ln; i < nz; i += NL) {
      T lb = w.lb[i], ub = w.ub[i];
      T z = w.z[i] + alpha * w.dz[i];
      T eps = T(1e-10) * floor_at(ub - lb, T(1));
      w.z[i] = z;
      w.sl[i] = floor_at(z - lb, eps);
      w.su[i] = floor_at(ub - z, eps);
      w.zl[i] = floor_at(w.zl[i] + alpha * w.dzl[i], T(1e-12));
      w.zu[i] = floor_at(w.zu[i] + alpha * w.dzu[i], T(1e-12));
    }
    tm.sync();
  }

  for (int i = ln; i < nz; i += NL) z_out[i] = clip(w.z[i], w.lb[i], w.ub[i]) * w.s[i];
  tm.sync();
}

}  // namespace mpcq
