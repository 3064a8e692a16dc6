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
// - cold start: z at the box midpoint, unit duals; or, given the previous
//   solve's duals zl0, zu0 (unscaled), the warm start: z = clip(0,
//   lb' + WS_GAMMA w, ub' - WS_GAMMA w) with w = ub' - lb', and
//   zl = max(zl0 s, WS_FLOOR), zu likewise;
// - exactly `iters` iterations of: mu = 0.1 (sl.zl + su.zu) / (2 nz);
//   r = Hz + g - zl + zu; Cholesky of H + diag(zl/sl + zu/su) with pivots
//   rsqrt(max(., 1e-12)); forward and back substitution; dual steps; the
//   fraction-to-the-boundary step (0.995); slack floor 1e-10 max(width, 1),
//   dual floor 1e-12;
// - result clip(z, lb', ub') * s in the original variables, and the duals
//   zl / s, zu / s (unscaled, on both starts).
//
// Kernel B runs this definition; kernels E and F (box_qp.cuh's
// box_qp_solve) compute every element as this code does, on a schedule of
// their own, and their host builds are held to this one bit for bit, so the
// pipelines solve the same QP to the same bits (as the Pallas consumers
// share ipm_box_solve).
//
// Where the data lives.  One nz x (nz + 1) matrix A per scenario (row-major,
// ld = nz + 1, odd, so lanes walking a column or a row hit distinct banks):
// H's strict upper triangle in place, its diagonal in the spare column nz,
// and the factor in the lower triangle, diagonal included, rebuilt from H
// every iteration.  The scaled matrix is never stored: H'(i, j) =
// (H(i, j) s_i) s_j is formed where it is read.  s and z lie in shared
// memory (every lane reads all of them in H z), beside a table of the
// (row, column) pairs of the flattened strict lower triangle, 16 bits each,
// built once a solve; every other vector lies in registers, lane l holding
// entries l, l + size, ... in its R slots (nz <= R size), and y_j, dz_j
// travel from their owner by team.bcast.
//
// What bounds it on the H100, and what the design does about it.  A
// scenario is a chain of nz dependent Cholesky columns and 2 nz dependent
// substitution steps per iteration on one warp, whose latency only many
// resident warps hide; with enough of them (16 a SM for kernel B at nz =
// 40) the SM's instruction issue and shared-memory accesses bind, most of
// them the Cholesky's trailing updates.  So: one matrix, two vectors and
// the triangle table in shared memory (8.4 KB at nz = 40); the Cholesky by
// panels of CHOL_PANEL columns, the trailing block past a panel updated in
// one pass split evenly over the lanes as a flattened triangle (each
// element's coordinates one table read: a trailing triangle is a prefix of
// the whole one), each element loaded and stored once a panel rather than
// once a column, its CHOL_PANEL updates from the panel's columns, stored
// scaled (two loads an update, no multiply); a panel's own columns one
// step a column, a lane a row, one sync a step; the substitutions'
// right-hand sides in registers, each step one shuffle instead of a
// shared-memory round trip through lane 0.
//
// The arithmetic of every element is the previous design's: each multiply
// is written as the fused multiply-add (fmadd) or the rounded product
// (mul_rn) that design compiled to, so no compiler choice of what to fuse is
// left (with the vectors in registers it would otherwise fuse or share
// products differently in kernels B, E and F); the update of L(i, k) runs
// over the columns in order and H z over j in order, whatever lane does it.
#pragma once

#include "common.cuh"

namespace mpcq {

// The warm start's primal margin (a fraction of the scaled box width) and
// dual floor (in the scaled system): WS_GAMMA and WS_FLOOR of the JAX kernel.
constexpr double WS_GAMMA = 0.01, WS_FLOOR = 1e-3;

// a b + c with one rounding (fmadd) and a b rounded on its own (mul_rn):
// on the card one instruction each that the compiler may neither fuse nor
// split; on the host, which contracts nothing, the plain operators.
#if defined(__CUDA_ARCH__)
MPCQ_HD float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
MPCQ_HD double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
MPCQ_HD float mul_rn(float a, float b) { return __fmul_rn(a, b); }
MPCQ_HD double mul_rn(double a, double b) { return __dmul_rn(a, b); }
#else
template <typename T> MPCQ_HD T fmadd(T a, T b, T c) { return a * b + c; }
template <typename T> MPCQ_HD T mul_rn(T a, T b) { return a * b; }
#endif

// Elements of the packed matrix A (nz x (nz + 1)).
MPCQ_HD int64_t packed_size(int nz) { return int64_t(nz) * (nz + 1); }

// Elements of T (4 bytes or more) the triangle table takes: one 16-bit
// (row, column) pair per element of the strict lower triangle.
MPCQ_HD int64_t tri_table_size(int nz) { return (int64_t(nz) * (nz - 1) / 2 + 1) / 2; }

// Elements of T of the IPM's vectors in shared memory: s, z, the table.
MPCQ_HD int64_t ipm_vec_size(int nz) { return 2 * int64_t(nz) + tri_table_size(nz); }

// Elements of T the IPM takes in shared memory: A, then its vectors.
MPCQ_HD int64_t ipm_ws_size(int nz) { return packed_size(nz) + ipm_vec_size(nz); }

// H(i, j) of the packed matrix (ld = nz + 1): the upper triangle in place,
// the lower by symmetry, the diagonal in the spare column; one address,
// no branch.
template <typename T> MPCQ_HD T h_sym(const T* A, int ld, int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return A[lo * ld + (i == j ? ld - 1 : hi)];
}

// Columns of the Cholesky factored together (a panel).
constexpr int CHOL_PANEL = 4;

// A (nz x (nz + 1)): H packed as above; its upper triangle and spare column
// are left as they came, its lower triangle holds the last factor.  vec:
// ipm_vec_size(nz) elements of shared memory (s, z, the table).  g0, lb0,
// ub0: the unscaled QP (shared or device memory).  zl0, zu0: the previous
// duals (unscaled), or null for the cold start.  Writes the solution to
// z_out and the duals to zl_out, zu_out (nz each), then syncs.  Needs
// nz <= R Team::size and nz <= 256.
template <int R, typename T, typename Team>
MPCQ_HD void ipm_box_solve(const Team& tm, int nz, int iters, T* A, T* vec, const T* g0,
                           const T* lb0, const T* ub0, const T* zl0, const T* zu0, T* z_out,
                           T* zl_out, T* zu_out) {
  const int ln = tm.lane, NL = Team::size, ld = nz + 1;
  const bool warm = zl0 != nullptr;
  T* s_sh = vec;
  T* z_sh = vec + nz;
  // (row, column) of flat element e of the strict lower triangle of an
  // m x m trailing block, as row << 8 | column; the block of any column is a
  // prefix of column 0's
  uint16_t* tri = reinterpret_cast<uint16_t*>(vec + 2 * nz);
  {
    const int m = nz - 1, total = m * (m + 1) / 2;
    TriWalk w(ln);
    for (int e = ln; e < total; e += NL, w.advance(NL)) tri[e] = uint16_t(w.a << 8 | w.c);
  }
  // lane-owned entries i = ln + NL r; v is the Newton right-hand side, then
  // y, then dz
  T s[R], g[R], lb[R], ub[R], z[R], sl[R], su[R], zl[R], zu[R], dinv[R], v[R], hz[R];
  auto own = [&](int r) { return ln + NL * r; };

  // ---- Jacobi scaling and the cold or warm start ----
  MPCQ_UNROLL
  for (int r = 0; r < R; ++r) {
    s[r] = g[r] = lb[r] = ub[r] = z[r] = sl[r] = su[r] = zl[r] = zu[r] = T(0);
    dinv[r] = v[r] = hz[r] = T(0);
    const int i = own(r);
    if (i >= nz) continue;
    const T si = m_rsqrt(floor_at(A[i * ld + nz], T(1e-12)));
    const T l = lb0[i] / si, u = ub0[i] / si;
    T zi;
    if (warm) {
      const T margin = mul_rn(T(WS_GAMMA), u - l);
      zi = clip(T(0), l + margin, u - margin);
      zl[r] = floor_at(mul_rn(zl0[i], si), T(WS_FLOOR));
      zu[r] = floor_at(mul_rn(zu0[i], si), T(WS_FLOOR));
    } else {
      zi = mul_rn(T(0.5), l + u);
      zl[r] = T(1);
      zu[r] = T(1);
    }
    s[r] = si;
    g[r] = mul_rn(g0[i], si);
    lb[r] = l;
    ub[r] = u;
    z[r] = zi;
    sl[r] = zi - l;
    su[r] = u - zi;
    s_sh[i] = si;
    z_sh[i] = zi;
  }
  tm.sync();

  for (int it = 0; it < iters; ++it) {
    // ---- barrier target ----
    T pl = T(0), pu = T(0);
    MPCQ_UNROLL
    for (int r = 0; r < R; ++r) {
      if (own(r) >= nz) continue;
      pl = fmadd(sl[r], zl[r], pl);
      pu = fmadd(su[r], zu[r], pu);
    }
    T mu = mul_rn(T(0.1), (tm.sum(pl) + tm.sum(pu)) / T(2 * nz));

    // ---- H'z, row i summed over j in order ----
    {
      const T s0 = s_sh[0], z0 = z_sh[0];
      MPCQ_UNROLL
      for (int r = 0; r < R; ++r)
        if (own(r) < nz) hz[r] = mul_rn(mul_rn(mul_rn(h_sym(A, ld, own(r), 0), s[r]), s0), z0);
    }
    for (int j = 1; j < nz; ++j) {
      const T sj = s_sh[j], zj = z_sh[j];
      MPCQ_UNROLL
      for (int r = 0; r < R; ++r)
        if (own(r) < nz) hz[r] = fmadd(mul_rn(mul_rn(h_sym(A, ld, own(r), j), s[r]), sj), zj, hz[r]);
    }

    // ---- residual, barrier diagonal, Newton right-hand side; the
    // factor's diagonal ----
    MPCQ_UNROLL
    for (int r = 0; r < R; ++r) {
      const int i = own(r);
      if (i >= nz) continue;
      T res = hz[r] + g[r] - zl[r] + zu[r];
      const T a = T(1) / sl[r], b = T(1) / su[r];
      v[r] = fmadd(-fmadd(-su[r], zu[r], mu), b, fmadd(fmadd(-sl[r], zl[r], mu), a, -res));
      A[i * ld + i] = mul_rn(mul_rn(A[i * ld + nz], s[r]), s[r]) + fmadd(zl[r], a, mul_rn(zu[r], b));
    }
    // ---- the factor's strict lower triangle: H' from the upper, spread
    // evenly over the lanes ----
    {
      const int m = nz - 1, total = m * (m + 1) / 2;
      for (int e = ln; e < total; e += NL) {
        const int code = tri[e], i = (code >> 8) + 1, j = code & 255;
        A[i * ld + j] = mul_rn(mul_rn(A[j * ld + i], s_sh[i]), s_sh[j]);
      }
    }
    tm.sync();

    // ---- right-looking Cholesky, lower triangle, by panels of CHOL_PANEL
    // columns.  Step j of a panel: d_j, then each lane takes rows i > j
    // (lane-strided): l = L(i, j) d_j, stored scaled where i is past the
    // panel, and L(i, k) -= l (L(k, j) d_j) for the panel's columns k > j,
    // k <= i; every lane forms the panel rows' L(k, j) d_j itself, and those
    // entries are stored scaled after the panel's last step.  Then the
    // trailing block past the panel takes the panel's columns in one pass:
    // each element loaded once, its updates in column order, stored once.
    // Every element's products are those of the column-by-column form, in
    // its order.  The factor's diagonal is kept only as its reciprocal d
    // (dinv) ----
    for (int j0 = 0; j0 < nz; j0 += CHOL_PANEL) {
      const int pe = j0 + CHOL_PANEL < nz ? j0 + CHOL_PANEL : nz;
      for (int j = j0; j < pe; ++j) {
        const T dj = m_rsqrt(floor_at(A[j * ld + j], T(1e-12)));
        MPCQ_UNROLL
        for (int r = 0; r < R; ++r)
          if (own(r) == j) dinv[r] = dj;
        T lk[CHOL_PANEL - 1];
        MPCQ_UNROLL
        for (int q = 0; q < CHOL_PANEL - 1; ++q)
          lk[q] = j + 1 + q < pe ? mul_rn(A[(j + 1 + q) * ld + j], dj) : T(0);
        for (int i = j + 1 + ln; i < nz; i += NL) {
          const T lij = mul_rn(A[i * ld + j], dj);
          if (i >= pe) A[i * ld + j] = lij;
          MPCQ_UNROLL
          for (int q = 0; q < CHOL_PANEL - 1; ++q) {
            const int k = j + 1 + q;
            if (k < pe && k <= i) A[i * ld + k] = fmadd(-lij, lk[q], A[i * ld + k]);
          }
        }
        tm.sync();
      }
      // the panel rows of its columns, scaled (a lane a column)
      for (int j = j0 + ln; j < pe; j += NL) {
        const T dj = m_rsqrt(floor_at(A[j * ld + j], T(1e-12)));
        for (int i = j + 1; i < pe; ++i) A[i * ld + j] = mul_rn(A[i * ld + j], dj);
      }
      // the trailing block (pe + a, pe + c), c <= a, over the flattened
      // triangle, a prefix of the table's (only a full panel leaves one)
      const int m = nz - pe, total = m * (m + 1) / 2, base = pe * (ld + 1);
      for (int e = ln; e < total; e += NL) {
        const int code = tri[e], a = code >> 8, c = code & 255;
        const int at = base + a * ld + c, ai = (pe + a) * ld + j0, ak = (pe + c) * ld + j0;
        T x = A[at];
        MPCQ_UNROLL
        for (int p = 0; p < CHOL_PANEL; ++p) x = fmadd(-A[ai + p], A[ak + p], x);
        A[at] = x;
      }
      tm.sync();
    }

    // ---- forward substitution L y = v (column-oriented): y_j from its
    // owner, lane jl of slot jb ----
    MPCQ_UNROLL
    for (int jb = 0; jb < R; ++jb) {
      for (int jl = 0; jl < NL; ++jl) {
        const int j = jb * NL + jl;
        if (j >= nz) break;
        const T yj = tm.bcast(mul_rn(v[jb], dinv[jb]), jl);
        MPCQ_UNROLL
        for (int r = jb; r < R; ++r) {
          const int i = own(r);
          if (i > j && i < nz) v[r] = fmadd(-A[i * ld + j], yj, v[r]);
        }
        if (ln == jl) v[jb] = yj;
      }
    }
    // ---- back substitution L^T dz = y (column-oriented) ----
    MPCQ_UNROLL
    for (int jb = R - 1; jb >= 0; --jb) {
      for (int jl = NL - 1; jl >= 0; --jl) {
        const int j = jb * NL + jl;
        if (j >= nz) continue;
        const T dzj = tm.bcast(mul_rn(v[jb], dinv[jb]), jl);
        MPCQ_UNROLL
        for (int r = 0; r <= jb; ++r) {
          const int i = own(r);
          if (i < j) v[r] = fmadd(-A[j * ld + i], dzj, v[r]);
        }
        if (ln == jl) v[jb] = dzj;
      }
    }

    // ---- dual steps and fraction-to-the-boundary ----
    T pmin = T(INFINITY);
    T dzl[R], dzu[R];
    MPCQ_UNROLL
    for (int r = 0; r < R; ++r) {
      dzl[r] = dzu[r] = T(0);
      if (own(r) >= nz) continue;
      const T dz = v[r];
      // 1 / sl and 1 / su formed again: held through the factorisation they
      // cost kernel B registers past its 80
      dzl[r] = mul_rn(fmadd(-zl[r], dz, fmadd(-sl[r], zl[r], mu)), T(1) / sl[r]);
      dzu[r] = mul_rn(fmadd(zu[r], dz, fmadd(-su[r], zu[r], mu)), T(1) / su[r]);
      pmin = nan_min(pmin, nan_min(nan_min(step_ratio(sl[r], dz), step_ratio(su[r], -dz)),
                                   nan_min(step_ratio(zl[r], dzl[r]), step_ratio(zu[r], dzu[r]))));
    }
    T alpha = nan_min(T(1), mul_rn(T(0.995), tm.min(pmin)));

    MPCQ_UNROLL
    for (int r = 0; r < R; ++r) {
      const int i = own(r);
      if (i >= nz) continue;
      T zi = fmadd(alpha, v[r], z[r]);
      T eps = mul_rn(T(1e-10), floor_at(ub[r] - lb[r], T(1)));
      z[r] = zi;
      z_sh[i] = zi;
      sl[r] = floor_at(zi - lb[r], eps);
      su[r] = floor_at(ub[r] - zi, eps);
      zl[r] = floor_at(fmadd(alpha, dzl[r], zl[r]), T(1e-12));
      zu[r] = floor_at(fmadd(alpha, dzu[r], zu[r]), T(1e-12));
    }
    tm.sync();
  }

  MPCQ_UNROLL
  for (int r = 0; r < R; ++r) {
    const int i = own(r);
    if (i >= nz) continue;
    z_out[i] = mul_rn(clip(z[r], lb[r], ub[r]), s[r]);
    zl_out[i] = zl[r] / s[r];
    zu_out[i] = zu[r] / s[r];
  }
  tm.sync();
}

}  // namespace mpcq
