// Kernel E's schedule of the box-QP interior point, which kernel F runs too.
//
// The bits are ipm_box.cuh's (ipm_box_solve, kernel B's): every element is
// computed by the same operations in the same order (each product an fmadd
// or mul_rn, H z over j in order, each factor element's updates in column
// order, the barrier target's sum in the warp's order), so the three
// pipelines still agree bitwise.  Only the schedule differs: box_qp_solve
// runs on a team of a whole warp (WarpTeam) or of half a warp
// (HalfWarpTeam, two scenarios a warp instruction), on a slot of shared
// memory laid out for 16-byte accesses, with a table of the triangle's
// strips that a block's teams share.
//
// What bounds it on the H100.  A scenario is a chain of dependent steps
// (nz substitution steps each way, a Cholesky panel after panel) and ~29 k
// multiply-adds an iteration at nz = 40; with enough scenarios resident to
// hide the chains, the SM's shared-memory wavefronts (the trailing update's
// quads) and instruction issue bind.  The design cuts the instructions a
// scenario:
//
// - A slot has a row stride ld, a multiple of four with ld / 4 odd (44 at
//   nz = 40): rows are 16-byte aligned and eight consecutive rows' quads
//   lie in distinct banks.  Row i holds H's strict upper triangle in place,
//   its diagonal in column nz, g'_i, s_i and z_i in the last three columns,
//   and the factor in the lower triangle (its diagonal the pivots'
//   reciprocals d_j, which the substitutions read).
// - The strict lower triangle H'(i, j) = (H(j, i) s_i) s_j is filled first
//   each iteration, so H z reads row i as 16-byte quads (the lower part as
//   filled, the upper part scaled where it is read).
// - The Cholesky by panels of four columns: every lane factors the panel's
//   4 x 4 diagonal block in registers, then each lane takes whole rows past
//   the panel (one quad load, four steps in registers, one quad store).
//   The trailing block is updated by strips of four elements of a row (one
//   table entry: the row's panel quads, the four columns' panel quads, the
//   strip's quad of x, one quad store), the strips ordered by columns of
//   four, last first, so the trailing block of every panel is a prefix of
//   the table.  Panels go in pairs: the first's columns update only the
//   second's quad of columns, and after the second is factored both (eight
//   columns) update the rest in one pass, each strip loaded and stored once
//   a pair.  Four syncs a pair of panels, against ten.
// - The forward substitution reads each lane's row of L a quad at a time.
// - Registers are what bounds a block of many half-warp teams: the slacks,
//   s and z are read from the slot's columns where they are needed, the
//   lane is read afresh rather than held through the loop, and the back
//   substitution's loop is kept rolled.
#pragma once

#include "ipm_box.cuh"

namespace mpcq {

// Rows of the packed matrix, rounded up to whole quads (the strips read
// four rows from a strip's column).
MPCQ_HD int box_qp_rows(int nz) { return (nz + 3) & ~3; }
// Its row stride: room for H's row, its diagonal, g, s and z, a multiple
// of four with an odd number of quads.
MPCQ_HD int box_qp_ld(int nz) {
  const int ld = (nz + 7) & ~3;
  return (ld >> 2) & 1 ? ld : ld + 4;
}
// Strips (R, C), C a multiple of 4 and C <= R < nz, with C >= pe.
MPCQ_HD int box_qp_strips(int nz, int pe) {
  const int Q = (nz + 3) / 4, a = (pe + 3) / 4, n = Q - a;
  return n > 0 ? n * (nz - 2 * (a + Q - 1)) : 0;
}
// Elements of T of the strip table (16 bits a strip), in whole quads.
template <typename T> MPCQ_HD int64_t box_qp_table_size(int nz) {
  const int64_t quad = 4 * int64_t(sizeof(T));
  return (2 * int64_t(box_qp_strips(nz, 0)) + quad - 1) / quad * 4;
}
// Elements of T of one scenario: the packed matrix with g', s and z.
MPCQ_HD int64_t box_qp_slot_size(int nz) { return int64_t(box_qp_rows(nz)) * box_qp_ld(nz); }
// Elements of T of a block of `scenarios`: the table, then their slots.
template <typename T> MPCQ_HD int64_t box_qp_block_size(int nz, int scenarios) {
  return box_qp_table_size<T>(nz) + scenarios * box_qp_slot_size(nz);
}

// The strip table, lane-strided over a team or block of `nt` threads: entry
// e is R << 8 | C, the columns' quads from the last to the first, each
// column's rows top-down.  The strips of the trailing block past column pe
// are the first box_qp_strips(nz, pe).
MPCQ_HD void box_qp_table(int lane, int nt, int nz, uint16_t* tbl) {
  const int total = box_qp_strips(nz, 0);
  for (int e = lane; e < total; e += nt) {
    int C = ((nz + 3) / 4 - 1) * 4, f = e;
    while (f >= nz - C) {
      f -= nz - C;
      C -= 4;
    }
    tbl[e] = uint16_t((C + f) << 8 | C);
  }
}

// Two consecutive elements of shared memory (8-byte aligned on the card).
template <typename T> struct Pair { T a, b; };
MPCQ_HD Pair<float> load2s(const float* src) {
#if defined(__CUDA_ARCH__)
  const float2 v = *reinterpret_cast<const float2*>(src);
  return {v.x, v.y};
#else
  return {src[0], src[1]};
#endif
}
MPCQ_HD Pair<double> load2s(const double* src) { return {src[0], src[1]}; }

// The sum over a team's virtual lanes of the partials p (HalfWarpTeam:
// p[0] lane l's, p[1] lane l + 16's; any other team: p[0]).
template <typename Team, typename T> MPCQ_HD T team_sum(const Team& tm, const T (&p)[2]) {
  if constexpr (Team::size == 16) return tm.sum2(p[0], p[1]);
  else return tm.sum(p[0]);
}

// The slacks (sl, su) of an entry at zi in the box [lb, ub]: as the start
// sets them, then floored at 1e-10 max(ub - lb, 1) as each step leaves them.
template <typename T> MPCQ_HD void box_qp_slacks(T zi, T lb, T ub, bool first, T& sl, T& su) {
  if (first) {
    sl = zi - lb;
    su = ub - zi;
    return;
  }
  const T eps = mul_rn(T(1e-10), floor_at(ub - lb, T(1)));
  sl = floor_at(zi - lb, eps);
  su = floor_at(ub - zi, eps);
}

// A term of H'z: the first of row i's sum a rounded product, then
// multiply-adds in j order.
template <bool First, typename T> MPCQ_HD T hz_term(T hz, T hij, T zj, int t) {
  return First && t == 0 ? mul_rn(hij, zj) : fmadd(hij, zj, hz);
}

// One panel [j0, pe) of the Cholesky (see box_qp_scenario): its diagonal
// block factored in every lane's registers, the rows past it stored
// scaled, a sync, then lane 0 stores the block's scaled columns and its
// d_u on the diagonal.
template <typename T, typename Team>
MPCQ_HD void box_qp_panel(const Team& tm, T* A, int ld, int nz, int j0, int pe) {
  const int ln = tm.lane, NL = Team::size;
  Quad<T> xb[4];
  MPCQ_UNROLL
  for (int k = 0; k < 4; ++k) xb[k] = load4s(A + (j0 + k) * ld + j0);
  T d[4], l[4][4];
  MPCQ_UNROLL
  for (int u = 0; u < 4; ++u) {
    d[u] = m_rsqrt(floor_at(xb[u].v[u], T(1e-12)));
    MPCQ_UNROLL
    for (int k = u + 1; k < 4; ++k) l[k][u] = mul_rn(xb[k].v[u], d[u]);
    MPCQ_UNROLL
    for (int k = u + 1; k < 4; ++k)
      MPCQ_UNROLL
      for (int k2 = u + 1; k2 <= k; ++k2) xb[k].v[k2] = fmadd(-l[k][u], l[k2][u], xb[k].v[k2]);
  }
  MPCQ_NO_UNROLL
  for (int i = pe + ln; i < nz; i += NL) {
    Quad<T> y = load4s(A + i * ld + j0);
    T li[4];
    MPCQ_UNROLL
    for (int u = 0; u < 4; ++u) {
      li[u] = mul_rn(y.v[u], d[u]);
      MPCQ_UNROLL
      for (int k2 = u + 1; k2 < 4; ++k2) y.v[k2] = fmadd(-li[u], l[k2][u], y.v[k2]);
    }
    store4(A + i * ld + j0, li[0], li[1], li[2], li[3]);
  }
  tm.sync();
  if (ln == 0) {
    MPCQ_UNROLL
    for (int u = 0; u < 4; ++u) {
      if (j0 + u >= pe) break;
      A[(j0 + u) * ld + j0 + u] = d[u];
      MPCQ_UNROLL
      for (int k = u + 1; k < 4; ++k)
        if (j0 + k < pe) A[(j0 + k) * ld + j0 + u] = l[k][u];
    }
  }
}

// The trailing update by strips [e0, e1) of the table: x(Rw, C + t) -=
// sum_p L(Rw, j0 + p) L(C + t, j0 + p) over the P * 4 columns from j0, in
// order, each strip loaded and stored once.
template <int P, typename T>
MPCQ_HD void box_qp_update(int lane, int nl, const uint16_t* tbl, T* A, int ld, int e0, int e1,
                           int j0) {
  MPCQ_NO_UNROLL
  for (int e = e0 + lane; e < e1; e += nl) {
    const int code = tbl[e], Rw = code >> 8, C = code & 255;
    Quad<T> a[P];
    MPCQ_UNROLL
    for (int h = 0; h < P; ++h) a[h] = load4s(A + Rw * ld + j0 + 4 * h);
    Quad<T> x = load4s(A + Rw * ld + C);
    MPCQ_UNROLL
    for (int t = 0; t < 4; ++t)
      MPCQ_UNROLL
      for (int h = 0; h < P; ++h) {
        const Quad<T> c = load4s(A + (C + t) * ld + j0 + 4 * h);
        MPCQ_UNROLL
        for (int p = 0; p < 4; ++p) x.v[t] = fmadd(-a[h].v[p], c.v[p], x.v[t]);
      }
    if (C + 3 <= Rw) {
      store4(A + Rw * ld + C, x.v[0], x.v[1], x.v[2], x.v[3]);
    } else {
      MPCQ_UNROLL
      for (int t = 0; t < 4; ++t)
        if (C + t <= Rw) A[Rw * ld + C + t] = x.v[t];
    }
  }
}

// The IPM of one scenario on its slot A, whose rows hold H's strict upper
// triangle in place and its diagonal in column nz (the lower triangle and
// the last three columns are the IPM's own); g0, lb0, ub0 and the optional
// warm duals zl0, zu0 lie in shared or device memory.  out(i, z_i, zl_i,
// zu_i) takes the solution and the unscaled duals of the lane's entries,
// after the last iteration; the slot's upper triangle and column nz are
// left as they came.
template <int R, typename T, typename Team, typename Out>
MPCQ_HD void box_qp_solve(const Team& tm, int nz, int iters, const uint16_t* tbl, const T* g0,
                          const T* lb0, const T* ub0, const T* zl0, const T* zu0, T* A,
                          const Out& out) {
  const int ln = tm.lane, NL = Team::size, ld = box_qp_ld(nz);
  const int GC = ld - 3, SC = ld - 2, ZC = ld - 1;  // the columns of g', s and z
  const bool warm = zl0 != nullptr;
  // virtual lanes a lane stands for: entry ln + NL r belongs to the warp
  // lane (ln + NL r) % 32, whose partial sums take its entries in order
  constexpr int K = Team::size == 16 ? 2 : 1;

  // s_i and z_i live in their columns, read where needed (registers are
  // what bounds the paired blocks)
  T lb[R], ub[R], zl[R], zu[R], v[R], hz[R];
  auto own = [&](int r) { return ln + NL * r; };
  // the row a slot reads (its own, clamped into the matrix)
  auto row = [&](int r) { return own(r) < nz ? own(r) : nz - 1; };

  // ---- Jacobi scaling and the cold or warm start ----
  MPCQ_UNROLL
  for (int r = 0; r < R; ++r) {
    lb[r] = ub[r] = zl[r] = zu[r] = T(0);
    v[r] = hz[r] = T(0);
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
    A[i * ld + GC] = mul_rn(g0[i], si);
    lb[r] = l;
    ub[r] = u;
    A[i * ld + SC] = si;
    A[i * ld + ZC] = zi;
  }
  tm.sync();

  const int Q = (nz + 3) / 4;
  for (int it = 0; it < iters; ++it) {
    // the lane read again, so that the slots' addresses are formed where
    // they are used and not held in registers through the loop
    const int li = tm.lane_again();
    auto own = [&](int r) { return li + NL * r; };
    auto row = [&](int r) { return own(r) < nz ? own(r) : nz - 1; };
    // ---- barrier target: each warp lane's partial in order, then the
    // warp's butterfly ----
    // the slacks are formed again from z where they are read (registers
    // are what bounds the paired blocks)
    T pl[2] = {T(0), T(0)}, pu[2] = {T(0), T(0)};
    MPCQ_UNROLL
    for (int r = 0; r < R; ++r) {
      if (own(r) >= nz) continue;
      T sl, su;
      box_qp_slacks(A[own(r) * ld + ZC], lb[r], ub[r], it == 0, sl, su);
      pl[r % K] = fmadd(sl, zl[r], pl[r % K]);
      pu[r % K] = fmadd(su, zu[r], pu[r % K]);
    }
    T mu = mul_rn(T(0.1), (team_sum(tm, pl) + team_sum(tm, pu)) / T(2 * nz));

    // ---- the strict lower triangle, H'(R, c) = (H(c, R) s_R) s_c, by
    // strips of four: all of the table ----
    MPCQ_NO_UNROLL
    for (int e = ln, n = box_qp_strips(nz, 0); e < n; e += NL) {
      const int code = tbl[e], Rw = code >> 8, C = code & 255;
      const T sR = A[Rw * ld + SC];
      T x[4];
      MPCQ_UNROLL
      for (int t = 0; t < 4; ++t)
        x[t] = mul_rn(mul_rn(A[(C + t) * ld + Rw], sR), A[(C + t) * ld + SC]);
      if (C + 3 < Rw) {
        store4(A + Rw * ld + C, x[0], x[1], x[2], x[3]);
      } else {
        MPCQ_UNROLL
        for (int t = 0; t < 4; ++t)
          if (C + t < Rw) A[Rw * ld + C + t] = x[t];
      }
    }
    tm.sync();

    // ---- H'z, row i summed over j in order: a quad of the row at a time,
    // (s_j, z_j) one pair from their columns.  A quad left of every row of
    // a slot's lanes takes H' as filled, one right of them all scales H
    // where it is read, the others choose by element ----
    T s[R];
    MPCQ_UNROLL
    for (int r = 0; r < R; ++r) s[r] = A[row(r) * ld + SC];
    auto hz_quad = [&](int q, auto first) {
      T sj[4], zj[4];
      MPCQ_UNROLL
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * q + t < nz ? 4 * q + t : nz - 1;
        const Pair<T> sz = load2s(A + j * ld + SC);
        sj[t] = sz.a;
        zj[t] = sz.b;
      }
      MPCQ_UNROLL
      for (int r = 0; r < R; ++r) {
        const int i = row(r);
        const Quad<T> h = load4s(A + i * ld + 4 * q);
        if (4 * q + 3 < NL * r) {
          MPCQ_UNROLL
          for (int t = 0; t < 4; ++t)
            if (4 * q + t < nz) hz[r] = hz_term<decltype(first)::value>(hz[r], h.v[t], zj[t], t);
        } else if (4 * q >= NL * (r + 1)) {
          MPCQ_UNROLL
          for (int t = 0; t < 4; ++t)
            if (4 * q + t < nz) hz[r] = hz_term<decltype(first)::value>(hz[r], mul_rn(mul_rn(h.v[t], s[r]), sj[t]), zj[t], t);
        } else {
          const T hd = A[i * ld + nz];
          MPCQ_UNROLL
          for (int t = 0; t < 4; ++t) {
            const int j = 4 * q + t;
            if (j < nz)
              hz[r] = hz_term<decltype(first)::value>(
                  hz[r], j < i ? h.v[t] : mul_rn(mul_rn(j == i ? hd : h.v[t], s[r]), sj[t]), zj[t], t);
          }
        }
      }
    };
    hz_quad(0, std::true_type{});
    MPCQ_NO_UNROLL
    for (int q = 1; q < Q; ++q) hz_quad(q, std::false_type{});

    // ---- residual, barrier diagonal, Newton right-hand side; the
    // factor's diagonal ----
    MPCQ_UNROLL
    for (int r = 0; r < R; ++r) {
      const int i = own(r);
      if (i >= nz) continue;
      T res = hz[r] + A[i * ld + GC] - zl[r] + zu[r];
      T sl, su;
      box_qp_slacks(A[own(r) * ld + ZC], lb[r], ub[r], it == 0, sl, su);
      const T a = T(1) / sl, b = T(1) / su;
      v[r] = fmadd(-fmadd(-su, zu[r], mu), b, fmadd(fmadd(-sl, zl[r], mu), a, -res));
      A[i * ld + i] = mul_rn(mul_rn(A[i * ld + nz], s[r]), s[r]) + fmadd(zl[r], a, mul_rn(zu[r], b));
    }
    tm.sync();

    // ---- right-looking Cholesky, lower triangle, by panels of four
    // columns [j0, pe).  Every lane factors the panel's diagonal block in
    // registers (d_u = rsqrt of the pivot, l(k, u) = L(k, j0 + u) d_u); each
    // lane takes whole rows past the panel, as the column-by-column form
    // updates them: l = L(i, j) d_j, stored scaled, then L(i, k) -= l l(k, j)
    // for the panel's columns k > j.  After a sync, lane 0 stores the block's
    // scaled columns and its d_u on the diagonal.  The trailing block takes
    // the panels' columns by strips, each element's updates in column order:
    // panels go in pairs, the first's columns updating only the second's
    // quad of columns before the second is factored, then both (eight
    // columns) the rest of the block in one pass, each strip loaded and
    // stored once a pair.  Every element's products are those of the
    // column-by-column form, in its order ----
    for (int j0 = 0; j0 < nz; j0 += 8) {
      const int pe = j0 + 4 < nz ? j0 + 4 : nz;
      box_qp_panel(tm, A, ld, nz, j0, pe);
      if (pe < nz) {
        // only a full panel leaves a trailing block; the second panel's
        // quad of columns is the table's strips with C = pe
        const int pe2 = pe + 4 < nz ? pe + 4 : nz;
        box_qp_update<1>(ln, NL, tbl, A, ld, box_qp_strips(nz, pe + 4), box_qp_strips(nz, pe), j0);
        tm.sync();
        box_qp_panel(tm, A, ld, nz, pe, pe2);
        box_qp_update<2>(ln, NL, tbl, A, ld, 0, box_qp_strips(nz, pe + 4), j0);
      }
      tm.sync();
    }
    // ---- forward substitution L y = v (column-oriented): y_j from its
    // owner, lane jl of slot jb; each lane's row of L a quad at a time ----
    MPCQ_UNROLL
    for (int jb = 0; jb < R; ++jb) {
      const T dinv = A[row(jb) * (ld + 1)];  // d_j of the lane's slot jb
      for (int jq = 0; jq < NL; jq += 4) {
        const int j4 = jb * NL + jq;
        if (j4 >= nz) break;
        Quad<T> Lq[R];
        MPCQ_UNROLL
        for (int r = jb; r < R; ++r) Lq[r] = load4s(A + row(r) * ld + j4);
        MPCQ_UNROLL
        for (int t = 0; t < 4; ++t) {
          const int j = j4 + t, jl = jq + t;
          if (j >= nz || jl >= NL) break;
          const T yj = tm.bcast(mul_rn(v[jb], dinv), jl);
          // rows past slot jb's are all below j (a lane's entries past nz
          // are never read)
          MPCQ_UNROLL
          for (int r = jb; r < R; ++r)
            if (r > jb || own(r) > j) v[r] = fmadd(-Lq[r].v[t], yj, v[r]);
          if (ln == jl) v[jb] = yj;
        }
      }
    }
    // ---- back substitution L^T dz = y (column-oriented), its steps kept
    // rolled: unrolled, their loads held ahead spilled the paired blocks ----
    MPCQ_UNROLL
    for (int jb = R - 1; jb >= 0; --jb) {
      const T dinv = A[row(jb) * (ld + 1)];
      MPCQ_NO_UNROLL
      for (int jl = NL - 1; jl >= 0; --jl) {
        const int j = jb * NL + jl;
        if (j >= nz) continue;
        const T dzj = tm.bcast(mul_rn(v[jb], dinv), jl);
        MPCQ_UNROLL
        for (int r = 0; r <= jb; ++r)
          if (r < jb || own(r) < j) v[r] = fmadd(-A[j * ld + own(r)], dzj, v[r]);
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
      T sl, su;
      box_qp_slacks(A[own(r) * ld + ZC], lb[r], ub[r], it == 0, sl, su);
      dzl[r] = mul_rn(fmadd(-zl[r], dz, fmadd(-sl, zl[r], mu)), T(1) / sl);
      dzu[r] = mul_rn(fmadd(zu[r], dz, fmadd(-su, zu[r], mu)), T(1) / su);
      pmin = nan_min(pmin, nan_min(nan_min(step_ratio(sl, dz), step_ratio(su, -dz)),
                                   nan_min(step_ratio(zl[r], dzl[r]), step_ratio(zu[r], dzu[r]))));
    }
    T alpha = nan_min(T(1), mul_rn(T(0.995), tm.min(pmin)));

    MPCQ_UNROLL
    for (int r = 0; r < R; ++r) {
      const int i = own(r);
      if (i >= nz) continue;
      A[i * ld + ZC] = fmadd(alpha, v[r], A[i * ld + ZC]);
      zl[r] = floor_at(fmadd(alpha, dzl[r], zl[r]), T(1e-12));
      zu[r] = floor_at(fmadd(alpha, dzu[r], zu[r]), T(1e-12));
    }
    tm.sync();
  }

  MPCQ_UNROLL
  for (int r = 0; r < R; ++r) {
    const int i = own(r);
    if (i >= nz) continue;
    const T si = A[i * ld + SC];
    out(i, mul_rn(clip(A[i * ld + ZC], lb[r], ub[r]), si), zl[r] / si, zu[r] / si);
  }
}

}  // namespace mpcq
