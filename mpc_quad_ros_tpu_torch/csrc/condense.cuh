// Condensing of one scenario from its linearisation J, run by one team.
//
// The algebra of the JAX package's condense_common (accumulate_lower,
// assemble_mirror) as _condense_kernel_J and _fused_from_J_kernel run it,
// shared here by kernel B (sqp_fused_kernel.cu, and so kernel F) and kernels
// D and J (condense_kernel.cu), so the hybrid, fused and split pipelines form
// H and g by the same arithmetic.  From J (N, 17, 13) (row j of stage k =
// column j of [A_k | B_k]) and the defects r (N, 13):
//
//   d_0 = dx0, M_0 = 0,  d_{k+1} = A_k d_k + r_k,  M_{k+1} = A_k M_k + B_k E_k;
//   H += M_k' diag(w) M_k and g += M_k' diag(w) (ex0_k + d_k) for k = 1..N
//
// with a live width (M_k has nonzero columns only in [0, 4k)); w = the stage
// weights q (which carry the x dt stage scale) for k < N and the terminal
// weights p at k = N.  H is accumulated on its lower triangle only and given
// the kron(I_N, diag(rw)) control diagonal; g leaves without the control
// term gu.  Every element of H, g, M and d is one chain in a fixed order,
// whatever lane runs it, so the two paths below give the same bits:
//
// - condense_packed (kernels B and F): H (ld = nz + 1 for ipm_box.cuh,
//   box_qp.cuh's ld for kernel F) with element (r, c), c < r, at (c, r) in
//   the upper triangle and the diagonal in column nz; the lower triangle is
//   left for the IPM's factor.  J is read whole where it lies in device
//   memory, through L1 (kernel B's from kernel A, kernel F's from its own
//   scratch).  One map M in shared memory: each
//   lane forms its own columns of M_{k+1} in registers and writes them over
//   M_k's.
// - condense_full (kernels D, J): H kept as its packed lower triangle,
//   row-major ((r, c) at r (r + 1) / 2 + c, 820 floats at N = 10), g as its
//   row nz; the rows below the live width and g's live part are what the
//   lanes walk, with no idle lane and no division.  J streamed a stage ahead
//   through two slots; M_k column-major (13 floats a column), which every
//   loop reads without bank conflicts, d_k walked as one more column.  Each
//   lane runs two elements' chains at once.  H leaves mirrored with the
//   control diagonal, so it is exactly symmetric; M_k leaves row-major as it
//   is formed, and both in 16-byte stores, zero columns written as zeros.
#pragma once

#include "common.cuh"

namespace mpcq {

constexpr int SX = 13, SU = 4, ST = 17;
// Elements of one stage of J.
constexpr int J_STAGE = ST * SX;

template <typename T> struct Weights { T q[SX], p[SX], rw[SU]; };

template <typename T> Weights<T> weights_from(const T* w) {
  Weights<T> out;
  for (int i = 0; i < SX; ++i) { out.q[i] = w[i]; out.p[i] = w[SX + i]; }
  for (int a = 0; a < SU; ++a) out.rw[a] = w[2 * SX + a];
  return out;
}

// J in device memory, streamed through buf (2 stages).  prefetch(k) starts
// stage k's copy into buf[k % 2]; stage(k) waits for it, syncs and returns
// it.  The caller prefetches k + 1 (when k + 1 < N) only after the sync that
// ends stage k - 1's reads of the same half.
template <typename T> struct StreamedJ {
  const T* Jg;
  T* buf;
  int N;
  template <typename Team> MPCQ_HD void prefetch(const Team& tm, int k) const {
    tm.copy_async(buf + (k & 1) * J_STAGE, Jg + k * J_STAGE, J_STAGE);
  }
  template <typename Team> MPCQ_HD const T* stage(const Team& tm, int k) const {
    if (k + 1 < N)
      tm.template wait_async<1>();
    else
      tm.template wait_async<0>();
    return buf + (k & 1) * J_STAGE;
  }
};

// A (N x 13 x 13) and B (N x 13 x 4) in device memory, row-major, streamed
// as StreamedJ streams J, into J's layout: A_k[row][col] lands at
// [col][row] of the slot, B_k[row][a] at [13 + a][row] (4-byte copies that
// scatter; the reads stay coalesced).
template <typename T> struct StreamedAB {
  const T *Ag, *Bg;
  StreamedJ<T> slots;
  template <typename Team> MPCQ_HD void prefetch(const Team& tm, int k) const {
    T* slot = slots.buf + (k & 1) * J_STAGE;
    const T* A = Ag + k * SX * SX;
    const T* B = Bg + k * SX * SU;
    for (int e = tm.lane; e < SX * SX; e += Team::size)
      tm.copy_elem(slot + (e % SX) * SX + e / SX, A + e);
    for (int e = tm.lane; e < SX * SU; e += Team::size)
      tm.copy_elem(slot + (SX + e % SU) * SX + e / SU, B + e);
    tm.commit_async();
  }
  template <typename Team> MPCQ_HD const T* stage(const Team& tm, int k) const {
    return slots.stage(tm, k);
  }
};

// Condense from J (N x 17 x 13, in shared or device memory) into the packed
// layout of H (nz rows of stride ld >= nz + 1, its diagonal in column nz)
// and g, using one map M (13 x nz) and db (2 x 13).  rg, dx0, ex0 may lie in
// device or shared memory.  Ends with a team sync.
//
// The map's recurrence is lane-local: lane l owns columns l, l + size, ...
// of M, and once every lane has read M_k for H and g it reads its column of
// M_k into registers and writes the column of M_{k+1} over it, 13 rows, each
// element one chain in the order the header states.  Every lane reads the
// same entry of A_k at a time: from device memory one broadcast load through
// L1, from shared memory one broadcast.
template <typename T, typename Team>
MPCQ_HD void condense_packed(const Team& tm, int N, int ld, const Weights<T>& wt, const T* J,
                             T* M, T* db, T* H, T* g, const T* rg, const T* dx0, const T* ex0) {
  const int nz = N * SU, ln = tm.lane, NL = Team::size;

  for (int e = ln; e < SX * nz; e += NL) M[e] = T(0);
  for (int e = ln; e < nz * ld; e += NL) H[e] = T(0);
  for (int i = ln; i < nz; i += NL) g[i] = T(0);
  for (int i = ln; i < SX; i += NL) db[i] = dx0[i];
  tm.sync();

  // ---- live width lw = k * nu ----
  int cur = 0;
  const T* Jk = J;  // J_k, stepped a stage at a time
  for (int k = 0; k <= N; ++k, Jk += J_STAGE) {
    const T* d = db + cur * SX;
    const int lw = k * SU;
    if (k > 0) {
      // this stage's weights in registers (q before the terminal node, p at
      // it): indexed through a pointer chosen at run time they compiled to
      // predicated constant loads in the hot loops below (kernel B 91 ms at
      // B=65536, N=10 on an H100, against 54 ms)
      T wk[SX];
      for (int i = 0; i < SX; ++i) wk[i] = k < N ? wt.q[i] : wt.p[i];
      const T* ex = ex0 + k * SX;
      for (int c = ln; c < lw; c += NL) {
        T acc = g[c];
        for (int i = 0; i < SX; ++i) acc = acc + (wk[i] * M[i * nz + c]) * (ex[i] + d[i]);
        g[c] = acc;
      }
      for (int e = ln; e < lw * lw; e += NL) {
        int r = e / lw, c = e % lw;
        if (c > r) continue;
        const int at = c < r ? c * ld + r : r * ld + nz;
        T acc = H[at];
        for (int i = 0; i < SX; ++i) acc = acc + M[i * nz + r] * (wk[i] * M[i * nz + c]);
        H[at] = acc;
      }
    }
    if (k == N) break;
    T* dn = db + (1 - cur) * SX;
    const T* rk = rg + k * SX;
    for (int row = ln; row < SX; row += NL) {
      T acc = Jk[row] * d[0];
      for (int j = 1; j < SX; ++j) acc = acc + Jk[j * SX + row] * d[j];
      dn[row] = acc + rk[row];
    }
    tm.sync();
    // M_{k+1} = [A_k M_k | B_k] over M_k, column by column
    for (int col = ln; col < lw + SU; col += NL) {
      if (col < lw) {
        T m[SX];
        MPCQ_UNROLL
        for (int j = 0; j < SX; ++j) m[j] = M[j * nz + col];
        MPCQ_UNROLL
        for (int row = 0; row < SX; ++row) {
          T v = Jk[row] * m[0];
          MPCQ_UNROLL
          for (int j = 1; j < SX; ++j) v = v + Jk[j * SX + row] * m[j];
          M[row * nz + col] = v;
        }
      } else {
        const T* Bk = Jk + (SX + col - lw) * SX;
        for (int row = 0; row < SX; ++row) M[row * nz + col] = Bk[row];
      }
    }
    tm.sync();
    cur = 1 - cur;
  }
  tm.sync();
  for (int i = ln; i < nz; i += NL) H[i * ld + nz] = H[i * ld + nz] + wt.rw[i % SU];
  tm.sync();
}

// The same into ipm_box.cuh's layout (ld = nz + 1): kernel B's.
template <typename T, typename Team>
MPCQ_HD void condense_packed(const Team& tm, int N, const Weights<T>& wt, const T* J, T* M,
                             T* db, T* H, T* g, const T* rg, const T* dx0, const T* ex0) {
  condense_packed(tm, N, N * SU + 1, wt, J, M, db, H, g, rg, dx0, ex0);
}

// ---- the full layout (kernels D and J) ----

// H(r, c), c <= r, in the packed lower triangle.
MPCQ_HD int tri_at(int r, int c) { return r * (r + 1) / 2 + c; }

// Elements of T the full-layout condensing takes in shared memory: two maps
// M (13 x nz each), H's packed lower triangle and g as its row nz
// (nz (nz + 1) / 2 + nz), two 13-vectors of d, ex + d (13) and two stream
// slots of J (2 x 221): 2,381 floats at N = 10, 17,681 at N = 40.
MPCQ_HD int64_t condense_ws_size(int N) {
  const int64_t nz = N * SU;
  return 2 * SX * nz + nz * (nz + 1) / 2 + nz + 3 * SX + 2 * J_STAGE;
}

// The full-layout workspace, laid out from ws in that order (the maps first,
// so that their columns and rows keep ws's 16-byte alignment).
template <typename T> struct CondenseWork {
  T *Mb, *H, *g, *db, *xd, *Jb;
  MPCQ_HD CondenseWork(T* ws, int N) {
    const int nz = N * SU;
    Mb = ws;
    H = Mb + 2 * SX * nz;
    g = H + tri_at(nz, 0);
    db = g + nz;
    xd = db + 2 * SX;
    Jb = xd + SX;
  }
};

// A lane's walk over the quads (row, 4 q) of a rows x 4 nq row-major array,
// from quad `f` in steps of `step`, with no division after the first.
struct QuadWalk {
  int row, q;
  MPCQ_HD QuadWalk(int f, int nq) : row(f / nq), q(f % nq) {}
  MPCQ_HD void advance(int step, int nq) {
    q += step;
    while (q >= nq) {
      q -= nq;
      ++row;
    }
  }
};

// The full-layout condensing of one scenario from the J source js (kernels D
// and J): H (nz x nz, mirrored, with the control diagonal), g (nz, without
// gu), M (N+1, 13, nz, row-major, M_0 = 0) and d (N+1, 13, d_0 = dx0) to
// device memory.  rg, dx0, ex0 in device memory.  The chains of H, g, M and
// d are condense_packed's, element by element.
//
// A stage k runs two walks, each spread evenly over the lanes, two elements
// a lane at a time, NL apart:
// - before J_k has arrived, the live prefix of the triangle, then g as the
//   triangle's row nz: H(r, c) += sum_i M_i(r) (w_i M_i(c)) for r < 4k, and
//   g(c) += sum_i (ex_k + d_k)_i (w_i M_i(c)) for c < 4k (the product
//   (w_i M_i(c)) (ex + d)_i of condense_packed, its factors swapped);
// - after it, M_{k+1} = A_k M_k column by column (element 13 col + row,
//   its place in the column-major buffer) and d_{k+1} = A_k d_k + r_k as
//   one more column, whose lanes also form ex_{k+1} + d_{k+1} for the next
//   stage's g; their device-memory addends are loaded before the chain.
template <typename T, typename Team, typename JSrc>
MPCQ_HD void condense_full(const Team& tm, int N, const Weights<T>& wt, const JSrc& js,
                           const CondenseWork<T>& cw, const T* rg, const T* dx0, const T* ex0,
                           T* H_out, T* g_out, T* M_out, T* d_out) {
  const int nz = N * SU, nq = N, ln = tm.lane, NL = Team::size, gat = tri_at(nz, 0);
  T *Hp = cw.H, *xd = cw.xd;
  // every stage's walks start at the same element
  const TriWalk tri0(ln);
  const QuadWalk quad0(ln, nq);

  js.prefetch(tm, 0);
  for (int e = ln; e < gat + nz; e += NL) Hp[e] = T(0);
  for (int i = ln; i < SX; i += NL) {
    cw.db[i] = dx0[i];
    d_out[i] = dx0[i];
  }
  for (int f = ln; f < SX * nq; f += NL) store4(M_out + 4 * f, T(0), T(0), T(0), T(0));
  tm.sync();

  int cur = 0;
  for (int k = 0; k <= N; ++k) {
    if (k + 1 < N) js.prefetch(tm, k + 1);
    // M_k, column c at M[13 c]
    const T* M = cw.Mb + cur * SX * nz;
    const T* d = cw.db + cur * SX;
    const int lw = k * SU;
    if (k > 0) {
      T wk[SX];
      MPCQ_UNROLL
      for (int i = 0; i < SX; ++i) wk[i] = k < N ? wt.q[i] : wt.p[i];
      const int P = tri_at(lw, 0), E = P + lw;
      TriWalk p = tri0;
      for (int e = ln; e < E; e += 2 * NL, p.advance(2 * NL)) {
        TriWalk p1 = p;
        int e1 = e;
        if (e + NL < E) {
          p1.advance(NL);
          e1 = e + NL;
        }
        const bool h0 = e < P, h1 = e1 < P;
        const T *r0 = h0 ? M + p.a * SX : xd, *r1 = h1 ? M + p1.a * SX : xd;
        const T *c0 = M + (h0 ? p.c : e - P) * SX, *c1 = M + (h1 ? p1.c : e1 - P) * SX;
        T *s0 = Hp + (h0 ? e : gat + e - P), *s1 = Hp + (h1 ? e1 : gat + e1 - P);
        T a0 = *s0, a1 = *s1;
        MPCQ_UNROLL
        for (int i = 0; i < SX; ++i) {
          a0 = a0 + r0[i] * (wk[i] * c0[i]);
          a1 = a1 + r1[i] * (wk[i] * c1[i]);
        }
        *s1 = a1;
        *s0 = a0;
      }
    }
    if (k == N) break;
    T* Mn = cw.Mb + (1 - cur) * SX * nz;
    T* dn = cw.db + (1 - cur) * SX;
    const T* rk = rg + k * SX;
    const T* ex = ex0 + (k + 1) * SX;
    const T* Jk = js.stage(tm, k);
    const int na = SX * lw, E = na + SX;
    for (int e = ln; e < E; e += 2 * NL) {
      const int e1 = e + NL < E ? e + NL : e;
      const int col0 = e / SX, row0 = e - SX * col0, col1 = e1 / SX, row1 = e1 - SX * col1;
      // column lw is d's
      const T *m0 = col0 < lw ? M + col0 * SX : d, *m1 = col1 < lw ? M + col1 * SX : d;
      T r_0 = T(0), r_1 = T(0), x_0 = T(0), x_1 = T(0);
      if (col0 == lw) { r_0 = rk[row0]; x_0 = ex[row0]; }
      if (col1 == lw) { r_1 = rk[row1]; x_1 = ex[row1]; }
      T v0 = Jk[row0] * m0[0], v1 = Jk[row1] * m1[0];
      MPCQ_UNROLL
      for (int j = 1; j < SX; ++j) {
        v0 = v0 + Jk[j * SX + row0] * m0[j];
        v1 = v1 + Jk[j * SX + row1] * m1[j];
      }
      if (col1 < lw) {
        Mn[e1] = v1;
      } else {
        v1 = v1 + r_1;
        dn[row1] = v1;
        d_out[(k + 1) * SX + row1] = v1;
        xd[row1] = x_1 + v1;
      }
      if (col0 < lw) {
        Mn[e] = v0;
      } else {
        v0 = v0 + r_0;
        dn[row0] = v0;
        d_out[(k + 1) * SX + row0] = v0;
        xd[row0] = x_0 + v0;
      }
    }
    // and B_k in the new columns lw..lw+3: column lw + a is J's row 13 + a
    for (int e = ln; e < SX * SU; e += NL) Mn[na + e] = Jk[SX * SX + e];
    tm.sync();
    // M_{k+1} out, row-major, 16 bytes a store; its zero columns as zeros
    T* Mk = M_out + int64_t(k + 1) * SX * nz;
    const int live = k + 1;  // quads of nonzero columns
    QuadWalk w = quad0;
    for (int f = ln; f < SX * nq; f += NL, w.advance(NL, nq)) {
      const T* m = Mn + 4 * w.q * SX + w.row;
      if (w.q < live)
        store4(Mk + 4 * f, m[0], m[SX], m[2 * SX], m[3 * SX]);
      else
        store4(Mk + 4 * f, T(0), T(0), T(0), T(0));
    }
    cur = 1 - cur;
  }
  tm.sync();

  // ---- H out: the triangle mirrored, the control diagonal added ----
  QuadWalk w = quad0;
  for (int f = ln; f < nz * nq; f += NL, w.advance(NL, nq)) {
    const int r = w.row, c = 4 * w.q, tr = tri_at(r, 0), a = r % SU;
    // rw[r % 4] by constant indices (a run-time index would move the
    // kernel's weights to local memory)
    const T rw = a == 0 ? wt.rw[0] : a == 1 ? wt.rw[1] : a == 2 ? wt.rw[2] : wt.rw[3];
    T v[4];
    MPCQ_UNROLL
    for (int t = 0; t < 4; ++t) {
      const int cc = c + t;
      v[t] = cc <= r ? Hp[tr + cc] : Hp[tri_at(cc, r)];
      if (cc == r) v[t] = v[t] + rw;
    }
    store4(H_out + 4 * f, v[0], v[1], v[2], v[3]);
  }
  for (int i = ln; i < nz; i += NL) g_out[i] = Hp[gat + i];
}

}  // namespace mpcq
