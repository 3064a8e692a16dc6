// Condensing of one scenario from its linearisation J, run by one team.
//
// The algebra of the JAX package's condense_common (accumulate_lower,
// assemble_mirror) as _condense_kernel_J and _fused_from_J_kernel run it,
// shared here by kernel B (sqp_fused_kernel.cu, and so kernel F) and kernels
// D and J (condense_kernel.cu), so the hybrid, fused and split pipelines form
// H and g by the same code.  From J (N, 17, 13) (row j of stage k = column j
// of [A_k | B_k]) and the defects r (N, 13):
//
//   d_0 = dx0, M_0 = 0,  d_{k+1} = A_k d_k + r_k,  M_{k+1} = A_k M_k + B_k E_k;
//   H += M_k' diag(w) M_k and g += M_k' diag(w) (ex0_k + d_k) for k = 1..N
//
// with a live width (M_k has nonzero columns only in [0, 4k)); w = the stage
// weights q (which carry the x dt stage scale) for k < N and the terminal
// weights p at k = N.  H is accumulated on its lower triangle only and given
// the kron(I_N, diag(rw)) control diagonal; g leaves without the control
// term gu.  Two layouts of H (ld = nz + 1), the same values:
//
// - Full (kernels D, J): the lower triangle mirrored once (never
//   0.5 (H + H')), so H is exactly symmetric;
// - Packed (kernels B, F, for ipm_box.cuh): element (r, c), c < r, stored
//   at (c, r) in the upper triangle, the diagonal in the spare column nz; the
//   lower triangle is left for the IPM's factor.
//
// J reaches the stage loop through a source: staged whole in shared memory
// (kernels D, J, F), or streamed from device memory one stage at a time
// through a two-stage shared buffer (kernel B), the next stage's copy in
// flight while the current one computes.
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

enum class HLayout { Full, Packed };

// J (N x 17 x 13) already in shared memory.
template <typename T> struct StagedJ {
  const T* Js;
  int N;
  template <typename Team> MPCQ_HD void prefetch(const Team&, int) const {}
  template <typename Team> MPCQ_HD const T* stage(const Team&, int k) const {
    return Js + k * J_STAGE;
  }
};

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

// Elements of T the full-layout condensing takes: J (N x 17 x 13), two
// 13 x nz buffers of M, two 13-vectors of d, H (nz x ld), g (nz); ld = nz + 1.
MPCQ_HD int64_t condense_ws_size(int N) {
  int64_t nz = N * SU;
  return int64_t(N) * J_STAGE + 2 * SX * nz + 2 * SX + nz * (nz + 1) + nz;
}

// The full-layout condensing workspace, laid out from ws in that order.
template <typename T> struct CondenseWork {
  T *Js, *Mb, *db, *H, *g;
  MPCQ_HD CondenseWork(T* ws, int N) {
    const int nz = N * SU;
    Js = ws;
    Mb = Js + N * J_STAGE;
    db = Mb + 2 * SX * nz;
    H = db + 2 * SX;
    g = H + nz * (nz + 1);
  }
};

// Condense from the J source js into H (layout L), g, using Mb (2 x 13 x nz)
// and db (2 x 13).  rg, dx0, ex0 may lie in global or shared memory.  M_out
// (N+1, 13, nz) and d_out (N+1, 13), when not null, receive every M_k and
// d_k (M_0 = 0, d_0 = dx0).  Ends with a team sync.
template <HLayout L, typename T, typename Team, typename JSrc>
MPCQ_HD void condense(const Team& tm, int N, const Weights<T>& wt, const JSrc& js, T* Mb, T* db,
                      T* H, T* g, const T* rg, const T* dx0, const T* ex0, T* M_out, T* d_out) {
  const int nz = N * SU, ld = nz + 1, ln = tm.lane, NL = Team::size;

  js.prefetch(tm, 0);
  for (int e = ln; e < 2 * SX * nz; e += NL) Mb[e] = T(0);
  for (int e = ln; e < nz * ld; e += NL) H[e] = T(0);
  for (int i = ln; i < nz; i += NL) g[i] = T(0);
  for (int i = ln; i < SX; i += NL) db[i] = dx0[i];
  if (M_out != nullptr) {
    for (int e = ln; e < SX * nz; e += NL) M_out[e] = T(0);
    for (int i = ln; i < SX; i += NL) d_out[i] = dx0[i];
  }
  tm.sync();

  // ---- live width lw = k * nu ----
  int cur = 0;
  for (int k = 0; k <= N; ++k) {
    if (k + 1 < N) js.prefetch(tm, k + 1);
    const T* M = Mb + cur * SX * nz;
    const T* d = db + cur * SX;
    const int lw = k * SU;
    if (k > 0) {
      // this stage's weights in registers (q before the terminal node, p at
      // it): indexed through a pointer chosen at run time they compiled to
      // predicated constant loads in the hot loops below (kernel B 91 ms,
      // kernel D 40 ms at B=65536, N=10 on an H100, against 54 and 4.5 ms)
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
        const int at = L == HLayout::Full ? r * ld + c : (c < r ? c * ld + r : r * ld + nz);
        T acc = H[at];
        for (int i = 0; i < SX; ++i) acc = acc + M[i * nz + r] * (wk[i] * M[i * nz + c]);
        H[at] = acc;
      }
    }
    if (k == N) break;
    T* Mn = Mb + (1 - cur) * SX * nz;
    T* dn = db + (1 - cur) * SX;
    const T* Jk = js.stage(tm, k);
    const T* rk = rg + k * SX;
    for (int row = ln; row < SX; row += NL) {
      T acc = Jk[row] * d[0];
      for (int j = 1; j < SX; ++j) acc = acc + Jk[j * SX + row] * d[j];
      dn[row] = acc + rk[row];
    }
    const int wn = lw + SU;
    for (int e = ln; e < SX * wn; e += NL) {
      int row = e / wn, col = e % wn;
      T v;
      if (col < lw) {
        v = Jk[row] * M[col];
        for (int j = 1; j < SX; ++j) v = v + Jk[j * SX + row] * M[j * nz + col];
      } else {
        v = Jk[(SX + col - lw) * SX + row];
      }
      Mn[row * nz + col] = v;
    }
    tm.sync();
    if (M_out != nullptr) {
      // the whole 13 x nz map, zero columns included: one coalesced row-major
      // sweep per stage
      T* Mk = M_out + int64_t(k + 1) * SX * nz;
      for (int e = ln; e < SX * nz; e += NL) Mk[e] = Mn[e];
      for (int i = ln; i < SX; i += NL) d_out[(k + 1) * SX + i] = dn[i];
    }
    cur = 1 - cur;
  }
  tm.sync();

  if (L == HLayout::Full) {
    // ---- mirror the lower triangle, add the control diagonal ----
    for (int e = ln; e < nz * nz; e += NL) {
      int r = e / nz, c = e % nz;
      if (c > r) H[r * ld + c] = H[c * ld + r];
    }
    tm.sync();
    for (int i = ln; i < nz; i += NL) H[i * ld + i] = H[i * ld + i] + wt.rw[i % SU];
  } else {
    for (int i = ln; i < nz; i += NL) H[i * ld + nz] = H[i * ld + nz] + wt.rw[i % SU];
  }
  tm.sync();
}

// The full-layout condensing with J already in cw.Js (kernels D and J).
template <typename T, typename Team>
MPCQ_HD void condense_from_J(const Team& tm, int N, const Weights<T>& wt, const CondenseWork<T>& cw,
                             const T* rg, const T* dx0, const T* ex0, T* M_out, T* d_out) {
  condense<HLayout::Full>(tm, N, wt, StagedJ<T>{cw.Js, N}, cw.Mb, cw.db, cw.H, cw.g, rg, dx0,
                          ex0, M_out, d_out);
}

}  // namespace mpcq
