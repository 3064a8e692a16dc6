// Condensing of one scenario from its linearisation J, run by one team.
//
// The algebra of the JAX package's condense_common (accumulate_lower,
// assemble_mirror) as _condense_kernel_J and _fused_from_J_kernel run it,
// shared here by kernel B (sqp_fused_kernel.cu, and so kernel F) and kernel
// D (condense_kernel.cu), so the hybrid, fused and split pipelines form H and
// g by the same code.  From J (N, 17, 13) in shared memory (row j of stage k =
// column j of [A_k | B_k]) and the defects r (N, 13):
//
//   d_0 = dx0, M_0 = 0,  d_{k+1} = A_k d_k + r_k,  M_{k+1} = A_k M_k + B_k E_k;
//   H += M_k' diag(w) M_k and g += M_k' diag(w) (ex0_k + d_k) for k = 1..N
//
// with a live width (M_k has nonzero columns only in [0, 4k)); w = the stage
// weights q (which carry the x dt stage scale) for k < N and the terminal
// weights p at k = N.  H is accumulated on its lower triangle only, mirrored
// once (never 0.5 (H + H')), and given the kron(I_N, diag(rw)) control
// diagonal.  g leaves without the control term gu.
#pragma once

#include "common.cuh"

namespace mpcq {

constexpr int SX = 13, SU = 4, ST = 17;

template <typename T> struct Weights { T q[SX], p[SX], rw[SU]; };

template <typename T> Weights<T> weights_from(const T* w) {
  Weights<T> out;
  for (int i = 0; i < SX; ++i) { out.q[i] = w[i]; out.p[i] = w[SX + i]; }
  for (int a = 0; a < SU; ++a) out.rw[a] = w[2 * SX + a];
  return out;
}

// Elements of T the condensing takes: J (N x 17 x 13), two 13 x nz buffers of
// M, two 13-vectors of d, H (nz x ld), g (nz); ld = nz + 1.
MPCQ_HD int64_t condense_ws_size(int N) {
  int64_t nz = N * SU;
  return int64_t(N) * ST * SX + 2 * SX * nz + 2 * SX + nz * (nz + 1) + nz;
}

// The condensing workspace, laid out from ws in that order.
template <typename T> struct CondenseWork {
  T *Js, *Mb, *db, *H, *g;
  MPCQ_HD CondenseWork(T* ws, int N) {
    const int nz = N * SU;
    Js = ws;
    Mb = Js + N * ST * SX;
    db = Mb + 2 * SX * nz;
    H = db + 2 * SX;
    g = H + nz * (nz + 1);
  }
};

// Condense with J already in cw.Js.  rg, dx0, ex0 may lie in global or shared
// memory.  M_out (N+1, 13, nz) and d_out (N+1, 13), when not null, receive
// every M_k and d_k (M_0 = 0, d_0 = dx0).  Ends with a team sync.
template <typename T, typename Team>
MPCQ_HD void condense_from_J(const Team& tm, int N, const Weights<T>& wt, const CondenseWork<T>& cw,
                             const T* rg, const T* dx0, const T* ex0, T* M_out, T* d_out) {
  const int nz = N * SU, ld = nz + 1, ln = tm.lane, NL = Team::size;
  T *Js = cw.Js, *Mb = cw.Mb, *db = cw.db, *H = cw.H, *g = cw.g;

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
        T acc = H[r * ld + c];
        for (int i = 0; i < SX; ++i) acc = acc + M[i * nz + r] * (wk[i] * M[i * nz + c]);
        H[r * ld + c] = acc;
      }
    }
    if (k == N) break;
    T* Mn = Mb + (1 - cur) * SX * nz;
    T* dn = db + (1 - cur) * SX;
    const T* Jk = Js + k * ST * SX;
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

  // ---- mirror the lower triangle, add the control diagonal ----
  for (int e = ln; e < nz * nz; e += NL) {
    int r = e / nz, c = e % nz;
    if (c > r) H[r * ld + c] = H[c * ld + r];
  }
  tm.sync();
  for (int i = ln; i < nz; i += NL) H[i * ld + i] = H[i * ld + i] + wt.rw[i % SU];
  tm.sync();
}

}  // namespace mpcq
