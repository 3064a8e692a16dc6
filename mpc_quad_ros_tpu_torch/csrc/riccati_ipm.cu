// Kernel C: the Riccati-factorised box-constrained interior point of the
// long-horizon OCP, one scenario per warp.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/riccati_kernel.py::_riccati_ipm_kernel.
// Per scenario b, from the linearisation J (N, 17, 13) (row j of stage k =
// column j of [A_k | B_k], so A_k^T[c][j] = J[k][c][j]), the defects c, dx0,
// the linear costs qlin (N, 13), rlin (N, 4), plin (13) and the box
// lb <= du <= ub (N, 4):
//
// - cold start: du at the box midpoint, unit duals;
// - exactly `iters` iterations of
//   mu = 0.1 (sl.zl + su.zu) / (2 N nu);
//   dX = the affine rollout of du (defects included);
//   dbar = zl/sl + zu/su,  rhat = rd du + rlin - zl + zu - (mu - sl zl)/sl
//                                 + (mu - su zu)/su;
//   the backward sweep from P = diag(pt), p = pt dX_N + plin, contracting
//   over J's columns: Wt = A^T P, Vt = B^T P, G = sym(B^T P B) +
//   diag(rd + dbar_k), S = B^T P A, rhs2 = rhat_k + B^T p; a 4x4 Cholesky of
//   G with pivots sqrt(max(., 1e-12)) solves [K | kff] jointly; P = diag(q) +
//   sym(A^T P A) - sym(S^T K), p = q dX_k + qlin_k + A^T p - K^T rhs2
//   (sym(X) = 0.5 (X + X^T) of the accumulated product);
//   the forward Newton pass ddu_k = -kff_k - K_k ddx_k, ddx_{k+1} = A_k ddx_k
//   + B_k ddu_k from ddx_0 = 0; the dual steps and the fraction-to-the-
//   boundary step (0.995); slack floor 1e-10 max(width, 1), dual floor 1e-12;
// - du = clip(du, lb, ub) and dX its rollout.
//
// Inputs (contiguous f32): J (B, N, 17, 13), c (B, N, 13), dx0 (B, 13),
// qlin (B, N, 13), rlin (B, N, 4), plin (B, 13), lb, ub (B, N, 4); weights
// q (13), pt (13), rd (4).  Outputs: du (B, N, 4), dX (B, N+1, 13).  Scratch
// in device memory, allocated by the caller: [K_k | kff_k] (B, N, 56).
//
// What bounds it on the H100: the backward sweep is serial in N; each
// stage's 13x13x13 products (about 6,700 FMAs) are spread over one warp's 32
// lanes with four syncs a stage, so a scenario runs at the latency of its
// warp, and the SM's throughput at the number of warps that hide it.  J
// (221 floats a stage) is read three times an iteration (rollout, sweep,
// forward pass): 83 GB at B=65536, N=40, 12 iterations, ~25 ms of HBM time.
//
// Design: one block of one warp per scenario, and a shared workspace cut to
// what a stage needs, so that more warps reside (24 at N=40 where the
// register file allows ~25; 11 with 19.6 KB a block before): du, the slacks,
// the duals and ddu (N x 4 each), P and A^T P in two 13x13 buffers that
// swap roles each stage (A^T P A is formed where P was; the new P where
// A^T P was), the stage's small products and [K_k | kff_k], and two slots
// that stream each stage's J (and, in the forward pass, its [K_k | kff_k])
// from device memory by cp.async one stage ahead, so the chains read J from
// shared memory: 24 N + 1128 floats, 8,352 B at N = 40, and 80 registers a
// lane (the launch bound asks for 24 blocks an SM).  K and kff go to the
// scratch when the sweep forms them and come back through the stream in the
// forward pass; the rollout's dX goes to the dX output (written last by the
// final rollout); dbar_k and rhat_k are formed in the sweep where they are
// used; lb, ub, rlin, qlin are read from device memory.  Every element's
// arithmetic is the one-warp, J-from-global design's, in the same order.
// Nothing is reduced across blocks, so a NaN in one scenario leaves every
// other scenario bitwise unchanged.

#include "common.cuh"

namespace mpcq {
namespace ric {

constexpr int NX = 13, NU = 4, NT = 17, NXX = NX * NX;
constexpr int J_REC = NT * NX;        // one stage of J
constexpr int K_REC = NU * NX + NU;   // one stage of [K | kff]
constexpr int REC = J_REC + K_REC;    // one stream slot
constexpr int kPerStage = 6 * NU;     // du, sl, su, zl, zu, ddu
// Resident blocks an SM asked of the compiler: 24 warps hold 80 registers a
// lane, as many as the workspace allows at N = 40.
constexpr int MIN_BLOCKS = 24;
// P and A^T P, B^T P, G, S, rhs2, dbar, A^T p, p, two 13-vectors of the
// recurrences, [K_k | kff_k], two stream slots
constexpr int kFixed =
    2 * NXX + NU * NX + NU * NU + NU * NX + 2 * NU + 2 * NX + 2 * NX + K_REC + 2 * REC;

template <typename T> struct Weights { T q[NX], pt[NX], rd[NU]; };

template <typename T> Weights<T> weights_from(const T* w) {
  Weights<T> out;
  for (int i = 0; i < NX; ++i) { out.q[i] = w[i]; out.pt[i] = w[NX + i]; }
  for (int a = 0; a < NU; ++a) out.rd[a] = w[2 * NX + a];
  return out;
}

// Shared workspace and device scratch of one scenario, in elements of T.
MPCQ_HD int64_t ws_size(int N) { return int64_t(N) * kPerStage + kFixed; }
MPCQ_HD int64_t scratch_size(int N) { return int64_t(N) * K_REC; }

// Stage records streamed from device memory through two shared slots by
// cp.async (condense.cuh's StreamedJ, in either direction): record k is J_k,
// followed by the scratch's [K_k | kff_k] when Ks is set.
template <typename T> struct Stream {
  const T* J;
  const T* Ks;
  T* buf;
  // Starts record k's copy into slot k % 2 (one commit group).
  template <typename Team> MPCQ_HD void start(const Team& tm, int k) const {
    T* dst = buf + (k & 1) * REC;
    tm.copy_async_part(dst, J + k * J_REC, J_REC);
    if (Ks) tm.copy_async_part(dst + J_REC, Ks + k * K_REC, K_REC);
    tm.commit_async();
  }
  // Waits for record k (the only copy in flight, or none), syncs, starts
  // record `next` (none when negative) into the other slot, whose last reads
  // the sync has ended, and returns k's slot.
  template <typename Team> MPCQ_HD const T* wait(const Team& tm, int k, int next) const {
    tm.template wait_async<0>();
    if (next >= 0) start(tm, next);
    return buf + (k & 1) * REC;
  }
};

// dX_0 = dx0, dX_{k+1} = c_k + A_k dX_k + B_k du_k into dX (device memory),
// the recurrence through the two vectors xb; J streamed in `js`'s slots.
template <typename T, typename Team>
MPCQ_HD void rollout(const Team& tm, int N, const Stream<T>& js, const T* c, const T* dx0,
                     const T* du, T* xb, T* dX) {
  const int ln = tm.lane, NL = Team::size;
  js.start(tm, 0);
  for (int r = ln; r < NX; r += NL) {
    xb[r] = dx0[r];
    dX[r] = dx0[r];
  }
  for (int k = 0; k < N; ++k) {
    const T* Jk = js.wait(tm, k, k + 1 < N ? k + 1 : -1);
    const T* x = xb + (k & 1) * NX;
    for (int r = ln; r < NX; r += NL) {
      T acc = c[k * NX + r];
      for (int j = 0; j < NX; ++j) acc = acc + Jk[j * NX + r] * x[j];
      for (int a = 0; a < NU; ++a) acc = acc + Jk[(NX + a) * NX + r] * du[k * NU + a];
      xb[((k + 1) & 1) * NX + r] = acc;
      dX[(k + 1) * NX + r] = acc;
    }
  }
  tm.sync();
}

// One backward stage's joint solve of G [K | kff] = [S | rhs2] for the
// right-hand column m (m < 13: column m of S; m = 13: rhs2).  G is the
// symmetrised B^T P B plus diag(rd + dbar); every lane factors it alike.
template <typename T>
MPCQ_HD void solve_column(const T* G, const T* S, const T* rhs2, const T* rd, const T* dbar,
                          int m, T* z) {
  T g[NU][NU], L[NU][NU], dg[NU], y[NU];
  for (int a = 0; a < NU; ++a)
    for (int b = 0; b < NU; ++b) g[a][b] = T(0.5) * (G[a * NU + b] + G[b * NU + a]);
  for (int a = 0; a < NU; ++a) g[a][a] = g[a][a] + (rd[a] + dbar[a]);
  for (int jc = 0; jc < NU; ++jc) {          // left-looking Cholesky
    T col[NU];
    for (int i = 0; i < NU; ++i) col[i] = g[i][jc];
    for (int kk = 0; kk < jc; ++kk)
      for (int i = 0; i < NU; ++i) col[i] = col[i] - L[i][kk] * L[jc][kk];
    dg[jc] = m_sqrt(floor_at(col[jc], T(1e-12)));
    for (int i = 0; i < NU; ++i) L[i][jc] = i > jc ? col[i] / dg[jc] : (i == jc ? dg[jc] : T(0));
  }
  for (int a = 0; a < NU; ++a) y[a] = m < NX ? S[a * NX + m] : rhs2[a];
  for (int jc = 0; jc < NU; ++jc) {          // L Y = RHS
    T v = y[jc];
    for (int kk = 0; kk < jc; ++kk) v = v - L[jc][kk] * y[kk];
    y[jc] = v / dg[jc];
  }
  for (int jc = NU - 1; jc >= 0; --jc) {     // L^T Z = Y
    T v = y[jc];
    for (int kk = jc + 1; kk < NU; ++kk) v = v - L[kk][jc] * z[kk];
    z[jc] = v / dg[jc];
  }
}

template <typename T, typename Team>
MPCQ_HD void riccati_ipm_scenario(const Team& tm, int N, int iters, const Weights<T>& wt,
                                  const T* J, const T* c, const T* dx0, const T* qlin,
                                  const T* rlin, const T* plin, const T* lbg, const T* ubg,
                                  T* ws, T* Ks, T* du_out, T* dX) {
  const int ln = tm.lane, NL = Team::size, nv = N * NU;

  T* w = ws;
  T* du = w;   w += nv;
  T* sl = w;   w += nv;
  T* su = w;   w += nv;
  T* zl = w;   w += nv;
  T* zu = w;   w += nv;
  T* ddu = w;  w += nv;
  T* Pa = w;   w += NXX;      // P; then A^T P A
  T* Pb = w;   w += NXX;      // A^T P; then the next stage's P
  T* Vt = w;   w += NU * NX;  // B^T P
  T* G = w;    w += NU * NU;
  T* S = w;    w += NU * NX;  // B^T P A
  T* rhs2 = w; w += NU;
  T* dbar = w; w += NU;
  T* Ap = w;   w += NX;       // A^T p
  T* pv = w;   w += NX;
  T* xb = w;   w += 2 * NX;   // the rollout's dX_k / the forward pass's ddx_k
  T* Kc = w;   w += K_REC;    // [K_k | kff_k] of the current stage
  T* buf = w;                 // two stream slots
  const Stream<T> js{J, nullptr, buf}, jks{J, Ks, buf};

  // ---- cold start ----
  for (int i = ln; i < nv; i += NL) {
    T l = lbg[i], u = ubg[i], d = T(0.5) * (l + u);
    du[i] = d;
    zl[i] = T(1);
    zu[i] = T(1);
    sl[i] = d - l;
    su[i] = u - d;
  }
  tm.sync();

  for (int it = 0; it < iters; ++it) {
    T pl = T(0), pu = T(0);
    for (int i = ln; i < nv; i += NL) {
      pl = pl + sl[i] * zl[i];
      pu = pu + su[i] * zu[i];
    }
    const T mu = T(0.1) * ((tm.sum(pl) + tm.sum(pu)) / T(2 * nv));

    rollout(tm, N, js, c, dx0, du, xb, dX);

    for (int e = ln; e < NXX; e += NL) Pa[e] = e / NX == e % NX ? wt.pt[e / NX] : T(0);
    for (int r = ln; r < NX; r += NL) pv[r] = wt.pt[r] * dX[N * NX + r] + plin[r];

    // ---- backward Riccati sweep; J_{N-1} is still in its slot ----
    for (int k = N - 1; k >= 0; --k) {
      const T* Jk = js.wait(tm, k, k - 1);
      const T* Bk = Jk + NXX;                 // B^T: Bk[a * NX + j] = B_k[j][a]
      for (int e = ln; e < NXX + NU * NX + NU + NX; e += NL) {
        if (e < NXX) {                        // Wt[c][i] = sum_j A[j][c] P[j][i]
          int cc = e / NX, i = e % NX;
          T acc = Jk[cc * NX] * Pa[i];
          for (int j = 1; j < NX; ++j) acc = acc + Jk[cc * NX + j] * Pa[j * NX + i];
          Pb[e] = acc;
        } else if (e < NXX + NU * NX) {       // Vt[a][i] = sum_j B[j][a] P[j][i]
          int e2 = e - NXX, a = e2 / NX, i = e2 % NX;
          T acc = Bk[a * NX] * Pa[i];
          for (int j = 1; j < NX; ++j) acc = acc + Bk[a * NX + j] * Pa[j * NX + i];
          Vt[e2] = acc;
        } else if (e < NXX + NU * NX + NU) {  // dbar_k; rhs2 = rhat_k + B^T p
          int a = e - NXX - NU * NX, i = k * NU + a;
          T s1 = sl[i], s2 = su[i], y1 = zl[i], y2 = zu[i];
          dbar[a] = y1 / s1 + y2 / s2;
          T acc = wt.rd[a] * du[i] + rlin[i] - y1 + y2 - (mu - s1 * y1) / s1 +
                  (mu - s2 * y2) / s2;
          for (int j = 0; j < NX; ++j) acc = acc + Bk[a * NX + j] * pv[j];
          rhs2[a] = acc;
        } else {                              // A^T p
          int cc = e - NXX - NU * NX - NU;
          T acc = Jk[cc * NX] * pv[0];
          for (int j = 1; j < NX; ++j) acc = acc + Jk[cc * NX + j] * pv[j];
          Ap[cc] = acc;
        }
      }
      tm.sync();
      const T* Wt = Pb;
      T* Tm = Pa;                             // P is dead: A^T P A takes its place
      for (int e = ln; e < NU * NU + NU * NX + NXX; e += NL) {
        if (e < NU * NU) {                    // G = B^T (B^T P)^T
          int a = e / NU, b = e % NU;
          T acc = Bk[a * NX] * Vt[b * NX];
          for (int j = 1; j < NX; ++j) acc = acc + Bk[a * NX + j] * Vt[b * NX + j];
          G[e] = acc;
        } else if (e < NU * NU + NU * NX) {   // S = B^T (A^T P)^T
          int e2 = e - NU * NU, a = e2 / NX, cc = e2 % NX;
          T acc = Bk[a * NX] * Wt[cc * NX];
          for (int j = 1; j < NX; ++j) acc = acc + Bk[a * NX + j] * Wt[cc * NX + j];
          S[e2] = acc;
        } else {                              // Tm = A^T (A^T P)^T
          int e2 = e - NU * NU - NU * NX, cc = e2 / NX, c2 = e2 % NX;
          T acc = Jk[cc * NX] * Wt[c2 * NX];
          for (int j = 1; j < NX; ++j) acc = acc + Jk[cc * NX + j] * Wt[c2 * NX + j];
          Tm[e2] = acc;
        }
      }
      tm.sync();
      for (int m = ln; m <= NX; m += NL) {
        T z[NU];
        solve_column(G, S, rhs2, wt.rd, dbar, m, z);
        for (int a = 0; a < NU; ++a) {
          const int o = m < NX ? a * NX + m : NU * NX + a;
          Kc[o] = z[a];
          Ks[k * K_REC + o] = z[a];
        }
      }
      tm.sync();
      const T* Kk = Kc;
      for (int e = ln; e < NXX + NX; e += NL) {
        if (e < NXX) {                        // P = diag(q) + sym(Tm) - sym(S^T K), where A^T P was
          int cc = e / NX, c2 = e % NX;
          T u12 = S[cc] * Kk[c2], u21 = S[c2] * Kk[cc];
          for (int a = 1; a < NU; ++a) {
            u12 = u12 + S[a * NX + cc] * Kk[a * NX + c2];
            u21 = u21 + S[a * NX + c2] * Kk[a * NX + cc];
          }
          T diag = cc == c2 ? wt.q[cc] : T(0);
          Pb[e] = (diag + T(0.5) * (Tm[cc * NX + c2] + Tm[c2 * NX + cc])) - T(0.5) * (u12 + u21);
        } else {                              // p = q dX_k + qlin_k + A^T p - K^T rhs2
          int r = e - NXX;
          T acc = wt.q[r] * dX[k * NX + r] + qlin[k * NX + r] + Ap[r];
          for (int a = 0; a < NU; ++a) acc = acc - Kk[a * NX + r] * rhs2[a];
          pv[r] = acc;
        }
      }
      T* t = Pa;                              // the next stage's wait syncs
      Pa = Pb;
      Pb = t;
    }
    tm.sync();

    // ---- forward Newton pass, ddx_0 = 0, no defects; J and [K | kff] streamed ----
    jks.start(tm, 0);
    for (int r = ln; r < NX; r += NL) xb[r] = T(0);
    for (int k = 0; k < N; ++k) {
      const T* Jk = jks.wait(tm, k, k + 1 < N ? k + 1 : -1);
      const T* Kk = Jk + J_REC;
      const T* kff = Kk + NU * NX;
      const T* x = xb + (k & 1) * NX;
      T d[NU];
      for (int a = 0; a < NU; ++a) {          // every lane, alike
        T acc = -kff[a];
        for (int j = 0; j < NX; ++j) acc = acc - Kk[a * NX + j] * x[j];
        d[a] = acc;
      }
      for (int r = ln; r < NX; r += NL) {
        T acc = Jk[r] * x[0];
        for (int j = 1; j < NX; ++j) acc = acc + Jk[j * NX + r] * x[j];
        for (int a = 0; a < NU; ++a) acc = acc + Jk[(NX + a) * NX + r] * d[a];
        xb[((k + 1) & 1) * NX + r] = acc;
      }
      for (int a = 0; a < NU; ++a)
        if (a % NL == ln) ddu[k * NU + a] = d[a];
    }
    tm.sync();

    // ---- dual steps, fraction-to-the-boundary, update ----
    T pmin = T(INFINITY);
    for (int i = ln; i < nv; i += NL) {
      T s1 = sl[i], s2 = su[i], y1 = zl[i], y2 = zu[i], d = ddu[i];
      T dzl = (mu - s1 * y1 - y1 * d) / s1;
      T dzu = (mu - s2 * y2 + y2 * d) / s2;
      pmin = nan_min(pmin, nan_min(nan_min(step_ratio(s1, d), step_ratio(s2, -d)),
                                   nan_min(step_ratio(y1, dzl), step_ratio(y2, dzu))));
    }
    const T alpha = nan_min(T(1), T(0.995) * tm.min(pmin));
    for (int i = ln; i < nv; i += NL) {
      T s1 = sl[i], s2 = su[i], y1 = zl[i], y2 = zu[i], d = ddu[i];
      T dzl = (mu - s1 * y1 - y1 * d) / s1;
      T dzu = (mu - s2 * y2 + y2 * d) / s2;
      T l = lbg[i], u = ubg[i];
      T v = du[i] + alpha * d;
      T eps = T(1e-10) * floor_at(u - l, T(1));
      du[i] = v;
      sl[i] = floor_at(v - l, eps);
      su[i] = floor_at(u - v, eps);
      zl[i] = floor_at(y1 + alpha * dzl, T(1e-12));
      zu[i] = floor_at(y2 + alpha * dzu, T(1e-12));
    }
    tm.sync();
  }

  for (int i = ln; i < nv; i += NL) {
    T v = clip(du[i], lbg[i], ubg[i]);
    du[i] = v;
    du_out[i] = v;
  }
  tm.sync();
  rollout(tm, N, js, c, dx0, du, xb, dX);
}

}  // namespace ric
}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernel, and the
// device scratch of one scenario, in bytes.
extern "C" int64_t mpcq_riccati_ws_bytes(int N) {
  return mpcq::ric::ws_size(N) * int64_t(sizeof(float));
}
extern "C" int64_t mpcq_riccati_scratch_bytes(int N) {
  return mpcq::ric::scratch_size(N) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32, mpcq::ric::MIN_BLOCKS)
mpcq_riccati_kernel(const float* __restrict__ J, const float* __restrict__ c,
                    const float* __restrict__ dx0, const float* __restrict__ qlin,
                    const float* __restrict__ rlin, const float* __restrict__ plin,
                    const float* __restrict__ lb, const float* __restrict__ ub,
                    float* __restrict__ du, float* __restrict__ dX, float* __restrict__ Ks,
                    int N, int iters, mpcq::ric::Weights<float> wt) {
  using namespace mpcq::ric;
  extern __shared__ float ws[];
  const int64_t b = blockIdx.x;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  riccati_ipm_scenario<float>(
      tm, N, iters, wt, J + b * N * NT * NX, c + b * N * NX, dx0 + b * NX, qlin + b * N * NX,
      rlin + b * N * NU, plin + b * NX, lb + b * N * NU, ub + b * N * NU, ws,
      Ks + b * scratch_size(N), du + b * N * NU, dX + b * (N + 1) * NX);
}

extern "C" int mpcq_riccati_ipm(const float* J, const float* c, const float* dx0,
                                const float* qlin, const float* rlin, const float* plin,
                                const float* lb, const float* ub, const float* weights,
                                float* du, float* dX, float* scratch, int64_t B, int N,
                                int iters, void* stream) {
  const size_t smem = size_t(mpcq_riccati_ws_bytes(N));
  cudaError_t err = mpcq::allow_smem(mpcq_riccati_kernel, smem);
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_riccati_kernel<<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
        J, c, dx0, qlin, rlin, plin, lb, ub, du, dX, scratch, N, iters,
        mpcq::ric::weights_from<float>(weights));
  return int(cudaGetLastError());
}

// Resident blocks (one warp each) per SM at horizon N, from the occupancy API.
extern "C" int mpcq_riccati_occupancy(int N) {
  return mpcq::resident_blocks(mpcq_riccati_kernel, size_t(mpcq_riccati_ws_bytes(N)));
}

#else
#include <vector>

namespace {

// Kernel C on the host: one serial lane (lanes = 1) or a 32-thread team
// that runs the warp's lane split and syncs; scenarios one after another,
// so one scenario's workspace and scratch serve all.
int riccati_host(int lanes, const double* J, const double* c, const double* dx0,
                 const double* qlin, const double* rlin, const double* plin, const double* lb,
                 const double* ub, const double* weights, double* du, double* dX, int64_t B,
                 int N, int iters) {
  using namespace mpcq::ric;
  const Weights<double> wt = weights_from<double>(weights);
  std::vector<double> ws(size_t(ws_size(N))), Ks(size_t(scratch_size(N)));
  return mpcq::run_host_team(lanes, B, [&](const auto& tm, int64_t b) {
    riccati_ipm_scenario<double>(
        tm, N, iters, wt, J + b * N * NT * NX, c + b * N * NX, dx0 + b * NX,
        qlin + b * N * NX, rlin + b * N * NU, plin + b * NX, lb + b * N * NU, ub + b * N * NU,
        ws.data(), Ks.data(), du + b * N * NU, dX + b * (N + 1) * NX);
  });
}

}  // namespace

// Host builds of the same code (f64), for the CPU tests: one serial lane,
// and (host32) 32 threads that run the card's lane split and syncs.
#define MPCQ_RICCATI_ARGS                                                                    \
  const double *J, const double *c, const double *dx0, const double *qlin,                   \
      const double *rlin, const double *plin, const double *lb, const double *ub,            \
      const double *weights, double *du, double *dX, int64_t B, int N, int iters
#define MPCQ_RICCATI_PASS J, c, dx0, qlin, rlin, plin, lb, ub, weights, du, dX, B, N, iters
extern "C" int mpcq_riccati_ipm_host_f64(MPCQ_RICCATI_ARGS) {
  return riccati_host(1, MPCQ_RICCATI_PASS);
}
extern "C" int mpcq_riccati_ipm_host32_f64(MPCQ_RICCATI_ARGS) {
  return riccati_host(32, MPCQ_RICCATI_PASS);
}

#endif
