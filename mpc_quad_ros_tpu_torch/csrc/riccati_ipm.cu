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
// q (13), pt (13), rd (4).  Outputs: du (B, N, 4), dX (B, N+1, 13).
//
// Design: one block of one warp per scenario.  Shared memory holds K
// (N x 4 x 13), kff, du, ddu (the barrier diagonal until the forward pass
// overwrites it), rhat, sl, su, zl, zu, lb, ub (N x 4 each), dX ((N+1) x 13)
// and the stage temporaries P, p, A^T P, B^T P, A^T P A, G, S: 105 N + 696
// floats, 19.6 KB at N = 40, 35.2 KB at N = 80, 67.9 KB at N = 160 (an
// H100 block's 232,448 bytes last to N = 546).  J (221 N floats: 35 KB at
// N = 40, 141 KB at N = 160) is read from global memory (L2) three times
// per iteration: rollout, backward sweep, forward pass.  Staging J in shared
// memory too was measured on an H100 80GB HBM3 at 700 W, B=65536, N=40:
// 443 ms staged (55 KB per block, 4 blocks per SM) against 242 ms from
// global memory (19.6 KB, 11 blocks per SM) — the extra resident warps hide
// more latency than the 36 re-reads of J cost — so J is not staged.
// Nothing is reduced across blocks, so a NaN in one scenario leaves every
// other scenario bitwise unchanged.
//
// What bounds it on the H100: the backward sweep is serial in N; each
// stage's 13x13x13 products (about 6,700 FMAs, each with two shared-memory
// operands) are spread over 32 lanes with four warp syncs per stage, so a
// scenario runs at the latency of its warp and the SM at its shared-memory
// bandwidth.  wgmma, TMA and several scenarios per warp are later work.

#include "common.cuh"

namespace mpcq {
namespace ric {

constexpr int NX = 13, NU = 4, NT = 17, NXX = NX * NX;
constexpr int kPerStage = NU * NX + 10 * NU + NX;  // K, 10 vectors of nu, dX
constexpr int kFixed = NX + 2 * NXX + NX + NU * NX + NXX + NU * NU + NU * NX + NU + NX + 2 * NX;

template <typename T> struct Weights { T q[NX], pt[NX], rd[NU]; };

template <typename T> Weights<T> weights_from(const T* w) {
  Weights<T> out;
  for (int i = 0; i < NX; ++i) { out.q[i] = w[i]; out.pt[i] = w[NX + i]; }
  for (int a = 0; a < NU; ++a) out.rd[a] = w[2 * NX + a];
  return out;
}

// Workspace of one scenario, in elements of T.
MPCQ_HD int64_t ws_size(int N) { return int64_t(N) * kPerStage + kFixed; }

// dX <- dx0, dX_{k+1} = c_k + A_k dX_k + B_k du_k (and a copy to `out`).
template <typename T, typename Team>
MPCQ_HD void rollout(const Team& tm, int N, const T* J, const T* c, const T* dx0,
                     const T* du, T* dX, T* out) {
  const int ln = tm.lane, NL = Team::size;
  for (int r = ln; r < NX; r += NL) {
    dX[r] = dx0[r];
    if (out) out[r] = dx0[r];
  }
  tm.sync();
  for (int k = 0; k < N; ++k) {
    const T* Jk = J + k * NT * NX;
    const T* x = dX + k * NX;
    for (int r = ln; r < NX; r += NL) {
      T acc = c[k * NX + r];
      for (int j = 0; j < NX; ++j) acc = acc + Jk[j * NX + r] * x[j];
      for (int a = 0; a < NU; ++a) acc = acc + Jk[(NX + a) * NX + r] * du[k * NU + a];
      dX[(k + 1) * NX + r] = acc;
      if (out) out[(k + 1) * NX + r] = acc;
    }
    tm.sync();
  }
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
                                  T* ws, T* du_out, T* dX_out) {
  const int ln = tm.lane, NL = Team::size, nv = N * NU;

  T* w = ws;
  T* K = w;    w += nv * NX;
  T* kff = w;  w += nv;
  T* du = w;   w += nv;
  T* ddu = w;  w += nv;     // dbar until the forward pass writes ddu
  T* rhat = w; w += nv;
  T* sl = w;   w += nv;
  T* su = w;   w += nv;
  T* zl = w;   w += nv;
  T* zu = w;   w += nv;
  T* lb = w;   w += nv;
  T* ub = w;   w += nv;
  T* dX = w;   w += (N + 1) * NX;
  T* P = w;    w += NXX;
  T* pv = w;   w += NX;
  T* Wt = w;   w += NXX;    // A^T P
  T* Vt = w;   w += NU * NX;  // B^T P
  T* Tm = w;   w += NXX;    // A^T P A
  T* G = w;    w += NU * NU;
  T* S = w;    w += NU * NX;  // B^T P A
  T* rhs2 = w; w += NU;
  T* Ap = w;   w += NX;     // A^T p
  T* ddx = w;

  // ---- cold start ----
  for (int i = ln; i < nv; i += NL) {
    T l = lbg[i], u = ubg[i], d = T(0.5) * (l + u);
    lb[i] = l;
    ub[i] = u;
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

    rollout(tm, N, J, c, dx0, du, dX, (T*)nullptr);

    for (int i = ln; i < nv; i += NL) {
      T s1 = sl[i], s2 = su[i], y1 = zl[i], y2 = zu[i];
      ddu[i] = y1 / s1 + y2 / s2;
      rhat[i] = wt.rd[i % NU] * du[i] + rlin[i] - y1 + y2 - (mu - s1 * y1) / s1 +
                (mu - s2 * y2) / s2;
    }
    for (int e = ln; e < NXX; e += NL) P[e] = e / NX == e % NX ? wt.pt[e / NX] : T(0);
    for (int r = ln; r < NX; r += NL) pv[r] = wt.pt[r] * dX[N * NX + r] + plin[r];
    tm.sync();

    // ---- backward Riccati sweep ----
    for (int k = N - 1; k >= 0; --k) {
      const T* Jk = J + k * NT * NX;
      const T* Bk = Jk + NXX;                 // B^T: Bk[a * NX + j] = B_k[j][a]
      for (int e = ln; e < NXX + NU * NX + NU + NX; e += NL) {
        if (e < NXX) {                        // Wt[c][i] = sum_j A[j][c] P[j][i]
          int cc = e / NX, i = e % NX;
          T acc = Jk[cc * NX] * P[i];
          for (int j = 1; j < NX; ++j) acc = acc + Jk[cc * NX + j] * P[j * NX + i];
          Wt[e] = acc;
        } else if (e < NXX + NU * NX) {       // Vt[a][i] = sum_j B[j][a] P[j][i]
          int e2 = e - NXX, a = e2 / NX, i = e2 % NX;
          T acc = Bk[a * NX] * P[i];
          for (int j = 1; j < NX; ++j) acc = acc + Bk[a * NX + j] * P[j * NX + i];
          Vt[e2] = acc;
        } else if (e < NXX + NU * NX + NU) {  // rhs2 = rhat_k + B^T p
          int a = e - NXX - NU * NX;
          T acc = rhat[k * NU + a];
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
        solve_column(G, S, rhs2, wt.rd, ddu + k * NU, m, z);
        for (int a = 0; a < NU; ++a) {
          if (m < NX) K[(k * NU + a) * NX + m] = z[a];
          else kff[k * NU + a] = z[a];
        }
      }
      tm.sync();
      const T* Kk = K + k * NU * NX;
      for (int e = ln; e < NXX + NX; e += NL) {
        if (e < NXX) {                        // P = diag(q) + sym(Tm) - sym(S^T K)
          int cc = e / NX, c2 = e % NX;
          T u12 = S[cc] * Kk[c2], u21 = S[c2] * Kk[cc];
          for (int a = 1; a < NU; ++a) {
            u12 = u12 + S[a * NX + cc] * Kk[a * NX + c2];
            u21 = u21 + S[a * NX + c2] * Kk[a * NX + cc];
          }
          T diag = cc == c2 ? wt.q[cc] : T(0);
          P[e] = (diag + T(0.5) * (Tm[cc * NX + c2] + Tm[c2 * NX + cc])) - T(0.5) * (u12 + u21);
        } else {                              // p = q dX_k + qlin_k + A^T p - K^T rhs2
          int r = e - NXX;
          T acc = wt.q[r] * dX[k * NX + r] + qlin[k * NX + r] + Ap[r];
          for (int a = 0; a < NU; ++a) acc = acc - Kk[a * NX + r] * rhs2[a];
          pv[r] = acc;
        }
      }
      tm.sync();
    }

    // ---- forward Newton pass, ddx_0 = 0, no defects ----
    for (int r = ln; r < NX; r += NL) ddx[r] = T(0);
    tm.sync();
    int cur = 0;
    for (int k = 0; k < N; ++k) {
      const T* Jk = J + k * NT * NX;
      const T* Kk = K + k * NU * NX;
      const T* x = ddx + cur * NX;
      T d[NU];
      for (int a = 0; a < NU; ++a) {          // every lane, alike
        T acc = -kff[k * NU + a];
        for (int j = 0; j < NX; ++j) acc = acc - Kk[a * NX + j] * x[j];
        d[a] = acc;
      }
      for (int r = ln; r < NX; r += NL) {
        T acc = Jk[r] * x[0];
        for (int j = 1; j < NX; ++j) acc = acc + Jk[j * NX + r] * x[j];
        for (int a = 0; a < NU; ++a) acc = acc + Jk[(NX + a) * NX + r] * d[a];
        ddx[(1 - cur) * NX + r] = acc;
      }
      for (int a = 0; a < NU; ++a)
        if (a % NL == ln) ddu[k * NU + a] = d[a];
      tm.sync();
      cur = 1 - cur;
    }

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
      T l = lb[i], u = ub[i];
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
    T v = clip(du[i], lb[i], ub[i]);
    du[i] = v;
    du_out[i] = v;
  }
  tm.sync();
  rollout(tm, N, J, c, dx0, du, dX, dX_out);
}

}  // namespace ric
}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernel, in bytes.
extern "C" int64_t mpcq_riccati_ws_bytes(int N) {
  return mpcq::ric::ws_size(N) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32)
mpcq_riccati_kernel(const float* __restrict__ J, const float* __restrict__ c,
                    const float* __restrict__ dx0, const float* __restrict__ qlin,
                    const float* __restrict__ rlin, const float* __restrict__ plin,
                    const float* __restrict__ lb, const float* __restrict__ ub,
                    float* __restrict__ du, float* __restrict__ dX, int N, int iters,
                    mpcq::ric::Weights<float> wt) {
  using namespace mpcq::ric;
  extern __shared__ float ws[];
  const int64_t b = blockIdx.x;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  riccati_ipm_scenario<float>(
      tm, N, iters, wt, J + b * N * NT * NX, c + b * N * NX, dx0 + b * NX, qlin + b * N * NX,
      rlin + b * N * NU, plin + b * NX, lb + b * N * NU, ub + b * N * NU, ws,
      du + b * N * NU, dX + b * (N + 1) * NX);
}

extern "C" int mpcq_riccati_ipm(const float* J, const float* c, const float* dx0,
                                const float* qlin, const float* rlin, const float* plin,
                                const float* lb, const float* ub, const float* weights,
                                float* du, float* dX, int64_t B, int N, int iters,
                                void* stream) {
  int smem = int(mpcq_riccati_ws_bytes(N));
  cudaError_t err = cudaFuncSetAttribute(mpcq_riccati_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_riccati_kernel<<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
        J, c, dx0, qlin, rlin, plin, lb, ub, du, dX, N, iters,
        mpcq::ric::weights_from<float>(weights));
  return int(cudaGetLastError());
}

#else
#include <vector>

// Host build of the same code (f64, one serial lane), for the CPU tests.
extern "C" int mpcq_riccati_ipm_host_f64(const double* J, const double* c, const double* dx0,
                                         const double* qlin, const double* rlin,
                                         const double* plin, const double* lb,
                                         const double* ub, const double* weights, double* du,
                                         double* dX, int64_t B, int N, int iters) {
  using namespace mpcq::ric;
  Weights<double> wt = weights_from<double>(weights);
  std::vector<double> ws(size_t(ws_size(N)));
  mpcq::SerialTeam tm;
  for (int64_t b = 0; b < B; ++b)
    riccati_ipm_scenario<double>(
        tm, N, iters, wt, J + b * N * NT * NX, c + b * N * NX, dx0 + b * NX,
        qlin + b * N * NX, rlin + b * N * NU, plin + b * NX, lb + b * N * NU, ub + b * N * NU,
        ws.data(), du + b * N * NU, dX + b * (N + 1) * NX);
  return 0;
}

#endif
