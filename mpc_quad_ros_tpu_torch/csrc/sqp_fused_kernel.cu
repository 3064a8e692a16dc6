// Kernel B: the J-fed Gauss-Newton step — condensing, box-QP interior point,
// KKT residual and dX expansion, one scenario per warp.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py::
// _fused_from_J_kernel (with the IPM core of ops/pallas/qp_kernel.py::
// ipm_box_solve, here csrc/ipm_box.cuh).  Per scenario b, from the
// linearisation J (N, 17, 13) (row j of stage k = column j of [A_k | B_k]) and
// the defects r (N, 13):
//
// - condensing with a live width: d_0 = dx0, M_0 = 0,
//   d_{k+1} = A_k d_k + r_k,  M_{k+1} = A_k M_k + B_k E_k;
//   H += M_k' diag(w) M_k and g += M_k' diag(w) (ex0_k + d_k) for k = 1..N
//   (w = the stage weights q, which carry the x dt stage scale, and the
//   terminal weights p at k = N, which do not) — H accumulated on its lower
//   triangle only and mirrored once (never 0.5 (H + H')); then H += the
//   kron(I_N, diag(rw)) control diagonal and g += gu;
// - the IPM of ipm_box.cuh (cold start, `iters` iterations);
// - the projected-gradient KKT residual max |clip(z - (H z + g), lb, ub) - z|
//   against the unscaled H and g;
// - dX_0 = dx0, dX_{k+1} = r_k + A_k dX_k + B_k z_k.
//
// Inputs (contiguous f32): J (B, N, 17, 13), r (B, N, 13), dx0 (B, 13),
// ex0 = X - [y_ref; y_ref_N] (B, N+1, 13), gu, lb, ub (B, nz).  Outputs:
// z (B, nz), dX (B, N+1, 13), kkt (B).  nz = 4 N.
//
// Design: one block of one warp per scenario; J, the condensing map M, H
// (unscaled, scaled, factor) and the IPM vectors live in shared memory
// (about 36 KB at N = 10).  Nothing is reduced across blocks, so a NaN in one
// scenario leaves every other scenario bitwise unchanged.
//
// What bounds it on the H100: the serial latency of the per-scenario
// Cholesky (nz dependent column steps, each a warp sync, times `iters`);
// J is read from HBM once.  The simple design runs one warp per scenario and
// relies on many resident blocks (6 per SM by shared memory) to hide that
// latency; splitting a scenario over more warps, or packing several
// scenarios per warp, is later work.

#include "ipm_box.cuh"

namespace mpcq {

constexpr int SX = 13, SU = 4, ST = 17;

template <typename T> struct Weights { T q[SX], p[SX], rw[SU]; };

template <typename T> Weights<T> weights_from(const T* w) {
  Weights<T> out;
  for (int i = 0; i < SX; ++i) { out.q[i] = w[i]; out.p[i] = w[SX + i]; }
  for (int a = 0; a < SU; ++a) out.rw[a] = w[2 * SX + a];
  return out;
}

// Workspace of one scenario, in elements of T.
MPCQ_HD int64_t sqp_ws_size(int N) {
  int nz = N * SU, ld = nz + 1;
  return int64_t(N) * ST * SX + 2 * SX * nz + 2 * SX + 3 * nz * ld +
         (IpmWork<float>::n_vectors + 4) * nz;
}

template <typename T, typename Team>
MPCQ_HD void sqp_from_J_scenario(const Team& tm, int N, int iters, const Weights<T>& wt,
                                 const T* Jg, const T* rg, const T* dx0, const T* ex0,
                                 const T* gu, const T* lbg, const T* ubg, T* ws,
                                 T* z_out, T* dX_out, T* kkt_out) {
  const int nz = N * SU, ld = nz + 1, ln = tm.lane, NL = Team::size;

  T* Js = ws;                        // N * 17 * 13
  T* Mb = Js + N * ST * SX;          // 2 ping-pong buffers of 13 x nz
  T* db = Mb + 2 * SX * nz;          // 2 ping-pong vectors of 13
  T* H = db + 2 * SX;                // nz x ld
  T* g = H + nz * ld;
  T* lb = g + nz;
  T* ub = lb + nz;
  T* zf = ub + nz;
  IpmWork<T> w;
  T* p = zf + nz;
  w.Hs = p; p += nz * ld;
  w.Lm = p; p += nz * ld;
  T** vecs[IpmWork<T>::n_vectors] = {&w.s, &w.g, &w.lb, &w.ub, &w.z, &w.sl, &w.su, &w.zl,
                                     &w.zu, &w.res, &w.y, &w.sli, &w.sui, &w.dinv, &w.dz,
                                     &w.dzl, &w.dzu};
  for (int v = 0; v < IpmWork<T>::n_vectors; ++v) { *vecs[v] = p; p += nz; }

  // ---- stage J, zero the accumulators ----
  for (int e = ln; e < N * ST * SX; e += NL) Js[e] = Jg[e];
  for (int e = ln; e < 2 * SX * nz; e += NL) Mb[e] = T(0);
  for (int e = ln; e < nz * ld; e += NL) H[e] = T(0);
  for (int i = ln; i < nz; i += NL) g[i] = T(0);
  for (int i = ln; i < SX; i += NL) db[i] = dx0[i];
  tm.sync();

  // ---- condensing, live width lw = k * nu ----
  int cur = 0;
  for (int k = 0; k <= N; ++k) {
    const T* M = Mb + cur * SX * nz;
    const T* d = db + cur * SX;
    const int lw = k * SU;
    if (k > 0) {
      const T* wk = k < N ? wt.q : wt.p;
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
    cur = 1 - cur;
  }
  tm.sync();

  // ---- mirror the lower triangle, add the control diagonal and gu ----
  for (int e = ln; e < nz * nz; e += NL) {
    int r = e / nz, c = e % nz;
    if (c > r) H[r * ld + c] = H[c * ld + r];
  }
  tm.sync();
  for (int i = ln; i < nz; i += NL) {
    H[i * ld + i] = H[i * ld + i] + wt.rw[i % SU];
    g[i] = g[i] + gu[i];
    lb[i] = lbg[i];
    ub[i] = ubg[i];
  }
  tm.sync();

  // ---- interior point ----
  ipm_box_solve(tm, nz, ld, iters, H, g, lb, ub, w, zf);

  // ---- KKT projected-gradient residual against the unscaled H, g ----
  T part = T(0);
  for (int i = ln; i < nz; i += NL) {
    const T* Hi = H + i * ld;
    T Hz = Hi[0] * zf[0];
    for (int j = 1; j < nz; ++j) Hz = Hz + Hi[j] * zf[j];
    T pr = clip(zf[i] - (Hz + g[i]), lb[i], ub[i]) - zf[i];
    part = nan_max(part, pr < T(0) ? -pr : pr);
    z_out[i] = zf[i];
  }
  T kkt = tm.max(part);
  if (ln == 0) kkt_out[0] = kkt;

  // ---- dX forward recurrence ----
  cur = 0;
  for (int row = ln; row < SX; row += NL) {
    db[row] = dx0[row];
    dX_out[row] = dx0[row];
  }
  tm.sync();
  for (int k = 0; k < N; ++k) {
    const T* xk = db + cur * SX;
    T* xn = db + (1 - cur) * SX;
    const T* Jk = Js + k * ST * SX;
    for (int row = ln; row < SX; row += NL) {
      T acc = rg[k * SX + row];
      for (int j = 0; j < SX; ++j) acc = acc + Jk[j * SX + row] * xk[j];
      for (int a = 0; a < SU; ++a) acc = acc + Jk[(SX + a) * SX + row] * zf[k * SU + a];
      xn[row] = acc;
      dX_out[(k + 1) * SX + row] = acc;
    }
    tm.sync();
    cur = 1 - cur;
  }
}

}  // namespace mpcq

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32)
mpcq_sqp_fused_kernel(const float* __restrict__ J, const float* __restrict__ r,
                      const float* __restrict__ dx0, const float* __restrict__ ex0,
                      const float* __restrict__ gu, const float* __restrict__ lb,
                      const float* __restrict__ ub, float* __restrict__ z,
                      float* __restrict__ dX, float* __restrict__ kkt, int N, int iters,
                      mpcq::Weights<float> wt) {
  extern __shared__ float ws[];
  const int64_t b = blockIdx.x;
  const int nz = N * mpcq::SU;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  mpcq::sqp_from_J_scenario<float>(
      tm, N, iters, wt, J + b * N * mpcq::ST * mpcq::SX, r + b * N * mpcq::SX,
      dx0 + b * mpcq::SX, ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz,
      ub + b * nz, ws, z + b * nz, dX + b * (N + 1) * mpcq::SX, kkt + b);
}

extern "C" int mpcq_sqp_fused(const float* J, const float* r, const float* dx0,
                              const float* ex0, const float* gu, const float* lb,
                              const float* ub, const float* weights, float* z, float* dX,
                              float* kkt, int64_t B, int N, int iters, void* stream) {
  size_t smem = size_t(mpcq::sqp_ws_size(N)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mpcq_sqp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_sqp_fused_kernel<<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
        J, r, dx0, ex0, gu, lb, ub, z, dX, kkt, N, iters, mpcq::weights_from<float>(weights));
  return int(cudaGetLastError());
}

#else
#include <vector>

// Host build of the same code (f64, one serial lane), for the CPU tests.
extern "C" int mpcq_sqp_fused_host_f64(const double* J, const double* r, const double* dx0,
                                       const double* ex0, const double* gu,
                                       const double* lb, const double* ub,
                                       const double* weights, double* z, double* dX,
                                       double* kkt, int64_t B, int N, int iters) {
  const int nz = N * mpcq::SU;
  mpcq::Weights<double> wt = mpcq::weights_from<double>(weights);
  std::vector<double> ws(size_t(mpcq::sqp_ws_size(N)));
  mpcq::SerialTeam tm;
  for (int64_t b = 0; b < B; ++b)
    mpcq::sqp_from_J_scenario<double>(
        tm, N, iters, wt, J + b * N * mpcq::ST * mpcq::SX, r + b * N * mpcq::SX,
        dx0 + b * mpcq::SX, ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz,
        ub + b * nz, ws.data(), z + b * nz, dX + b * (N + 1) * mpcq::SX, kkt + b);
  return 0;
}

#endif
