// Kernels B and F: the Gauss-Newton step of one scenario per warp —
// condensing, box-QP interior point, KKT residual and dX expansion; kernel F
// linearises the scenario first, in the same block.
//
// Kernel B replaces mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py::
// _fused_from_J_kernel (the "hybrid" pipeline's second kernel); kernel F
// replaces _fused_kernel of the same file (the "fused" pipeline: the whole
// step in one kernel, J never in device memory).  Per scenario b, from the
// linearisation J (N, 17, 13) (row j of stage k = column j of [A_k | B_k])
// and the defects r (N, 13):
//
// - the condensing of condense.cuh (H lower triangle, mirrored; + rw
//   diagonal), then g += gu;
// - the IPM of ipm_box.cuh, `iters` iterations, cold-started or warm-started
//   from the previous duals zl0, zu0 (null for the cold start); it writes the
//   new duals zl, zu (unscaled) on both starts;
// - the projected-gradient KKT residual max |clip(z - (H z + g), lb, ub) - z|
//   against the unscaled H and g;
// - dX_0 = dx0, dX_{k+1} = r_k + A_k dX_k + B_k z_k.
//
// Kernel B's inputs (contiguous f32): J (B, N, 17, 13), r (B, N, 13),
// dx0 (B, 13), ex0 = X - [y_ref; y_ref_N] (B, N+1, 13), gu, lb, ub (B, nz),
// optional zl0, zu0 (B, nz).  Kernel F takes X (B, N+1, 13), U (B, N, 4) and
// the folded drag Xb, wb (B, 3, nb), L, sigma_f (B, 3) in place of J and r:
// its 32 lanes first walk the scenario's N x 17 (stage, tangent) items of
// model.cuh (6 rounds at N = 10), writing J into the shared memory that
// kernel B stages J into and x+ - X_{k+1} into a shared r.  Outputs of both:
// z (B, nz), dX (B, N+1, 13), kkt (B), zl, zu (B, nz).  nz = 4 N.
//
// Design: one block of one warp per scenario; J, the condensing map M, H
// (unscaled, scaled, factor) and the IPM vectors live in shared memory
// (about 36 KB at N = 10; kernel F adds r, 52 N bytes).  The duals are read
// and written in device memory once each, so the warm path adds no nz x ld
// matrix.  Nothing is reduced across blocks, so a NaN in one scenario leaves
// every other scenario bitwise unchanged.  The three nz x ld matrices grow as
// 48 N^2 bytes: kernel B's workspace (mpcq_sqp_ws_bytes) passes the H100's
// 232,448-byte ceiling at N = 31 and kernel F's (mpcq_sqp_step_ws_bytes) at
// N = 31 too (224,984 B at N = 30), so the wrappers refuse N > 30 and the
// solver takes the Riccati kernel there (ops/sqp.py FUSED_N_MAX).
//
// What bounds them on the H100: the serial latency of the per-scenario
// Cholesky (nz dependent column steps, each a warp sync, times `iters`);
// kernel B reads J from device memory once, kernel F never.  The simple
// design runs one warp per scenario and relies on many resident blocks (6 per
// SM by shared memory at N = 10) to hide that latency; splitting a scenario
// over more warps, or packing several scenarios per warp, is later work.
// Kernel F's linearisation runs on a quarter of the lanes kernel A would give
// it per SM (one warp per scenario instead of 17 threads per stage).

#include "condense.cuh"
#include "ipm_box.cuh"
#include "model.cuh"

namespace mpcq {

// Workspace of one scenario of kernel B, in elements of T: the condensing's,
// then lb, ub, z and the IPM's.
MPCQ_HD int64_t sqp_ws_size(int N) {
  int nz = N * SU;
  return condense_ws_size(N) + 3 * nz + ipm_ws_size(nz);
}

// Kernel F's: kernel B's and the defects r (N x 13).
MPCQ_HD int64_t sqp_step_ws_size(int N) { return sqp_ws_size(N) + int64_t(N) * SX; }

// Kernel B's body with J already in the workspace's J slot (ws[0, N*17*13)).
template <typename T, typename Team>
MPCQ_HD void sqp_from_staged_J(const Team& tm, int N, int iters, const Weights<T>& wt,
                               const T* rg, const T* dx0, const T* ex0, const T* gu,
                               const T* lbg, const T* ubg, const T* zl0, const T* zu0,
                               T* ws, T* z_out, T* dX_out, T* kkt_out, T* zl_out,
                               T* zu_out) {
  const int nz = N * SU, ld = nz + 1, ln = tm.lane, NL = Team::size;
  CondenseWork<T> cw(ws, N);
  T* lb = ws + condense_ws_size(N);
  T* ub = lb + nz;
  T* zf = ub + nz;
  IpmWork<T> w = ipm_work_at(zf + nz, nz);
  T *Js = cw.Js, *db = cw.db, *H = cw.H, *g = cw.g;

  condense_from_J(tm, N, wt, cw, rg, dx0, ex0, (T*)nullptr, (T*)nullptr);
  for (int i = ln; i < nz; i += NL) {
    g[i] = g[i] + gu[i];
    lb[i] = lbg[i];
    ub[i] = ubg[i];
  }
  tm.sync();

  // ---- interior point ----
  ipm_box_solve(tm, nz, ld, iters, H, g, lb, ub, zl0, zu0, w, zf, zl_out, zu_out);

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
  int cur = 0;
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

// Kernel B's scenario: stage J from device memory, then the body.
template <typename T, typename Team>
MPCQ_HD void sqp_from_J_scenario(const Team& tm, int N, int iters, const Weights<T>& wt,
                                 const T* Jg, const T* rg, const T* dx0, const T* ex0,
                                 const T* gu, const T* lbg, const T* ubg, const T* zl0,
                                 const T* zu0, T* ws, T* z_out, T* dX_out, T* kkt_out,
                                 T* zl_out, T* zu_out) {
  for (int e = tm.lane; e < N * ST * SX; e += Team::size) ws[e] = Jg[e];
  tm.sync();
  sqp_from_staged_J(tm, N, iters, wt, rg, dx0, ex0, gu, lbg, ubg, zl0, zu0, ws, z_out,
                    dX_out, kkt_out, zl_out, zu_out);
}

// Kernel F's scenario: linearise (X, U) into the workspace's J slot and r,
// then kernel B's body.
template <typename T, typename Team>
MPCQ_HD void sqp_step_scenario(const Team& tm, int N, int iters, const ModelConsts<T>& c,
                               const Weights<T>& wt, const T* X, const T* U,
                               const DragView<T>& drag, const T* dx0, const T* ex0,
                               const T* gu, const T* lbg, const T* ubg, const T* zl0,
                               const T* zu0, T* ws, T* z_out, T* dX_out, T* kkt_out,
                               T* zl_out, T* zu_out) {
  T* Js = ws;
  T* rs = ws + sqp_ws_size(N);
  for (int t = tm.lane; t < N * ST; t += Team::size) {
    int k = t / ST, i = t % ST;
    Dual<T> x[SX];
    lin_item(X + k * SX, U + k * SU, drag, i, c, x);
    for (int j = 0; j < SX; ++j) Js[t * SX + j] = x[j].d;
    if (i == 0)
      for (int j = 0; j < SX; ++j) rs[k * SX + j] = x[j].v;
  }
  tm.sync();
  // r_k = x+_k - X_{k+1}, as the hybrid pipeline's glue forms it
  for (int e = tm.lane; e < N * SX; e += Team::size) rs[e] = rs[e] - X[SX + e];
  tm.sync();
  sqp_from_staged_J(tm, N, iters, wt, (const T*)rs, dx0, ex0, gu, lbg, ubg, zl0, zu0, ws,
                    z_out, dX_out, kkt_out, zl_out, zu_out);
}

template <typename T>
MPCQ_HD DragView<T> drag_of(int64_t b, const T* Xb, const T* wb, const T* L, const T* sf,
                            int nb) {
  return {nb > 0 ? Xb + b * 3 * nb : nullptr, nb > 0 ? wb + b * 3 * nb : nullptr,
          nb > 0 ? L + b * 3 : nullptr, nb > 0 ? sf + b * 3 : nullptr, nb};
}

}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernels, in bytes.
// Kernel B: 223,424 at N = 30, 236,820 at N = 31 (an H100 block takes
// 232,448); the warm path reads and writes its duals in device memory and
// adds nothing here.  Kernel F: 1,560 B more at N = 30 (224,984).
extern "C" int64_t mpcq_sqp_ws_bytes(int N) {
  return mpcq::sqp_ws_size(N) * int64_t(sizeof(float));
}
extern "C" int64_t mpcq_sqp_step_ws_bytes(int N) {
  return mpcq::sqp_step_ws_size(N) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32)
mpcq_sqp_fused_kernel(const float* __restrict__ J, const float* __restrict__ r,
                      const float* __restrict__ dx0, const float* __restrict__ ex0,
                      const float* __restrict__ gu, const float* __restrict__ lb,
                      const float* __restrict__ ub, const float* __restrict__ zl0,
                      const float* __restrict__ zu0, float* __restrict__ z,
                      float* __restrict__ dX, float* __restrict__ kkt,
                      float* __restrict__ zl, float* __restrict__ zu, int N, int iters,
                      mpcq::Weights<float> wt) {
  extern __shared__ float ws[];
  const int64_t b = blockIdx.x;
  const int nz = N * mpcq::SU;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  mpcq::sqp_from_J_scenario<float>(
      tm, N, iters, wt, J + b * N * mpcq::ST * mpcq::SX, r + b * N * mpcq::SX,
      dx0 + b * mpcq::SX, ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz,
      ub + b * nz, zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr, ws,
      z + b * nz, dX + b * (N + 1) * mpcq::SX, kkt + b, zl + b * nz, zu + b * nz);
}

extern "C" int mpcq_sqp_fused(const float* J, const float* r, const float* dx0,
                              const float* ex0, const float* gu, const float* lb,
                              const float* ub, const float* zl0, const float* zu0,
                              const float* weights, float* z, float* dX, float* kkt,
                              float* zl, float* zu, int64_t B, int N, int iters,
                              void* stream) {
  size_t smem = size_t(mpcq_sqp_ws_bytes(N));
  cudaError_t err = cudaFuncSetAttribute(
      mpcq_sqp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_sqp_fused_kernel<<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
        J, r, dx0, ex0, gu, lb, ub, zl0, zu0, z, dX, kkt, zl, zu, N, iters,
        mpcq::weights_from<float>(weights));
  return int(cudaGetLastError());
}

__global__ void __launch_bounds__(32)
mpcq_sqp_step_kernel(const float* __restrict__ X, const float* __restrict__ U,
                     const float* __restrict__ Xb, const float* __restrict__ wb,
                     const float* __restrict__ L, const float* __restrict__ sf, int nb,
                     const float* __restrict__ dx0, const float* __restrict__ ex0,
                     const float* __restrict__ gu, const float* __restrict__ lb,
                     const float* __restrict__ ub, const float* __restrict__ zl0,
                     const float* __restrict__ zu0, float* __restrict__ z,
                     float* __restrict__ dX, float* __restrict__ kkt,
                     float* __restrict__ zl, float* __restrict__ zu, int N, int iters,
                     mpcq::ModelConsts<float> c, mpcq::Weights<float> wt) {
  extern __shared__ float ws[];
  const int64_t b = blockIdx.x;
  const int nz = N * mpcq::SU;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  mpcq::sqp_step_scenario<float>(
      tm, N, iters, c, wt, X + b * (N + 1) * mpcq::SX, U + b * N * mpcq::SU,
      mpcq::drag_of(b, Xb, wb, L, sf, nb), dx0 + b * mpcq::SX,
      ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz, ub + b * nz,
      zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr, ws, z + b * nz,
      dX + b * (N + 1) * mpcq::SX, kkt + b, zl + b * nz, zu + b * nz);
}

extern "C" int mpcq_sqp_step(const float* X, const float* U, const float* Xb,
                             const float* wb, const float* L, const float* sf, int nb,
                             const float* dx0, const float* ex0, const float* gu,
                             const float* lb, const float* ub, const float* zl0,
                             const float* zu0, const float* consts, const float* weights,
                             float* z, float* dX, float* kkt, float* zl, float* zu,
                             int64_t B, int N, int iters, void* stream) {
  size_t smem = size_t(mpcq_sqp_step_ws_bytes(N));
  cudaError_t err = cudaFuncSetAttribute(
      mpcq_sqp_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_sqp_step_kernel<<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
        X, U, Xb, wb, L, sf, nb, dx0, ex0, gu, lb, ub, zl0, zu0, z, dX, kkt, zl, zu, N,
        iters, mpcq::consts_from<float>(consts), mpcq::weights_from<float>(weights));
  return int(cudaGetLastError());
}

#else
#include <vector>

// Host builds of the same code (f64, one serial lane), for the CPU tests.
extern "C" int mpcq_sqp_fused_host_f64(const double* J, const double* r, const double* dx0,
                                       const double* ex0, const double* gu,
                                       const double* lb, const double* ub,
                                       const double* zl0, const double* zu0,
                                       const double* weights, double* z, double* dX,
                                       double* kkt, double* zl, double* zu, int64_t B, int N,
                                       int iters) {
  const int nz = N * mpcq::SU;
  mpcq::Weights<double> wt = mpcq::weights_from<double>(weights);
  std::vector<double> ws(size_t(mpcq::sqp_ws_size(N)));
  mpcq::SerialTeam tm;
  for (int64_t b = 0; b < B; ++b)
    mpcq::sqp_from_J_scenario<double>(
        tm, N, iters, wt, J + b * N * mpcq::ST * mpcq::SX, r + b * N * mpcq::SX,
        dx0 + b * mpcq::SX, ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz,
        ub + b * nz, zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr, ws.data(),
        z + b * nz, dX + b * (N + 1) * mpcq::SX, kkt + b, zl + b * nz, zu + b * nz);
  return 0;
}

extern "C" int mpcq_sqp_step_host_f64(const double* X, const double* U, const double* Xb,
                                      const double* wb, const double* L, const double* sf,
                                      int nb, const double* dx0, const double* ex0,
                                      const double* gu, const double* lb, const double* ub,
                                      const double* zl0, const double* zu0,
                                      const double* consts, const double* weights,
                                      double* z, double* dX, double* kkt, double* zl,
                                      double* zu, int64_t B, int N, int iters) {
  const int nz = N * mpcq::SU;
  mpcq::ModelConsts<double> c = mpcq::consts_from<double>(consts);
  mpcq::Weights<double> wt = mpcq::weights_from<double>(weights);
  std::vector<double> ws(size_t(mpcq::sqp_step_ws_size(N)));
  mpcq::SerialTeam tm;
  for (int64_t b = 0; b < B; ++b)
    mpcq::sqp_step_scenario<double>(
        tm, N, iters, c, wt, X + b * (N + 1) * mpcq::SX, U + b * N * mpcq::SU,
        mpcq::drag_of(b, Xb, wb, L, sf, nb), dx0 + b * mpcq::SX,
        ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz, ub + b * nz,
        zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr, ws.data(), z + b * nz,
        dX + b * (N + 1) * mpcq::SX, kkt + b, zl + b * nz, zu + b * nz);
  return 0;
}

#endif
