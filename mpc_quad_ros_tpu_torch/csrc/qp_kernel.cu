// Kernel E: the standalone box-QP interior point, one scenario per warp —
// the "split" pipeline's third kernel.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/qp_kernel.py::_qp_kernel (entries
// solve_box_qp_pdip_pallas_tiled and solve_box_qp_pdip_pallas with
// symmetrize=False).  Per scenario b: min 1/2 z'Hz + g'z s.t. lb <= z <= ub
// by the IPM of ipm_box.cuh (the code kernels B and F run), `iters`
// iterations, cold-started or warm-started from zl0, zu0 (null for the cold
// start).  H (B, nz, nz) is read as given: the split pipeline's H is mirrored
// by construction, and averaging it with its transpose would flip last bits
// that 12 iterations amplify (qp_kernel.py:287-295).  Inputs g, lb, ub and
// the optional zl0, zu0 are (B, nz); outputs z, zl, zu (B, nz), the duals
// unscaled.
//
// Design: one block of one warp per scenario; H is staged into shared memory
// with the odd row stride nz + 1, beside the IPM's scaled H, factor and
// vectors (22.4 KB at nz = 40; three nz x (nz + 1) matrices, so a block's
// shared memory caps nz at 135 on an H100 — the wrapper refuses more).
//
// What bounds it on the H100: as kernel B's IPM, the serial latency of the
// per-scenario Cholesky (nz dependent column steps, each a warp sync, times
// `iters`), far above both the FLOP bound (about 22 GFLOP at B = 65536,
// nz = 40, 12 iterations: 0.33 ms) and the byte bound (H 0.42 GB in).  It
// relies on many resident blocks to hide that latency.

#include "ipm_box.cuh"

namespace mpcq {

// Workspace of one scenario, in elements of T: H (nz x ld), the IPM's.
MPCQ_HD int64_t box_qp_ws_size(int nz) { return int64_t(nz) * (nz + 1) + ipm_ws_size(nz); }

template <typename T, typename Team>
MPCQ_HD void box_qp_scenario(const Team& tm, int nz, int iters, const T* Hg, const T* g,
                             const T* lb, const T* ub, const T* zl0, const T* zu0, T* ws,
                             T* z, T* zl, T* zu) {
  const int ld = nz + 1;
  T* H = ws;
  for (int e = tm.lane; e < nz * nz; e += Team::size) H[(e / nz) * ld + e % nz] = Hg[e];
  tm.sync();
  ipm_box_solve(tm, nz, ld, iters, (const T*)H, g, lb, ub, zl0, zu0,
                ipm_work_at(H + nz * ld, nz), z, zl, zu);
}

}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernel, in bytes.
extern "C" int64_t mpcq_box_qp_ws_bytes(int nz) {
  return mpcq::box_qp_ws_size(nz) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32)
mpcq_box_qp_kernel(const float* __restrict__ H, const float* __restrict__ g,
                   const float* __restrict__ lb, const float* __restrict__ ub,
                   const float* __restrict__ zl0, const float* __restrict__ zu0,
                   float* __restrict__ z, float* __restrict__ zl, float* __restrict__ zu,
                   int nz, int iters) {
  extern __shared__ float ws[];
  const int64_t b = blockIdx.x;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  mpcq::box_qp_scenario<float>(tm, nz, iters, H + b * nz * nz, g + b * nz, lb + b * nz,
                               ub + b * nz, zl0 ? zl0 + b * nz : nullptr,
                               zu0 ? zu0 + b * nz : nullptr, ws, z + b * nz, zl + b * nz,
                               zu + b * nz);
}

extern "C" int mpcq_box_qp(const float* H, const float* g, const float* lb, const float* ub,
                           const float* zl0, const float* zu0, float* z, float* zl,
                           float* zu, int64_t B, int nz, int iters, void* stream) {
  size_t smem = size_t(mpcq_box_qp_ws_bytes(nz));
  cudaError_t err = cudaFuncSetAttribute(
      mpcq_box_qp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_box_qp_kernel<<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
        H, g, lb, ub, zl0, zu0, z, zl, zu, nz, iters);
  return int(cudaGetLastError());
}

#else
#include <vector>

// Host build of the same code (f64, one serial lane), for the CPU tests.
extern "C" int mpcq_box_qp_host_f64(const double* H, const double* g, const double* lb,
                                    const double* ub, const double* zl0, const double* zu0,
                                    double* z, double* zl, double* zu, int64_t B, int nz,
                                    int iters) {
  std::vector<double> ws(size_t(mpcq::box_qp_ws_size(nz)));
  mpcq::SerialTeam tm;
  for (int64_t b = 0; b < B; ++b)
    mpcq::box_qp_scenario<double>(tm, nz, iters, H + b * nz * nz, g + b * nz, lb + b * nz,
                                  ub + b * nz, zl0 ? zl0 + b * nz : nullptr,
                                  zu0 ? zu0 + b * nz : nullptr, ws.data(), z + b * nz,
                                  zl + b * nz, zu + b * nz);
  return 0;
}

#endif
