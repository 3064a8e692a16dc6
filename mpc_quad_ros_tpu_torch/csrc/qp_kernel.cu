// Kernel E: the standalone box-QP interior point, one scenario per warp —
// the "split" pipeline's third kernel and the small-batch step's.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/qp_kernel.py::_qp_kernel (entries
// solve_box_qp_pdip_pallas_tiled and solve_box_qp_pdip_pallas with
// symmetrize=False).  Per scenario b: min 1/2 z'Hz + g'z s.t. lb <= z <= ub
// by the IPM of ipm_box.cuh (the code kernels B and F run), `iters`
// iterations, cold-started or warm-started from zl0, zu0 (null for the cold
// start).  H (B, nz, nz) must be symmetric, as the split pipeline's is by
// construction (mirrored, never averaged with its transpose: that would flip
// last bits that 12 iterations amplify, qp_kernel.py:287-295); the kernel
// reads its upper triangle and diagonal.  Inputs g, lb, ub and the optional
// zl0, zu0 are (B, nz); outputs z, zl, zu (B, nz), the duals unscaled.
//
// What bounds it on the H100: as kernel B's IPM, the per-scenario latency of
// nz dependent Cholesky columns and 2 nz substitution steps per iteration,
// far above both the FLOP bound (about 22 GFLOP at B = 65536, nz = 40, 12
// iterations: 0.33 ms) and the byte bound (H 0.42 GB in); only many
// resident warps hide it.  The design: H's upper triangle and diagonal are
// staged once into the packed matrix of ipm_box.cuh, which the IPM shares
// with the factor, beside s, z and the triangle table: 8,440 B at nz = 40,
// 129,760 B at nz = 160; up to
// nz = 214 in an H100 block's 232,448 B (the wrapper refuses more).  One
// instantiation per R = ceil(nz / 32) register slots a lane, R <= 8; up to
// R = 2 it is held to 128 registers.

#include "ipm_box.cuh"

namespace mpcq {

// Register slots a lane of kernel E holds: nz <= 32 BOX_QP_SLOTS.
constexpr int BOX_QP_SLOTS = 8;

// Workspace of one scenario, in elements of T: the IPM's.
MPCQ_HD int64_t box_qp_ws_size(int nz) { return ipm_ws_size(nz); }

template <int R, typename T, typename Team>
MPCQ_HD void box_qp_scenario(const Team& tm, int nz, int iters, const T* Hg, const T* g,
                             const T* lb, const T* ub, const T* zl0, const T* zu0, T* ws,
                             T* z, T* zl, T* zu) {
  const int ld = nz + 1;
  T* A = ws;
  // H's upper triangle in place, its diagonal in the spare column
  for (int e = tm.lane; e < nz * nz; e += Team::size) {
    const int i = e / nz, j = e % nz;
    if (j > i) A[i * ld + j] = Hg[e];
    if (j == i) A[i * ld + nz] = Hg[e];
  }
  tm.sync();
  ipm_box_solve<R>(tm, nz, iters, A, A + packed_size(nz), g, lb, ub, zl0, zu0, z, zl, zu);
}

}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernel, in bytes.
extern "C" int64_t mpcq_box_qp_ws_bytes(int nz) {
  return mpcq::box_qp_ws_size(nz) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

template <int R>
__global__ void __launch_bounds__(32, (R <= 2 ? 16 : 1))
mpcq_box_qp_kernel(const float* __restrict__ H, const float* __restrict__ g,
                   const float* __restrict__ lb, const float* __restrict__ ub,
                   const float* __restrict__ zl0, const float* __restrict__ zu0,
                   float* __restrict__ z, float* __restrict__ zl, float* __restrict__ zu,
                   int nz, int iters) {
  extern __shared__ float ws[];
  const int64_t b = blockIdx.x;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  mpcq::box_qp_scenario<R, float>(tm, nz, iters, H + b * nz * nz, g + b * nz, lb + b * nz,
                                  ub + b * nz, zl0 ? zl0 + b * nz : nullptr,
                                  zu0 ? zu0 + b * nz : nullptr, ws, z + b * nz, zl + b * nz,
                                  zu + b * nz);
}

extern "C" int mpcq_box_qp(const float* H, const float* g, const float* lb, const float* ub,
                           const float* zl0, const float* zu0, float* z, float* zl,
                           float* zu, int64_t B, int nz, int iters, void* stream) {
  const size_t smem = size_t(mpcq_box_qp_ws_bytes(nz));
  return mpcq::with_slots<mpcq::BOX_QP_SLOTS>(nz, [&](auto slots) {
    constexpr int R = decltype(slots)::value;
    cudaError_t err = mpcq::allow_smem(mpcq_box_qp_kernel<R>, smem);
    if (err != cudaSuccess) return int(err);
    if (B > 0)
      mpcq_box_qp_kernel<R><<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
          H, g, lb, ub, zl0, zu0, z, zl, zu, nz, iters);
    return int(cudaGetLastError());
  });
}

// Resident blocks (one warp each) per SM of kernel E at nz, from the
// occupancy API; -1 past BOX_QP_SLOTS.
extern "C" int mpcq_box_qp_occupancy(int nz) {
  return mpcq::with_slots<mpcq::BOX_QP_SLOTS>(nz, [&](auto slots) {
    constexpr int R = decltype(slots)::value;
    return mpcq::resident_blocks(mpcq_box_qp_kernel<R>, size_t(mpcq_box_qp_ws_bytes(nz)));
  });
}

#else
#include <type_traits>
#include <vector>

namespace {

// Kernel E on the host: one serial lane (lanes = 1) or a 32-thread team.
int box_qp_host(int lanes, const double* H, const double* g, const double* lb,
                const double* ub, const double* zl0, const double* zu0, double* z, double* zl,
                double* zu, int64_t B, int nz, int iters) {
  if (nz > 256) return -1;
  std::vector<double> ws(size_t(mpcq::box_qp_ws_size(nz)));
  return mpcq::run_host_team(lanes, B, [&](const auto& tm, int64_t b) {
    constexpr int R = mpcq::host_slots<std::decay_t<decltype(tm)>>;
    mpcq::box_qp_scenario<R, double>(tm, nz, iters, H + b * nz * nz, g + b * nz, lb + b * nz,
                                     ub + b * nz, zl0 ? zl0 + b * nz : nullptr,
                                     zu0 ? zu0 + b * nz : nullptr, ws.data(), z + b * nz,
                                     zl + b * nz, zu + b * nz);
  });
}

}  // namespace

// Host builds of the same code (f64), for the CPU tests: one serial lane,
// and (host32) 32 threads that run the card's lane split and syncs.
extern "C" int mpcq_box_qp_host_f64(const double* H, const double* g, const double* lb,
                                    const double* ub, const double* zl0, const double* zu0,
                                    double* z, double* zl, double* zu, int64_t B, int nz,
                                    int iters) {
  return box_qp_host(1, H, g, lb, ub, zl0, zu0, z, zl, zu, B, nz, iters);
}
extern "C" int mpcq_box_qp_host32_f64(const double* H, const double* g, const double* lb,
                                      const double* ub, const double* zl0, const double* zu0,
                                      double* z, double* zl, double* zu, int64_t B, int nz,
                                      int iters) {
  return box_qp_host(32, H, g, lb, ub, zl0, zu0, z, zl, zu, B, nz, iters);
}

#endif
