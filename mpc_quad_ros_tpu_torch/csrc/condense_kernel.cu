// Kernel D: condensing from the linearisation J, one scenario per warp — the
// "split" pipeline's second kernel.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/condense_kernel.py::_condense_kernel_J
// (entry condense_cost_from_J_tiled).  Per scenario b, the condensing of
// condense.cuh (the code kernel B runs, so split and hybrid form H and g
// alike) from J (N, 17, 13), r (N, 13), dx0 (13) and ex0 = X - [y_ref;
// y_ref_N] (N+1, 13), writing H (nz, nz) with the control diagonal, g (nz)
// without the control term gu, and every condensing map and drift, M
// (N+1, 13, nz) and d (N+1, 13), which the caller needs for X + d + M z.
// Scenario-major layout: H (B, nz, nz), g (B, nz), M (B, N+1, 13, nz),
// d (B, N+1, 13).  nz = 4 N.
//
// Design: one block of one warp per scenario, J, two M buffers and H in
// shared memory (19.8 KB at N = 10).  M_{k+1} is written to device memory
// row-major as soon as it is formed, one 13 x nz sweep per stage with
// neighbouring lanes on neighbouring addresses; H leaves once, row by row.
// Nothing is reduced across blocks, so a NaN in one scenario leaves every
// other scenario bitwise unchanged.
//
// What bounds it on the H100: bytes.  At B = 65536, N = 10 it reads J
// (0.58 GB) and writes M (1.50 GB) and H (0.42 GB): about 2.6 GB, 0.8 ms at
// 3.35 TB/s, against about 12 GFLOP of condensing (0.2 ms at 67 TFLOP/s).
// Each warp's serial stage recurrence and its stores, issued by one warp per
// scenario, are what keep it far from that bound; packing several scenarios
// per block and staging the stores is later work.

#include "condense.cuh"

namespace mpcq {

template <typename T, typename Team>
MPCQ_HD void condense_scenario(const Team& tm, int N, const Weights<T>& wt, const T* Jg,
                               const T* rg, const T* dx0, const T* ex0, T* ws, T* H_out,
                               T* g_out, T* M_out, T* d_out) {
  const int nz = N * SU, ld = nz + 1, ln = tm.lane, NL = Team::size;
  CondenseWork<T> cw(ws, N);
  for (int e = ln; e < N * ST * SX; e += NL) cw.Js[e] = Jg[e];
  tm.sync();
  condense_from_J(tm, N, wt, cw, rg, dx0, ex0, M_out, d_out);
  for (int e = ln; e < nz * nz; e += NL) H_out[e] = cw.H[(e / nz) * ld + e % nz];
  for (int i = ln; i < nz; i += NL) g_out[i] = cw.g[i];
}

}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernel, in bytes.
extern "C" int64_t mpcq_condense_ws_bytes(int N) {
  return mpcq::condense_ws_size(N) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32)
mpcq_condense_kernel(const float* __restrict__ J, const float* __restrict__ r,
                     const float* __restrict__ dx0, const float* __restrict__ ex0,
                     float* __restrict__ H, float* __restrict__ g, float* __restrict__ M,
                     float* __restrict__ d, int N, mpcq::Weights<float> wt) {
  extern __shared__ float ws[];
  const int64_t b = blockIdx.x;
  const int64_t nz = N * mpcq::SU;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  mpcq::condense_scenario<float>(
      tm, N, wt, J + b * N * mpcq::ST * mpcq::SX, r + b * N * mpcq::SX, dx0 + b * mpcq::SX,
      ex0 + b * (N + 1) * mpcq::SX, ws, H + b * nz * nz, g + b * nz,
      M + b * (N + 1) * mpcq::SX * nz, d + b * (N + 1) * mpcq::SX);
}

extern "C" int mpcq_condense(const float* J, const float* r, const float* dx0,
                             const float* ex0, const float* weights, float* H, float* g,
                             float* M, float* d, int64_t B, int N, void* stream) {
  size_t smem = size_t(mpcq_condense_ws_bytes(N));
  cudaError_t err = cudaFuncSetAttribute(
      mpcq_condense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_condense_kernel<<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
        J, r, dx0, ex0, H, g, M, d, N, mpcq::weights_from<float>(weights));
  return int(cudaGetLastError());
}

#else
#include <vector>

// Host build of the same code (f64, one serial lane), for the CPU tests.
extern "C" int mpcq_condense_host_f64(const double* J, const double* r, const double* dx0,
                                      const double* ex0, const double* weights, double* H,
                                      double* g, double* M, double* d, int64_t B, int N) {
  const int64_t nz = N * mpcq::SU;
  mpcq::Weights<double> wt = mpcq::weights_from<double>(weights);
  std::vector<double> ws(size_t(mpcq::condense_ws_size(N)));
  mpcq::SerialTeam tm;
  for (int64_t b = 0; b < B; ++b)
    mpcq::condense_scenario<double>(
        tm, N, wt, J + b * N * mpcq::ST * mpcq::SX, r + b * N * mpcq::SX,
        dx0 + b * mpcq::SX, ex0 + b * (N + 1) * mpcq::SX, ws.data(), H + b * nz * nz,
        g + b * nz, M + b * (N + 1) * mpcq::SX * nz, d + b * (N + 1) * mpcq::SX);
  return 0;
}

#endif
