// Kernels H and I: the transpose probe — what mirroring a Hessian costs.
//
// Kernel H replaces mpc_quad_ros_tpu/bench/probe_hybrid.py::_mirror_kernel,
// kernel I its baseline ::_elem_kernel.  Per scenario b, on x (B, nz, nz)
// scenario-major, `reps` times with f = 1 + 1e-6 i:
// - H: acc = acc + strict_lower(acc)^T f, i.e. acc[r][c] += acc[c][r] f for
//   c > r; the strict lower triangle never changes;
// - I: acc = acc + strict_lower(acc) f, i.e. acc[r][c] += acc[r][c] f for
//   r > c; the upper triangle and the diagonal never change.
// (The JAX kernels add the masked zeros too; adding nothing leaves the same
// values.)  The difference of the two times over `reps` is one mirror of H,
// the step condense.cuh runs once per solve in kernels B, D and F.
//
// Design: one block of one warp per scenario, the tile staged in shared memory
// at ld = nz + 1, the layout of condense.cuh and ipm_box.cuh, so H reads the
// transposed entry as the port's kernels do (a warp's column reads fall in 32
// banks).  The tile is loaded and stored once, row-major and coalesced.
// Nothing is reduced across blocks, so a NaN in one scenario leaves every
// other scenario bitwise unchanged.  What bounds both on the H100: bytes, the
// tiles read and written once (105 MB each way at B = 16384, nz = 40).

#include "common.cuh"

namespace mpcq {

template <typename T, typename Team>
MPCQ_HD void transpose_probe_scenario(const Team& tm, int nz, int reps, bool mirror, const T* x,
                                      T* ws, T* out) {
  const int ld = nz + 1, ln = tm.lane, NL = Team::size;
  for (int e = ln; e < nz * nz; e += NL) ws[(e / nz) * ld + e % nz] = x[e];
  tm.sync();
  for (int i = 0; i < reps; ++i) {
    const T f = T(1.0 + 1e-6 * i);
    for (int e = ln; e < nz * nz; e += NL) {
      const int r = e / nz, c = e % nz;
      if (mirror) {
        if (c > r) ws[r * ld + c] = ws[r * ld + c] + ws[c * ld + r] * f;
      } else if (r > c) {
        ws[r * ld + c] = ws[r * ld + c] + ws[r * ld + c] * f;
      }
    }
    tm.sync();
  }
  for (int e = ln; e < nz * nz; e += NL) out[e] = ws[(e / nz) * ld + e % nz];
}

}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernels, in bytes.
extern "C" int64_t mpcq_transpose_ws_bytes(int nz) {
  return int64_t(nz) * (nz + 1) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32)
mpcq_mirror_kernel(const float* __restrict__ x, float* __restrict__ out, int nz, int reps) {
  extern __shared__ float ws[];
  const int64_t off = int64_t(blockIdx.x) * nz * nz;
  mpcq::transpose_probe_scenario<float>(mpcq::WarpTeam{int(threadIdx.x)}, nz, reps, true,
                                        x + off, ws, out + off);
}

__global__ void __launch_bounds__(32)
mpcq_elem_kernel(const float* __restrict__ x, float* __restrict__ out, int nz, int reps) {
  extern __shared__ float ws[];
  const int64_t off = int64_t(blockIdx.x) * nz * nz;
  mpcq::transpose_probe_scenario<float>(mpcq::WarpTeam{int(threadIdx.x)}, nz, reps, false,
                                        x + off, ws, out + off);
}

template <typename K>
static int launch_probe(K kernel, const float* x, float* out, int64_t B, int nz, int reps,
                        void* stream) {
  const size_t smem = size_t(mpcq_transpose_ws_bytes(nz));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    kernel<<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(x, out, nz, reps);
  return int(cudaGetLastError());
}

extern "C" int mpcq_mirror(const float* x, float* out, int64_t B, int nz, int reps,
                           void* stream) {
  return launch_probe(mpcq_mirror_kernel, x, out, B, nz, reps, stream);
}

extern "C" int mpcq_elem(const float* x, float* out, int64_t B, int nz, int reps, void* stream) {
  return launch_probe(mpcq_elem_kernel, x, out, B, nz, reps, stream);
}

#else
#include <vector>

// Host build of the same code (f64, one serial lane), for the CPU tests.
static int host_probe(const double* x, double* out, int64_t B, int nz, int reps, bool mirror) {
  std::vector<double> ws(size_t(nz) * (nz + 1));
  mpcq::SerialTeam tm;
  for (int64_t b = 0; b < B; ++b)
    mpcq::transpose_probe_scenario<double>(tm, nz, reps, mirror, x + b * nz * nz, ws.data(),
                                           out + b * nz * nz);
  return 0;
}

extern "C" int mpcq_mirror_host_f64(const double* x, double* out, int64_t B, int nz, int reps) {
  return host_probe(x, out, B, nz, reps, true);
}

extern "C" int mpcq_elem_host_f64(const double* x, double* out, int64_t B, int nz, int reps) {
  return host_probe(x, out, B, nz, reps, false);
}

#endif
