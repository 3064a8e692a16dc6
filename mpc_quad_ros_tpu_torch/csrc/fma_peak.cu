// Kernel G: independent f32 multiply-add chains, the card's measured f32 rate
// outside the tensor cores.
//
// Replaces mpc_quad_ros_tpu/bench/phases.py::_fma_kernel (the JAX bench's
// utilisation denominator).  Per element x of the input, exactly the JAX
// function: `chains` accumulators acc_c = x (1 + 0.001 c), a = 0.9999 x, then
// `steps` times acc_c = acc_c a + x for every chain, then out = acc_0 + acc_1
// + ... in that order.  a depends on the data and the output on every chain,
// so nothing folds.  nvcc contracts each acc a + x into one FFMA (what the
// card's rate counts); the chains start apart, so none merges with another.
//
// Two homes for the accumulators, one entry (a flag picks them):
// - register-resident, the counterpart of the JAX "vreg" class: the chains
//   live in registers, so the loop is FFMAs and nothing else;
// - shared-memory streaming, the counterpart of the "vmem" class and the
//   operand pattern of kernels B and E, whose workspace lives in shared
//   memory: every step loads each accumulator from shared memory and stores
//   it back, through a volatile pointer, so the compiler cannot keep them in
//   registers.  Thread t's chain c sits at slot c * blockDim + t, so a warp's
//   32 accesses fall in 32 banks.
//
// One thread per element, 256 threads a block.  The step loop runs four
// steps a trip, then one step a trip for the rest, never unrolled further:
// each instantiation's SASS holds 5 * chains FFMAs in each mode (chip_smoke.py
// counts them).  What bounds it on the H100: operations (2 chains steps per
// element against 8 bytes moved).
//
// Chains: 1, 2, 4, 8 or 16 (the JAX shapes take 16 and 8).

#include "common.cuh"

namespace mpcq {

constexpr int FMA_BLOCK = 256;
constexpr int FMA_MAX_CHAINS = 16;

template <typename T, int C>
MPCQ_HD T fma_chains_resident(T x, int steps) {
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = x * T(1.0 + 0.001 * c);
  const T a = x * T(0.9999);
  int s = 0;
#pragma unroll 1
  for (; s + 4 <= steps; s += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = acc[c] * a + x;
    }
  }
#pragma unroll 1
  for (; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = acc[c] * a + x;
  }
  T out = acc[0];
#pragma unroll
  for (int c = 1; c < C; ++c) out = out + acc[c];
  return out;
}

// The same with chain c at slot[c * stride].
template <typename T, int C>
MPCQ_HD T fma_chains_streaming(T x, int steps, volatile T* slot, int stride) {
#pragma unroll
  for (int c = 0; c < C; ++c) slot[c * stride] = x * T(1.0 + 0.001 * c);
  const T a = x * T(0.9999);
  int s = 0;
#pragma unroll 1
  for (; s + 4 <= steps; s += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) slot[c * stride] = slot[c * stride] * a + x;
    }
  }
#pragma unroll 1
  for (; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < C; ++c) slot[c * stride] = slot[c * stride] * a + x;
  }
  T out = slot[0];
#pragma unroll
  for (int c = 1; c < C; ++c) out = out + slot[c * stride];
  return out;
}

inline bool fma_chains_supported(int chains) {
  return chains == 1 || chains == 2 || chains == 4 || chains == 8 || chains == 16;
}

}  // namespace mpcq

#if defined(__CUDACC__)
#include <cuda_runtime.h>

template <int C, bool RESIDENT>
__global__ void __launch_bounds__(mpcq::FMA_BLOCK)
mpcq_fma_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n, int steps) {
  extern __shared__ float slots[];
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  if constexpr (RESIDENT)
    out[i] = mpcq::fma_chains_resident<float, C>(xv, steps);
  else
    out[i] = mpcq::fma_chains_streaming<float, C>(xv, steps, slots + threadIdx.x, blockDim.x);
}

template <int C>
static int launch_fma(const float* x, float* out, int64_t n, int steps, int resident,
                      cudaStream_t stream) {
  const unsigned blocks = unsigned((n + mpcq::FMA_BLOCK - 1) / mpcq::FMA_BLOCK);
  if (resident)
    mpcq_fma_kernel<C, true><<<blocks, mpcq::FMA_BLOCK, 0, stream>>>(x, out, n, steps);
  else
    mpcq_fma_kernel<C, false><<<blocks, mpcq::FMA_BLOCK, C * mpcq::FMA_BLOCK * sizeof(float),
                                stream>>>(x, out, n, steps);
  return int(cudaGetLastError());
}

extern "C" int mpcq_fma(const float* x, float* out, int64_t n, int chains, int steps,
                        int resident, void* stream) {
  if (!mpcq::fma_chains_supported(chains) || steps < 0) return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains) {
    case 1: return launch_fma<1>(x, out, n, steps, resident, s);
    case 2: return launch_fma<2>(x, out, n, steps, resident, s);
    case 4: return launch_fma<4>(x, out, n, steps, resident, s);
    case 8: return launch_fma<8>(x, out, n, steps, resident, s);
    default: return launch_fma<16>(x, out, n, steps, resident, s);
  }
}

#else

// Host build of the same code (f64, element by element), for the CPU tests.
template <int C>
static void host_fma(const double* x, double* out, int64_t n, int steps, int resident) {
  double slots[C];
  for (int64_t i = 0; i < n; ++i)
    out[i] = resident ? mpcq::fma_chains_resident<double, C>(x[i], steps)
                      : mpcq::fma_chains_streaming<double, C>(x[i], steps, slots, 1);
}

extern "C" int mpcq_fma_host_f64(const double* x, double* out, int64_t n, int chains,
                                 int steps, int resident) {
  if (!mpcq::fma_chains_supported(chains) || steps < 0) return 1;
  switch (chains) {
    case 1: host_fma<1>(x, out, n, steps, resident); break;
    case 2: host_fma<2>(x, out, n, steps, resident); break;
    case 4: host_fma<4>(x, out, n, steps, resident); break;
    case 8: host_fma<8>(x, out, n, steps, resident); break;
    default: host_fma<16>(x, out, n, steps, resident); break;
  }
  return 0;
}

#endif
