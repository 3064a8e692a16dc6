// Shared helpers of the port's kernels.
//
// Every kernel body is a template over the scalar type T and, for the
// per-scenario kernels, over a "team": on the card the team is one warp
// (32 lanes, __syncwarp, shuffle reductions); on the host it is one serial
// lane (size 1, no-op sync, identity reductions).  nvcc builds the card
// version; g++ builds the same source (with -x c++) into a host library whose
// double instantiation the CPU tests hold against the plain PyTorch versions.
#pragma once

#include <cmath>
#include <cstdint>

#if defined(__CUDACC__)
#define MPCQ_HD __host__ __device__ __forceinline__
#else
#define MPCQ_HD inline
#endif

namespace mpcq {

// IEEE-accurate math (the library is built without --use_fast_math).
MPCQ_HD float m_exp(float v) { return expf(v); }
MPCQ_HD double m_exp(double v) { return exp(v); }
#if defined(__CUDA_ARCH__)
MPCQ_HD float m_rsqrt(float v) { return rsqrtf(v); }
MPCQ_HD double m_rsqrt(double v) { return rsqrt(v); }
#else
MPCQ_HD float m_rsqrt(float v) { return 1.0f / sqrtf(v); }
MPCQ_HD double m_rsqrt(double v) { return 1.0 / sqrt(v); }
#endif

// NaN-propagating min/max, as jnp.minimum / jnp.maximum / jnp.min / jnp.max
// (fminf/fmaxf would drop a NaN and hide a poisoned scenario).
template <typename T> MPCQ_HD T nan_min(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T> MPCQ_HD T nan_max(T a, T b) { return (a > b || a != a) ? a : b; }
// jnp.maximum(v, floor) / jnp.clip
template <typename T> MPCQ_HD T floor_at(T v, T lo) { return nan_max(v, lo); }
template <typename T> MPCQ_HD T clip(T v, T lo, T hi) { return nan_min(nan_max(v, lo), hi); }

#if defined(__CUDACC__)
// One warp works on one scenario.
struct WarpTeam {
  int lane;
  static constexpr int size = 32;
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  template <typename T> __device__ __forceinline__ T sum(T v) const {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  template <typename T> __device__ __forceinline__ T min(T v) const {
    for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  template <typename T> __device__ __forceinline__ T max(T v) const {
    for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
};
#endif

// The host build's team: one lane that runs every loop serially.
struct SerialTeam {
  int lane = 0;
  static constexpr int size = 1;
  MPCQ_HD void sync() const {}
  template <typename T> MPCQ_HD T sum(T v) const { return v; }
  template <typename T> MPCQ_HD T min(T v) const { return v; }
  template <typename T> MPCQ_HD T max(T v) const { return v; }
};

}  // namespace mpcq
