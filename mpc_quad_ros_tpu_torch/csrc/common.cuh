// Shared helpers of the port's kernels.
//
// Every kernel body is a template over the scalar type T and, for the
// per-scenario kernels, over a "team": on the card the team is one warp
// (32 lanes, __syncwarp, shuffle reductions and broadcasts, cp.async copies)
// or, for kernel J, a whole block (__syncthreads, cp.async copies); on the
// host it is one serial lane (size 1, no-op sync, identity reductions) or
// 32 or more threads behind a barrier, which run the card team's lane split
// and its syncs.  nvcc builds the card version; g++ builds the same source
// (with -x c++) into a host library whose double instantiation the CPU tests
// hold against the plain PyTorch versions.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#if defined(__CUDACC__)
#define MPCQ_HD __host__ __device__ __forceinline__
#else
#define MPCQ_HD inline
#endif

// Loops over a lane's register slots are unrolled on the card, so that the
// per-lane arrays stay in registers (an array indexed at run time would live
// in local memory).
#if defined(__CUDA_ARCH__)
#define MPCQ_UNROLL _Pragma("unroll")
#else
#define MPCQ_UNROLL
#endif
// A loop kept rolled on the card, so that the compiler does not hold the
// loads of several iterations in registers at once.
#if defined(__CUDA_ARCH__)
#define MPCQ_NO_UNROLL _Pragma("unroll 1")
#else
#define MPCQ_NO_UNROLL
#endif

namespace mpcq {

// IEEE-accurate math (the library is built without --use_fast_math).
MPCQ_HD float m_exp(float v) { return expf(v); }
MPCQ_HD double m_exp(double v) { return exp(v); }
MPCQ_HD float m_sqrt(float v) { return sqrtf(v); }
MPCQ_HD double m_sqrt(double v) { return sqrt(v); }
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
// An interior point's step ratio: -v / dv where dv < 0, else +inf.
template <typename T> MPCQ_HD T step_ratio(T v, T dv) {
  return dv < T(0) ? -v / dv : T(INFINITY);
}

// Calls f(std::integral_constant<int, R>) with the least R in [R0, RMax] for
// which a team of 32 lanes holds nz entries in R register slots a lane
// (nz <= 32 R); returns -1 when nz needs more than RMax.  The launchers pick
// their kernel's instantiation with it.
template <int RMax, int R0 = 1, typename F> int with_slots(int nz, F&& f) {
  if constexpr (R0 > RMax) {
    return -1;
  } else {
    if (nz <= 32 * R0) return f(std::integral_constant<int, R0>{});
    return with_slots<RMax, R0 + 1>(nz, f);
  }
}

// Walks the row-major lower triangle {(a, c): 0 <= c <= a} by flat index
// e = a (a + 1) / 2 + c, from a lane's first element in steps of the team:
// the rows of a triangle's first m rows are a prefix of it, so one walk
// serves every size, with no division.
struct TriWalk {
  int a = 0, c;
  MPCQ_HD explicit TriWalk(int e) : c(e) { settle(); }
  MPCQ_HD void settle() {
    while (c > a) {
      c -= a + 1;
      ++a;
    }
  }
  MPCQ_HD void advance(int step) {
    c += step;
    settle();
  }
};

// Where src sits in its 16-byte-aligned group of four elements (0-3): the
// elements copy_async_quads places before src[0].
template <typename T> MPCQ_HD int quad_lag(const T* src) {
  return int((reinterpret_cast<uintptr_t>(src) / sizeof(T)) & 3);
}

// Four consecutive elements in device memory: on the card one 16-byte access
// (the address 16-byte aligned; loads through the read-only path), on the
// host four.
template <typename T> struct Quad { T v[4]; };
MPCQ_HD Quad<float> load4(const float* src) {
#if defined(__CUDA_ARCH__)
  const float4 q = __ldg(reinterpret_cast<const float4*>(src));
  return {{q.x, q.y, q.z, q.w}};
#else
  return {{src[0], src[1], src[2], src[3]}};
#endif
}
MPCQ_HD Quad<double> load4(const double* src) { return {{src[0], src[1], src[2], src[3]}}; }
// The same from shared memory (16-byte aligned on the card).
MPCQ_HD Quad<float> load4s(const float* src) {
#if defined(__CUDA_ARCH__)
  const float4 q = *reinterpret_cast<const float4*>(src);
  return {{q.x, q.y, q.z, q.w}};
#else
  return {{src[0], src[1], src[2], src[3]}};
#endif
}
MPCQ_HD Quad<double> load4s(const double* src) { return {{src[0], src[1], src[2], src[3]}}; }
MPCQ_HD void store4(float* dst, float a, float b, float c, float d) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
#else
  dst[0] = a; dst[1] = b; dst[2] = c; dst[3] = d;
#endif
}
MPCQ_HD void store4(double* dst, double a, double b, double c, double d) {
  dst[0] = a; dst[1] = b; dst[2] = c; dst[3] = d;
}

// Thread t of nt copies n elements from shared memory to dst (both 16-byte
// aligned): groups of four as one 16-byte store on the card, the ragged end
// (and everything on the host) element by element.
template <typename T> MPCQ_HD void store_span(int t, int nt, T* dst, const T* src, int n) {
  for (int e0 = 4 * t; e0 < n; e0 += 4 * nt) {
#if defined(__CUDA_ARCH__)
    if constexpr (std::is_same_v<T, float>) {
      if (e0 + 4 <= n) {
        *reinterpret_cast<float4*>(dst + e0) = *reinterpret_cast<const float4*>(src + e0);
        continue;
      }
    }
#endif
    for (int e = e0; e < e0 + 4 && e < n; ++e) dst[e] = src[e];
  }
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

// cp.async, which the card's teams share: one 4-byte copy from device to
// shared memory into the thread's open group, the commit that closes the
// group, and the wait until at most `Pending` of the thread's latest groups
// are in flight.
template <typename T> __device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  static_assert(sizeof(T) == 4, "cp.async copies 4-byte elements here");
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// One 16-byte copy (both addresses 16-byte aligned), past L1.
template <typename T> __device__ __forceinline__ void cp_async16(T* dst, const T* src) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// One warp works on one scenario.
struct WarpTeam {
  int lane;
  static constexpr int size = 32;
  // The lane index read again from the hardware: a value the compiler
  // cannot hoist, for loops whose per-lane addresses it should not keep in
  // registers across an enclosing loop.
  __device__ __forceinline__ int lane_again() const {
    unsigned l;
    asm volatile("mov.u32 %0, %%laneid;" : "=r"(l));
    return int(l);
  }
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
  // lane src's v, on every lane
  template <typename T> __device__ __forceinline__ T bcast(T v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  // Starts copying n elements from device memory to shared memory
  // (cp.async, 4 bytes a copy, lane-strided) as one commit group.
  template <typename T>
  __device__ __forceinline__ void copy_async(T* dst, const T* src, int n) const {
    copy_async_part(dst, src, n);
    commit_async();
  }
  // The same copy into the lane's open group, which commit_async() closes:
  // one group of several spans.
  template <typename T>
  __device__ __forceinline__ void copy_async_part(T* dst, const T* src, int n) const {
    for (int e = lane; e < n; e += size) cp_async4(dst + e, src + e);
  }
  // The same for N 4-byte elements at any 4-byte-aligned src, into the
  // open group as 16-byte copies of the aligned quads that hold them: src[e]
  // lands at dst[lag + e], lag = quad_lag(src) (dst 16-byte aligned).
  template <int N, typename T>
  __device__ __forceinline__ void copy_async_quads(T* dst, const T* src, int lag) const {
    const int quads = (lag + N + 3) / 4;
#pragma unroll
    for (int r = 0; r < ((N + 6) / 4 + size - 1) / size; ++r) {
      const int q = lane + r * size;
      if (q < quads) cp_async16(dst + 4 * q, src - lag + 4 * q);
    }
  }
  // Starts one 4-byte cp.async into the lane's open group (kernel E's
  // staging of H, which scatters).
  template <typename T> __device__ __forceinline__ void copy_elem(T* dst, const T* src) const {
    cp_async4(dst, src);
  }
  __device__ __forceinline__ void commit_async() const { cp_async_commit(); }
  // Waits until at most `Pending` of this lane's latest commit groups are in
  // flight, then syncs, so every lane's finished copies are visible.
  template <int Pending> __device__ __forceinline__ void wait_async() const {
    cp_async_wait<Pending>();
    __syncwarp();
  }
};

// Half a warp works on one scenario, the other half on another (kernel E's
// paired blocks): the two halves run the same instructions on their own
// data.  A lane stands for two of a warp team's lanes, l and l + 16, so a
// reduction keeps the warp's order: sum2(a, b) takes lane l's and lane
// l + 16's partials, adds them (the warp's first butterfly step, at offset
// 16), then reduces at offsets 8, 4, 2, 1 inside the half.  sync() is the
// whole warp's: both halves reach every sync.
struct HalfWarpTeam {
  int lane;
  static constexpr int size = 16;
  // The lane read again from the hardware (see WarpTeam::lane_again).
  __device__ __forceinline__ int lane_again() const {
    unsigned l;
    asm volatile("mov.u32 %0, %%laneid;" : "=r"(l));
    return int(l) & 15;
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  template <typename T> __device__ __forceinline__ T sum2(T a, T b) const {
    T v = a + b;
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  template <typename T> __device__ __forceinline__ T min(T v) const {
    for (int o = 8; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  template <typename T> __device__ __forceinline__ T max(T v) const {
    for (int o = 8; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  // lane src's v of this half, on every lane of the half
  template <typename T> __device__ __forceinline__ T bcast(T v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, 16);
  }
  template <typename T> __device__ __forceinline__ void copy_elem(T* dst, const T* src) const {
    cp_async4(dst, src);
  }
  __device__ __forceinline__ void commit_async() const { cp_async_commit(); }
  template <int Pending> __device__ __forceinline__ void wait_async() const {
    cp_async_wait<Pending>();
    __syncwarp();
  }
};

// A whole block of NT threads works on one scenario (kernel J): the warp's
// cp.async groups and waits, __syncthreads for the sync.  No reductions.
template <int NT> struct BlockTeam {
  int lane;
  static constexpr int size = NT;
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  // Starts one 4-byte cp.async into the lane's open group: a copy may
  // scatter (kernel J's transposition of A and B into J's layout).
  template <typename T> __device__ __forceinline__ void copy_elem(T* dst, const T* src) const {
    cp_async4(dst, src);
  }
  __device__ __forceinline__ void commit_async() const { cp_async_commit(); }
  template <int Pending> __device__ __forceinline__ void wait_async() const {
    cp_async_wait<Pending>();
    __syncthreads();
  }
};

// Lets a kernel take `smem` bytes of dynamic shared memory, with the SM's
// carve-out at its largest share for shared memory.
template <typename K> cudaError_t allow_smem(K kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

// allow_smem up to the current device's opt-in limit, so that a launch of
// any size the device takes needs no further attribute call.
template <typename K> cudaError_t allow_smem_max(K kernel) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? allow_smem(kernel, size_t(optin)) : err;
}

// allow_smem_max once per device (devices 0-63) for the kernel whose
// launcher keeps this: the small-batch launches make no attribute call.
struct SmemOnce {
  unsigned long long done = 0;
  template <typename K> cudaError_t operator()(K kernel) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (done & bit) return cudaSuccess;
    err = allow_smem_max(kernel);
    if (err == cudaSuccess) done |= bit;
    return err;
  }
};

// Resident blocks of `threads` threads (one warp unless given) per SM of a
// kernel at `smem`, from the occupancy API, or -1.  It leaves the kernel
// allowed the device's opt-in limit (allow_smem_max), never less than a
// launcher set before.
template <typename K> int resident_blocks(K kernel, size_t smem, int threads = 32) {
  int blocks = 0;
  if (allow_smem_max(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) != cudaSuccess)
    return -1;
  return blocks;
}
#endif

// The host build's serial team: one lane that runs every loop serially.
struct SerialTeam {
  int lane = 0;
  static constexpr int size = 1;
  MPCQ_HD int lane_again() const { return lane; }
  MPCQ_HD void sync() const {}
  template <typename T> MPCQ_HD T sum(T v) const { return v; }
  template <typename T> MPCQ_HD T min(T v) const { return v; }
  template <typename T> MPCQ_HD T max(T v) const { return v; }
  template <typename T> MPCQ_HD T bcast(T v, int) const { return v; }
  template <typename T> MPCQ_HD void copy_async(T* dst, const T* src, int n) const {
    copy_async_part(dst, src, n);
  }
  template <typename T> MPCQ_HD void copy_async_part(T* dst, const T* src, int n) const {
    for (int e = 0; e < n; ++e) dst[e] = src[e];
  }
  template <int N, typename T> MPCQ_HD void copy_async_quads(T* dst, const T* src, int lag) const {
    copy_async_part(dst + lag, src, N);
  }
  template <typename T> MPCQ_HD void copy_elem(T* dst, const T* src) const { *dst = *src; }
  MPCQ_HD void commit_async() const {}
  template <int Pending> MPCQ_HD void wait_async() const {}
};

// Register slots of a lane in the host builds: nz <= 256 with either team.
template <typename Team> constexpr int host_slots = 256 / Team::size;

}  // namespace mpcq

#if !defined(__CUDACC__)
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

namespace mpcq {

// State the threads of a ThreadTeam share: the barrier and two banks of
// exchange slots.
template <int Lanes = 32> struct ThreadShared {
  static constexpr int lanes = Lanes;
  std::barrier<> bar{lanes};
  double slots[2][lanes];
};

// The host build's warp (Lanes = 32) or block: one thread a lane, each
// running the kernel body with its own lane index and registers over one
// shared workspace.
// sync() is the barrier; a reduction or broadcast writes the lane's value to
// a slot bank, passes the barrier and reads the bank.  The banks alternate
// from one exchange to the next, so a bank is written again only after every
// lane has passed the barrier of the exchange in between, that is, after
// every lane has read it.  Every lane reads the same slots in the same order,
// so all lanes get the same bits.
template <int Lanes = 32> struct ThreadTeam {
  int lane;
  ThreadShared<Lanes>* sh;
  mutable int bank = 0;
  static constexpr int size = Lanes;
  int lane_again() const { return lane; }
  void sync() const { sh->bar.arrive_and_wait(); }
  const double* exchange(double v) const {
    double* s = sh->slots[bank];
    bank ^= 1;
    s[lane] = v;
    sync();
    return s;
  }
  template <typename T> T sum(T v) const {
    const double* s = exchange(double(v));
    T acc = T(s[0]);
    for (int l = 1; l < size; ++l) acc = acc + T(s[l]);
    return acc;
  }
  template <typename T> T min(T v) const {
    const double* s = exchange(double(v));
    T acc = T(s[0]);
    for (int l = 1; l < size; ++l) acc = nan_min(acc, T(s[l]));
    return acc;
  }
  template <typename T> T max(T v) const {
    const double* s = exchange(double(v));
    T acc = T(s[0]);
    for (int l = 1; l < size; ++l) acc = nan_max(acc, T(s[l]));
    return acc;
  }
  template <typename T> T bcast(T v, int src) const { return T(exchange(double(v))[src]); }
  // The sum over 2 Lanes virtual lanes, lane l holding l's partial a and
  // (l + Lanes)'s partial b, in the order of the same sum over a team of
  // 2 Lanes threads (the card's HalfWarpTeam::sum2 for Lanes = 16).  Each
  // bank is read before the next exchange, as the banks' alternation needs.
  template <typename T> T sum2(T a, T b) const {
    const double* s = exchange(double(a));
    T acc = T(s[0]);
    for (int l = 1; l < size; ++l) acc = acc + T(s[l]);
    s = exchange(double(b));
    for (int l = 0; l < size; ++l) acc = acc + T(s[l]);
    return acc;
  }
  template <typename T> void copy_async(T* dst, const T* src, int n) const {
    copy_async_part(dst, src, n);
  }
  template <typename T> void copy_async_part(T* dst, const T* src, int n) const {
    for (int e = lane; e < n; e += size) dst[e] = src[e];
  }
  // The card's quads, element by element, into the same places.
  template <int N, typename T> void copy_async_quads(T* dst, const T* src, int lag) const {
    copy_async_part(dst + lag, src, N);
  }
  template <typename T> void copy_elem(T* dst, const T* src) const { *dst = *src; }
  void commit_async() const {}
  template <int Pending> void wait_async() const { sync(); }
};

// Runs body(team, b) for b in [0, B) with a ThreadTeam of Lanes threads,
// every lane over the same scenarios in order.
template <int Lanes, typename Body> int run_thread_team(int64_t B, Body body) {
  ThreadShared<Lanes> sh;
  std::vector<std::thread> threads;
  for (int l = 0; l < Lanes; ++l)
    threads.emplace_back([&, l] {
      ThreadTeam<Lanes> tm{l, &sh};
      for (int64_t b = 0; b < B; ++b) {
        body(tm, b);
        tm.sync();  // the workspace is reused by the next scenario
      }
    });
  for (auto& t : threads) t.join();
  return 0;
}

// Runs body(team, b, w) for b in [0, B) as the card runs a kernel whose
// blocks hold `warps` teams of Lanes lanes: team w of block i takes scenario
// i warps + w and slot w of the block's workspace; the teams run side by
// side and never wait on one another.
template <int Lanes, typename Body> int run_block_teams(int warps, int64_t B, Body body) {
  std::unique_ptr<ThreadShared<Lanes>[]> sh(new ThreadShared<Lanes>[warps]);
  std::vector<std::thread> threads;
  for (int w = 0; w < warps; ++w)
    for (int l = 0; l < Lanes; ++l)
      threads.emplace_back([&, w, l] {
        ThreadTeam<Lanes> tm{l, &sh[w]};
        for (int64_t b = w; b < B; b += warps) {
          body(tm, b, w);
          tm.sync();  // the slot is reused by the team's next scenario
        }
      });
  for (auto& t : threads) t.join();
  return 0;
}

// Runs body(team, b) for b in [0, B) with one serial lane (lanes = 1) or a
// ThreadTeam of the card team's Lanes (32, the warp, unless the kernel runs
// on a block); -1 for any other count.
template <int Lanes = 32, typename Body> int run_host_team(int lanes, int64_t B, Body body) {
  if (lanes == 1) {
    SerialTeam tm;
    for (int64_t b = 0; b < B; ++b) body(tm, b);
    return 0;
  }
  return lanes == Lanes ? run_thread_team<Lanes>(B, body) : -1;
}

}  // namespace mpcq
#endif
