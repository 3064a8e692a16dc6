// Kernel A: RK4 shooting-map linearisation with the folded-RGP drag.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/lin_kernel.py::_lin_kernel.  For every
// (scenario b, stage k) it writes x+ = RK4(f, x_k, u_k, dt) (13 values) and
// J = [A | B] as 17 tangent rows of 13 (row i = d x+ / d (x, u)_i), laid out
// scenario-major: xp (B, N, 13), J (B, N, 17, 13).  X is read as the whole
// (B, N+1, 13) trajectory (stage k reads node k), U as (B, N, 4), the folded
// drag per scenario: Xb, wb (B, 3, nb), L, sigma_f (B, 3).
//
// What bounds it on the H100: operations.  The drag's means cost 3 nb
// exponentials and 6 nb IEEE divisions per model evaluation, four
// evaluations a step, each a multi-instruction sequence; the 17 tangents
// that ride on the step are ~2-3 operations per primal one.  J is the only
// large stream (221 floats a column, written once).
//
// Design: a block takes COLS = 32 consecutive columns (b, k) on THREADS =
// 128 threads, in three phases separated by block barriers:
// 1. tangent 0 of each column, one thread a column (one warp): model.cuh's
//    lin_item on dual numbers with the drag recorded: at each RK4 stage the
//    dual drag_mean gives the means m and the diagonal of their Jacobian jd
//    (the JAX custom-JVP rule), kept in shared memory (24 floats a column);
//    this item also gives x+ and row 0 of J;
// 2. the other 16 tangents, the block's 32 x 16 items over the 128 threads
//    (4 rounds): lin_item with the drag read back as (m, jd dvb), so they
//    evaluate no exponential and no division by L^2 (the 3 nb exponentials
//    and 6 nb divisions a model evaluation run once a column, not 17 times);
//    each writes its J row into shared memory;
// 3. the block's J rows and x+ (contiguous in device memory: 221 and 13
//    floats a column, so 16-byte aligned at every block of 32 columns when
//    the arrays are) leave shared memory as 16-byte stores.
// Every item is lin_item's arithmetic, and the drag's moments come from
// lin_item's own dual drag_mean, so xp and J are kernel F's linearisation
// (the three pipelines' U agree bitwise).  Against one thread per (column,
// tangent) they differ in ~0.1 % of the entries by an ulp or two, and only
// with the drag: the compiler contracts a few of the drag's products
// otherwise in this kernel.  128 registers a thread: the launch bound asks
// for 4 blocks (16 warps) an SM; at 5 it spills 328 bytes and runs slower.
// 33,024 B of shared memory a block.  Nothing is reduced across columns, so
// a NaN in one scenario leaves every other scenario's outputs bitwise
// unchanged.

#include <type_traits>

#include "model.cuh"

namespace mpcq {
namespace lin {

constexpr int COLS = 32, THREADS = 128;   // columns and threads per block
constexpr int MIN_BLOCKS = 4;             // resident blocks an SM asked of the compiler
constexpr int J_COL = NT * NX;            // J's floats per column
constexpr int MD = 6;                     // m (3), jd (3) per RK4 stage

constexpr int round4(int n) { return (n + 3) / 4 * 4; }
// A block's shared memory in elements: the drag moments (COLS x 4 stages x
// 6), J (COLS x 221) and x+ (COLS x 13), each region 16-byte aligned.
constexpr int SM_MD = 0;
constexpr int SM_J = COLS * 4 * MD;
constexpr int SM_XP = SM_J + round4(COLS * J_COL);
constexpr int SM_SIZE = SM_XP + round4(COLS * NX);
static_assert(COLS * J_COL % 4 == 0 && COLS * NX % 4 == 0,
              "a block's J and x+ start 16-byte aligned in device memory");

template <typename T> struct Args {
  const T *X, *U, *Xb, *wb, *L, *sf;
  int nb;
  T *xp, *J;
  int64_t B;
  int N;
  ModelConsts<T> c;
};

// Tangent 0's drag: the scenario's DragView, stage s's (m, jd) recorded at
// md + 6 s by model.cuh's dual drag_mean.
template <typename T> struct RecordDrag {
  DragView<T> g;
  T* md;
};
template <typename T> struct RecordStage {
  DragView<T> g;
  T* md;
  int nb;
};
template <typename T> MPCQ_HD RecordStage<T> stage_drag(const RecordDrag<T>& r, int s) {
  return {r.g, r.md + s * MD, r.g.nb};
}
template <typename T> MPCQ_HD Dual<T> drag_mean(Dual<T> vb, const RecordStage<T>& r, int a) {
  const Dual<T> m = drag_mean(vb, r.g, a, r.md + 3 + a);
  r.md[a] = m.v;
  return m;
}

// The other tangents' drag: stage s's recorded moments, tangent jd * dvb
// (the product the dual drag_mean forms).
template <typename T> struct RecordedDrag {
  const T* md;
  int nb;
};
template <typename T> MPCQ_HD RecordedDrag<T> stage_drag(const RecordedDrag<T>& r, int s) {
  return {r.md + s * MD, r.nb};
}
template <typename T> MPCQ_HD Dual<T> drag_mean(Dual<T> vb, const RecordedDrag<T>& r, int a) {
  return {r.md[a], r.md[3 + a] * vb.d};
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

// One block's columns [col0, col0 + ncols) on nt threads, phase by phase;
// thread t runs its share of each phase, the caller syncs the block between
// phases.  sm is the block's shared memory (SM_SIZE elements).
template <typename T> struct Block {
  const Args<T> a;
  T* sm;
  int64_t col0;
  int ncols;

  MPCQ_HD Block(const Args<T>& args, T* smem, int64_t block)
      : a(args), sm(smem), col0(block * COLS) {
    const int64_t left = a.B * a.N - col0;
    ncols = int(left < COLS ? left : COLS);
  }
  MPCQ_HD const T* node(int64_t col) const {
    return a.X + (col / a.N * (a.N + 1) + col % a.N) * NX;
  }
  MPCQ_HD T* moments(int cl) const { return sm + SM_MD + cl * 4 * MD; }
  MPCQ_HD T* row(int cl, int i) const { return sm + SM_J + (cl * NT + i) * NX; }
  // phase 1: tangent 0 of each column, recording the drag's moments; x+
  MPCQ_HD void primal(int t, int nt) const {
    for (int cl = t; cl < ncols; cl += nt) {
      const int64_t col = col0 + cl, b = col / a.N;
      const int nb = a.nb;
      const DragView<T> g{nb > 0 ? a.Xb + b * 3 * nb : nullptr,
                          nb > 0 ? a.wb + b * 3 * nb : nullptr, nb > 0 ? a.L + b * 3 : nullptr,
                          nb > 0 ? a.sf + b * 3 : nullptr, nb};
      Dual<T> x[NX];
      lin_item(node(col), a.U + col * NU, RecordDrag<T>{g, moments(cl)}, 0, a.c, x);
      T* r = row(cl, 0);
      T* xp = sm + SM_XP + cl * NX;
      for (int j = 0; j < NX; ++j) {
        r[j] = x[j].d;
        xp[j] = x[j].v;
      }
    }
  }
  // phase 2: tangents 1-16 of every column, the drag read back
  MPCQ_HD void tangents(int t, int nt) const {
    for (int it = t; it < ncols * (NT - 1); it += nt) {
      const int cl = it / (NT - 1), i = 1 + it % (NT - 1);
      const int64_t col = col0 + cl;
      Dual<T> x[NX];
      lin_item(node(col), a.U + col * NU, RecordedDrag<T>{moments(cl), a.nb}, i, a.c, x);
      T* r = row(cl, i);
      for (int j = 0; j < NX; ++j) r[j] = x[j].d;
    }
  }
  MPCQ_HD void store(int t, int nt) const {
    store_span(t, nt, a.J + col0 * J_COL, sm + SM_J, ncols * J_COL);
    store_span(t, nt, a.xp + col0 * NX, sm + SM_XP, ncols * NX);
  }
};

template <typename T>
Args<T> args_from(const T* X, const T* U, const T* Xb, const T* wb, const T* L, const T* sf,
                  int nb, T* xp, T* J, int64_t B, int N, const T* consts) {
  return {X, U, Xb, wb, L, sf, nb, xp, J, B, N, consts_from<T>(consts)};
}

MPCQ_HD int64_t blocks(int64_t B, int N) { return (B * N + COLS - 1) / COLS; }

}  // namespace lin
}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernel, in bytes.
extern "C" int64_t mpcq_lin_ws_bytes(int) {
  return int64_t(mpcq::lin::SM_SIZE) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(mpcq::lin::THREADS, mpcq::lin::MIN_BLOCKS)
mpcq_lin_kernel(const mpcq::lin::Args<float> a) {
  extern __shared__ __align__(16) float sm[];
  const mpcq::lin::Block<float> blk(a, sm, blockIdx.x);
  blk.primal(threadIdx.x, blockDim.x);
  __syncthreads();
  blk.tangents(threadIdx.x, blockDim.x);
  __syncthreads();
  blk.store(threadIdx.x, blockDim.x);
}

extern "C" int mpcq_lin(const float* X, const float* U, const float* Xb, const float* wb,
                        const float* L, const float* sf, int nb, float* xp, float* J,
                        int64_t B, int N, const float* consts, void* stream) {
  using namespace mpcq::lin;
  if ((reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(J)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);   // the 16-byte stores need aligned outputs
  const size_t smem = size_t(mpcq_lin_ws_bytes(N));
  cudaError_t err = mpcq::allow_smem(mpcq_lin_kernel, smem);
  if (err != cudaSuccess) return int(err);
  const int64_t nblk = blocks(B, N);
  if (nblk > 0)
    mpcq_lin_kernel<<<dim3(unsigned(nblk)), THREADS, smem, (cudaStream_t)stream>>>(
        args_from(X, U, Xb, wb, L, sf, nb, xp, J, B, N, consts));
  return int(cudaGetLastError());
}

// Resident blocks (of THREADS threads) per SM, from the occupancy API.
extern "C" int mpcq_lin_occupancy(int N) {
  return mpcq::resident_blocks(mpcq_lin_kernel, size_t(mpcq_lin_ws_bytes(N)),
                               mpcq::lin::THREADS);
}

#else
#include <vector>

// Host build of the same code (f64), for the CPU tests: every block's
// phases in order, each phase's threads one after another, so the items
// fall to the threads as on the card.
extern "C" int mpcq_lin_host_f64(const double* X, const double* U, const double* Xb,
                                 const double* wb, const double* L, const double* sf,
                                 int nb, double* xp, double* J, int64_t B, int N,
                                 const double* consts) {
  using namespace mpcq::lin;
  const Args<double> a = args_from(X, U, Xb, wb, L, sf, nb, xp, J, B, N, consts);
  std::vector<double> sm(SM_SIZE);
  for (int64_t blk = 0; blk < blocks(B, N); ++blk) {
    const Block<double> bl(a, sm.data(), blk);
    for (int t = 0; t < THREADS; ++t) bl.primal(t, THREADS);
    for (int t = 0; t < THREADS; ++t) bl.tangents(t, THREADS);
    for (int t = 0; t < THREADS; ++t) bl.store(t, THREADS);
  }
  return 0;
}

#endif
