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
// evaluations a step; the 17 tangents that ride on the step are the
// derivative half of each dual operation, with three IEEE divisions an
// evaluation.  J is the only large stream (221 floats a column, written
// once: at 1 ms a sixth of the card's memory rate).
//
// Design: a block takes a tile of `cols` consecutive columns (b, k) on
// THREADS = 128 threads, every warp busy in both passes; cols is TILE = 128
// unless the grid would then give the card fewer than FILL_BLOCKS blocks an
// SM (64 or 32: a mid-sized batch's blocks spread over more SMs):
// 1. the primal, one thread a column: model.cuh's rk4 on Val numbers,
//    recording what the tangents read besides their own derivatives
//    (model.cuh's record, which kernel F keeps too: each RK4 stage's q, v
//    and w, and a_m; the drag's means m and their Jacobian diagonal jd at
//    each stage, the JAX custom-JVP rule): 65 floats a column, the tile's
//    columns side by side in shared memory.
//    x+ leaves through the warp's stage buffer;
// 2. after one block barrier, the tile's cols x 17 (column, tangent) items,
//    in rounds of one a thread: model.cuh's tangent_item, dual numbers whose
//    every value is a recorded one, so the compiler keeps the derivative
//    half of each operation (and the rotation entries from the recorded q)
//    and drops the rest: no exponential, no division by L^2, no read of X
//    or U.  A warp's 32 items of a round are 32 consecutive rows of J (416
//    floats, 16-byte aligned when J is): the lanes write them into the
//    warp's stage buffer, then copy it out as 16-byte stores, with only warp
//    syncs.
// model.cuh rounds every operation explicitly, so the recorded values are
// the dual pass's values bit for bit and xp and J are kernel F's
// linearisation (the three pipelines' U agree bitwise), whatever each
// kernel's compiler contracts.  65 x 128 + 4 x 416 floats = 39,936 B of
// shared memory a block: 5 blocks an SM by shared memory, and the launch
// bound fits the registers to them (96, no spill; 20 warps an SM).  A TMA
// bulk store of the stage buffer would overlap J's stream with the next
// round's arithmetic; the stores already leave without a wait (no load
// depends on them), so it is not used.  Nothing is reduced across columns,
// so a NaN in one scenario leaves every other scenario's outputs bitwise
// unchanged.

#include "model.cuh"

namespace mpcq {
namespace lin {

constexpr int TILE = 128, THREADS = 128;   // columns and threads per block
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 5;              // resident blocks an SM asked of the compiler
constexpr int J_COL = NT * NX;             // J's floats per column
// A block's shared memory in elements: the records, then one stage buffer a
// warp (32 rows of 13: its x+ or its J rows of a round), 16-byte aligned.
constexpr int STAGE = 32 * NX;
constexpr int SM_STAGE = TILE * R_FIELDS;
constexpr int SM_SIZE = SM_STAGE + WARPS * STAGE;
static_assert(SM_STAGE % 4 == 0 && STAGE % 4 == 0 && TILE * J_COL % 4 == 0,
              "stage buffers and a warp's span of J or x+ start 16-byte aligned");

template <typename T> struct Args {
  const T *X, *U, *Xb, *wb, *L, *sf;
  int nb;
  T *xp, *J;
  int64_t B;
  int N;
  ModelConsts<T> c;
};

MPCQ_HD int clamp_rows(int left) { return left < 0 ? 0 : left < 32 ? left : 32; }

// One block's tile of columns [col0, col0 + ncols), ncols <= cols <= TILE,
// step by step; thread t (warp t / 32, lane t % 32) runs its share of each
// step, the caller syncs the warp or the block between steps.  sm is the
// block's shared memory (SM_SIZE elements).
template <typename T> struct Tile {
  const Args<T> a;
  T* sm;
  int64_t col0, node0;   // the first column, and its node's index in X
  int k0;                // the first column's stage
  int ncols;

  MPCQ_HD Tile(const Args<T>& args, T* smem, int64_t block, int cols)
      : a(args), sm(smem), col0(block * cols) {
    const int64_t left = a.B * a.N - col0;
    ncols = int(left < cols ? left : cols);
    k0 = int(col0 % a.N);
    node0 = col0 / a.N * (a.N + 1) + k0;
  }
  // column cl's scenario, counted from the first column's
  MPCQ_HD int scenario(int cl) const { return (k0 + cl) / a.N; }
  MPCQ_HD const T* node(int cl) const { return a.X + (node0 + cl + scenario(cl)) * NX; }
  MPCQ_HD T* record(int cl) const { return sm + cl; }
  MPCQ_HD T* stage(int w) const { return sm + SM_STAGE + w * STAGE; }
  MPCQ_HD int items() const { return ncols * NT; }
  MPCQ_HD int rounds() const { return (items() + THREADS - 1) / THREADS; }
  // pass 1: column t's step, recorded; x+ into its warp's stage buffer
  MPCQ_HD void primal(int t) const {
    if (t >= ncols) return;
    const DragView<T> g =
        drag_of((col0 - k0) / a.N + scenario(t), a.Xb, a.wb, a.L, a.sf, a.nb);
    Val<T> x[NX];
    step_item(node(t), a.U + (col0 + t) * NU, RecordPrimal<T, TILE>{g, record(t)}, a.c, x);
    T* st = stage(t / 32) + t % 32 * NX;
    for (int j = 0; j < NX; ++j) st[j] = x[j].v;
  }
  // x+ of the warp's 32 columns leaves its stage buffer
  MPCQ_HD void store_xp(int t) const {
    const int w = t / 32, c0 = 32 * w;
    store_span(t % 32, 32, a.xp + (col0 + c0) * NX, stage(w), clamp_rows(ncols - c0) * NX);
  }
  // pass 2: item it = (column it / 17, tangent it % 17), its J row into warp
  // w's stage buffer (row it % 32 of it)
  MPCQ_HD void tangent(int it, int w) const {
    const int cl = it / NT, i = it % NT;
    Dual<T> x[NX];
    tangent_item(Recorded<T, TILE>{record(cl), a.nb}, i, a.c, x);
    T* st = stage(w) + it % 32 * NX;
    for (int j = 0; j < NX; ++j) st[j] = x[j].d;
  }
  // round q's rows of warp w (32 consecutive rows of J) leave its stage buffer
  MPCQ_HD void store_rows(int q, int w, int lane) const {
    const int r0 = q * THREADS + 32 * w;
    T* dst = a.J + (col0 * NT + r0) * NX;
    const T* src = stage(w);
    const int n = clamp_rows(items() - r0) * NX;
    store_span(lane, 32, dst, src, n);
  }
};

template <typename T>
Args<T> args_from(const T* X, const T* U, const T* Xb, const T* wb, const T* L, const T* sf,
                  int nb, T* xp, T* J, int64_t B, int N, const T* consts) {
  return {X, U, Xb, wb, L, sf, nb, xp, J, B, N, consts_from<T>(consts)};
}

MPCQ_HD int64_t blocks(int64_t B, int N, int cols) { return (B * N + cols - 1) / cols; }

// Columns a block: TILE, halved (down to 32) while the grid would give the
// card fewer than FILL_BLOCKS blocks an SM, so that a mid-sized batch
// spreads over more SMs and warps, each block's chain of rounds shorter.
constexpr int FILL_BLOCKS = 4;
MPCQ_HD int tile_cols(int64_t B, int N, int sms) {
  int cols = TILE;
  while (cols > 32 && blocks(B, N, cols) < int64_t(sms) * FILL_BLOCKS) cols /= 2;
  return cols;
}

}  // namespace lin
}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernel, in bytes.
extern "C" int64_t mpcq_lin_ws_bytes(int) {
  return int64_t(mpcq::lin::SM_SIZE) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(mpcq::lin::THREADS, mpcq::lin::MIN_BLOCKS)
mpcq_lin_kernel(const mpcq::lin::Args<float> a, int cols) {
  using namespace mpcq::lin;
  extern __shared__ __align__(16) float sm[];
  const Tile<float> tile(a, sm, blockIdx.x, cols);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  tile.primal(threadIdx.x);
  __syncwarp();
  tile.store_xp(threadIdx.x);
  __syncthreads();      // every column's record is in
  const int rounds = tile.rounds();
  for (int q = 0; q < rounds; ++q) {
    const int it = q * THREADS + threadIdx.x;
    __syncwarp();       // the stage buffer's last copy is out
    if (it < tile.items()) tile.tangent(it, w);
    __syncwarp();
    tile.store_rows(q, w, lane);
  }
}

namespace {
mpcq::SmemOnce lin_smem;   // the shared-memory attributes, once a device
int lin_sms[64];           // SMs of devices 0-63, read at their first launch

int sm_count() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int* slot = dev >= 0 && dev < 64 ? &lin_sms[dev] : nullptr;
  if (slot && *slot > 0) return *slot;
  int sms = 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) sms = 1;
  if (slot) *slot = sms;
  return sms;
}
}  // namespace

extern "C" int mpcq_lin(const float* X, const float* U, const float* Xb, const float* wb,
                        const float* L, const float* sf, int nb, float* xp, float* J,
                        int64_t B, int N, const float* consts, void* stream) {
  using namespace mpcq::lin;
  if ((reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(J)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);   // the 16-byte stores need aligned outputs
  cudaError_t err = lin_smem(mpcq_lin_kernel);
  if (err != cudaSuccess) return int(err);
  const int cols = tile_cols(B, N, sm_count());
  const int64_t nblk = blocks(B, N, cols);
  if (nblk > 0)
    mpcq_lin_kernel<<<dim3(unsigned(nblk)), THREADS, size_t(mpcq_lin_ws_bytes(N)),
                      (cudaStream_t)stream>>>(
        args_from(X, U, Xb, wb, L, sf, nb, xp, J, B, N, consts), cols);
  return int(cudaGetLastError());
}

// Resident blocks (of THREADS threads) per SM, from the occupancy API.
extern "C" int mpcq_lin_occupancy(int N) {
  return mpcq::resident_blocks(mpcq_lin_kernel, size_t(mpcq_lin_ws_bytes(N)),
                               mpcq::lin::THREADS);
}

#else
#include <vector>

// Host build of the same code (f64), for the CPU tests: every tile of
// `cols` columns (32, 64 or 128) step by step, each step's threads one after
// another, so the columns and items fall to the threads and warps as on the
// card.
extern "C" int mpcq_lin_tiles_host_f64(const double* X, const double* U, const double* Xb,
                                       const double* wb, const double* L, const double* sf,
                                       int nb, double* xp, double* J, int64_t B, int N,
                                       const double* consts, int cols) {
  using namespace mpcq::lin;
  if (cols != 32 && cols != 64 && cols != TILE) return 1;
  const Args<double> a = args_from(X, U, Xb, wb, L, sf, nb, xp, J, B, N, consts);
  std::vector<double> sm(SM_SIZE);
  for (int64_t blk = 0; blk < blocks(B, N, cols); ++blk) {
    const Tile<double> tile(a, sm.data(), blk, cols);
    for (int t = 0; t < THREADS; ++t) tile.primal(t);
    for (int t = 0; t < THREADS; ++t) tile.store_xp(t);
    for (int q = 0; q < tile.rounds(); ++q) {
      for (int t = 0; t < THREADS; ++t)
        if (q * THREADS + t < tile.items()) tile.tangent(q * THREADS + t, t / 32);
      for (int t = 0; t < THREADS; ++t) tile.store_rows(q, t / 32, t % 32);
    }
  }
  return 0;
}

// The same in tiles of TILE columns, the card's at large batches.
extern "C" int mpcq_lin_host_f64(const double* X, const double* U, const double* Xb,
                                 const double* wb, const double* L, const double* sf,
                                 int nb, double* xp, double* J, int64_t B, int N,
                                 const double* consts) {
  return mpcq_lin_tiles_host_f64(X, U, Xb, wb, L, sf, nb, xp, J, B, N, consts,
                                 mpcq::lin::TILE);
}

// The dual pass the tangent pass takes apart: one lin_item a (column,
// tangent) on the scenario's own drag, the primal recomputed in each (as
// kernel F walked them before it took the record too); x+ from tangent 0's.  Host only (f64), for the CPU
// test that the recorded pass gives its bits.
extern "C" int mpcq_lin_dual_host_f64(const double* X, const double* U, const double* Xb,
                                      const double* wb, const double* L, const double* sf,
                                      int nb, double* xp, double* J, int64_t B, int N,
                                      const double* consts) {
  using namespace mpcq;
  const ModelConsts<double> c = consts_from<double>(consts);
  for (int64_t col = 0; col < B * N; ++col) {
    const int64_t b = col / N;
    const double* x0 = X + (b * (N + 1) + col % N) * NX;
    const DragView<double> g = drag_of(b, Xb, wb, L, sf, nb);
    for (int i = 0; i < NT; ++i) {
      Dual<double> x[NX];
      lin_item(x0, U + col * NU, g, i, c, x);
      for (int j = 0; j < NX; ++j) {
        J[(col * NT + i) * NX + j] = x[j].d;
        if (i == 0) xp[col * NX + j] = x[j].v;
      }
    }
  }
  return 0;
}

#endif
