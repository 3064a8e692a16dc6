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
// - the condensing of condense.cuh into the packed layout (H's upper
//   triangle and a diagonal column, + rw diagonal), then g += gu;
// - the IPM of ipm_box.cuh, `iters` iterations, cold-started or warm-started
//   from the previous duals zl0, zu0 (null for the cold start); it writes the
//   new duals zl, zu (unscaled) on both starts;
// - the projected-gradient KKT residual max |clip(z - (H z + g), lb, ub) - z|
//   against the unscaled H (the packed upper triangle, which the IPM leaves
//   as it was) and g;
// - dX_0 = dx0, dX_{k+1} = r_k + A_k dX_k + B_k z_k.
//
// Kernel B's inputs (contiguous f32): J (B, N, 17, 13), r (B, N, 13),
// dx0 (B, 13), ex0 = X - [y_ref; y_ref_N] (B, N+1, 13), gu, lb, ub (B, nz),
// optional zl0, zu0 (B, nz).  Kernel F takes X (B, N+1, 13), U (B, N, 4) and
// the folded drag Xb, wb (B, 3, nb), L, sigma_f (B, 3) in place of J and r:
// its 32 lanes first walk the scenario's N x 17 (stage, tangent) items of
// model.cuh (6 rounds at N = 10), writing J and x+ - X_{k+1} into shared
// memory.  Outputs of both: z (B, nz), dX (B, N+1, 13), kkt (B), zl, zu
// (B, nz).  nz = 4 N.
//
// What bounds them on the H100: the IPM's per-scenario latency (nz dependent
// Cholesky columns and 2 nz dependent substitution steps, times `iters`, on
// one warp), which only many resident warps hide; shared memory and registers
// per SM set how many reside, and from 16 warps an SM at N = 10 the SM's
// instruction issue and shared-memory accesses bind as well (the Cholesky by
// panels in ipm_box.cuh cuts those).  The design keeps one scenario a warp and
// cuts each scenario's workspace to what is live.  Kernel B's shared memory
// holds, a scenario, one packed nz x (nz + 1) matrix (H, then H and the
// factor), g, one 13 x nz condensing map M (dead once the IPM starts: the
// IPM's s and z, its triangle table and the solution lie over it) and two d
// vectors: 8,904 B at N = 10, 131,144 B at N = 40.  J stays in device memory
// and is read where it lies, once for the condensing and once for the dX
// recurrence: in the map's recurrence every lane reads the same entry (one
// broadcast load through L1), in d's and dX's the 13 lanes of a row read one
// stage row.  Up to R = 2 (N <= 16) a block holds SQP_BLOCK_WARPS scenarios,
// one a warp, which share the 1 KB the card reserves a block, and ptxas is
// asked for SQP_MIN_BLOCKS such blocks an SM: at N = 10 12 blocks of two fit
// the 233,472 B of an SM, 24 warps, at no more than 80 registers a thread.
// Past R = 2 a block is one warp, and shared memory admits 1-9 of them an SM
// (9 at N = 17, 6 at N = 20, 1 at N = 40); at R = 3 ptxas is asked for 9, so
// that registers do not cut that below shared memory's count.  Kernel F
// keeps J staged (it has no copy in device memory) and its defects, one warp
// a block: 18,264 B at N = 10, 168,584 B at N = 40, and the registers of its
// linearisation.  Both are built
// for nz <= 160 (N <= 40, ops/sqp.py FUSED_N_MAX, the JAX package's ceiling):
// one instantiation per R = ceil(nz / 32) register slots a lane.  Nothing is
// reduced across warps, so a NaN in one scenario leaves every other scenario,
// its block's other warp included, bitwise unchanged.  Kernel F's
// linearisation runs on a quarter of the lanes kernel A would give it per SM
// (one warp per scenario instead of 17 threads per stage).

#include "condense.cuh"
#include "ipm_box.cuh"
#include "model.cuh"

namespace mpcq {

// Register slots a lane of kernels B and F holds: nz <= 32 FUSED_SLOTS.
constexpr int FUSED_SLOTS = 5;
// Kernel B up to R = 2 register slots a lane (N <= 16): scenarios (warps) a
// block, and the resident blocks an SM its registers are fitted to.
constexpr int SQP_BLOCK_WARPS = 2;
constexpr int SQP_MIN_BLOCKS = 12;
// Kernel B at R = 3 (N = 17-24, one warp a block): the blocks shared memory
// admits at N = 17 (24,516 B a block), so that registers (at most 224 a
// thread) admit as many.
constexpr int SQP_R3_MIN_BLOCKS = 9;

// Kernel B's scenarios (warps) a block, and the resident blocks an SM that
// ptxas fits its registers to, at R register slots a lane: the one place
// the kernel, its launcher and the occupancy query read them from.
MPCQ_HD constexpr int sqp_warps(int R) { return R <= 2 ? SQP_BLOCK_WARPS : 1; }
MPCQ_HD constexpr int sqp_min_blocks(int R) {
  return R <= 2 ? SQP_MIN_BLOCKS : R == 3 ? SQP_R3_MIN_BLOCKS : 1;
}
// Kernel B's scenarios a block at horizon N.
MPCQ_HD constexpr int sqp_block_warps(int N) { return sqp_warps((N * SU + 31) / 32); }

// Elements of the region that holds the condensing map M (13 x nz), then
// the IPM's vectors and the solution zf (nz): the larger of the two (the
// map up to nz = 41).
MPCQ_HD int64_t sqp_maps_size(int nz) {
  const int64_t map = SX * int64_t(nz), ipm = ipm_vec_size(nz) + nz;
  return map > ipm ? map : ipm;
}

// Kernel B's and F's shared workspace of one scenario (elements of T): the
// packed matrix A (nz x ld), g (nz), the maps region Mb, db (2 x 13), then,
// for kernel F, its staged J (N x 17 x 13) and defects r (N x 13).
template <typename T> struct SqpWork {
  T *A, *g, *Mb, *db, *J;
  MPCQ_HD SqpWork(T* ws, int N) {
    const int nz = N * SU;
    A = ws;
    g = A + packed_size(nz);
    Mb = g + nz;
    db = Mb + sqp_maps_size(nz);
    J = db + 2 * SX;
  }
};

// Kernel B's workspace of one scenario.
MPCQ_HD int64_t sqp_ws_size(int N) {
  const int nz = N * SU;
  return packed_size(nz) + nz + sqp_maps_size(nz) + 2 * SX;
}
// Kernel F's: kernel B's, J staged and the defects.
MPCQ_HD int64_t sqp_step_ws_size(int N) { return sqp_ws_size(N) + int64_t(N) * (J_STAGE + SX); }

// The step after J: condense, IPM, KKT, dX.  J and the defects rg lie in
// device or shared memory.
template <int R, typename T, typename Team>
MPCQ_HD void sqp_body(const Team& tm, int N, int iters, const Weights<T>& wt, const T* J,
                      const SqpWork<T>& w, const T* rg, const T* dx0, const T* ex0, const T* gu,
                      const T* lbg, const T* ubg, const T* zl0, const T* zu0, T* z_out,
                      T* dX_out, T* kkt_out, T* zl_out, T* zu_out) {
  const int nz = N * SU, ld = nz + 1, ln = tm.lane, NL = Team::size;
  T *A = w.A, *g = w.g, *db = w.db;

  condense_packed(tm, N, wt, J, w.Mb, db, A, g, rg, dx0, ex0);
  for (int i = ln; i < nz; i += NL) g[i] = g[i] + gu[i];
  tm.sync();

  // ---- interior point; its vectors over the dead condensing maps ----
  T* zf = w.Mb + ipm_vec_size(nz);
  ipm_box_solve<R>(tm, nz, iters, A, w.Mb, (const T*)g, lbg, ubg, zl0, zu0, zf, zl_out, zu_out);

  // ---- KKT projected-gradient residual against the unscaled H, g ----
  T part = T(0);
  for (int i = ln; i < nz; i += NL) {
    T Hz = mul_rn(h_sym(A, ld, i, 0), zf[0]);
    for (int j = 1; j < nz; ++j) Hz = fmadd(h_sym(A, ld, i, j), zf[j], Hz);
    T pr = clip(zf[i] - (Hz + g[i]), lbg[i], ubg[i]) - zf[i];
    part = nan_max(part, pr < T(0) ? -pr : pr);
    z_out[i] = zf[i];
  }
  T kkt = tm.max(part);
  if (ln == 0) kkt_out[0] = kkt;

  // ---- dX forward recurrence, J read again ----
  int cur = 0;
  for (int row = ln; row < SX; row += NL) {
    db[row] = dx0[row];
    dX_out[row] = dx0[row];
  }
  tm.sync();
  // J_k by a pointer stepped a stage at a time: one base register (from J
  // indexed afresh at each k the compiler kept an address per (j, row))
  const T* Jk = J;
  for (int k = 0; k < N; ++k, Jk += J_STAGE) {
    const T* xk = db + cur * SX;
    T* xn = db + (1 - cur) * SX;
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

// Kernel B's scenario: J read from device memory.
template <int R, typename T, typename Team>
MPCQ_HD void sqp_from_J_scenario(const Team& tm, int N, int iters, const Weights<T>& wt,
                                 const T* Jg, const T* rg, const T* dx0, const T* ex0,
                                 const T* gu, const T* lbg, const T* ubg, const T* zl0,
                                 const T* zu0, T* ws, T* z_out, T* dX_out, T* kkt_out,
                                 T* zl_out, T* zu_out) {
  sqp_body<R>(tm, N, iters, wt, Jg, SqpWork<T>(ws, N), rg, dx0, ex0, gu, lbg, ubg, zl0, zu0,
              z_out, dX_out, kkt_out, zl_out, zu_out);
}

// Kernel F's scenario: linearise (X, U) into the staged J and r, then kernel
// B's body on them.
template <int R, typename T, typename Team>
MPCQ_HD void sqp_step_scenario(const Team& tm, int N, int iters, const ModelConsts<T>& c,
                               const Weights<T>& wt, const T* X, const T* U,
                               const DragView<T>& drag, const T* dx0, const T* ex0,
                               const T* gu, const T* lbg, const T* ubg, const T* zl0,
                               const T* zu0, T* ws, T* z_out, T* dX_out, T* kkt_out,
                               T* zl_out, T* zu_out) {
  SqpWork<T> w(ws, N);
  T* Js = w.J;
  T* rs = Js + N * J_STAGE;
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
  sqp_body<R>(tm, N, iters, wt, (const T*)Js, w, (const T*)rs, dx0, ex0, gu, lbg, ubg, zl0,
              zu0, z_out, dX_out, kkt_out, zl_out, zu_out);
}

}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernels, in bytes.
// Kernel B: 17,808 at N = 10 (two scenarios of 8,904), 131,144 at N = 40
// (one); kernel F: 18,264 and 168,584.  The warm path reads and writes its
// duals in device memory and adds nothing here.
extern "C" int64_t mpcq_sqp_ws_bytes(int N) {
  return mpcq::sqp_block_warps(N) * mpcq::sqp_ws_size(N) * int64_t(sizeof(float));
}
// Kernel B's scenarios (warps) a block at horizon N.
extern "C" int mpcq_sqp_block_warps(int N) { return mpcq::sqp_block_warps(N); }
extern "C" int64_t mpcq_sqp_step_ws_bytes(int N) {
  return mpcq::sqp_step_ws_size(N) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

// Kernel B: scenario blockIdx.x * warps + warp, its workspace the warp's
// slice of the block's; a warp past B returns (no warp waits on another).
template <int R>
__global__ void __launch_bounds__(32 * mpcq::sqp_warps(R), mpcq::sqp_min_blocks(R))
mpcq_sqp_fused_kernel(const float* __restrict__ J, const float* __restrict__ r,
                      const float* __restrict__ dx0, const float* __restrict__ ex0,
                      const float* __restrict__ gu, const float* __restrict__ lb,
                      const float* __restrict__ ub, const float* __restrict__ zl0,
                      const float* __restrict__ zu0, float* __restrict__ z,
                      float* __restrict__ dX, float* __restrict__ kkt,
                      float* __restrict__ zl, float* __restrict__ zu, int64_t B, int N,
                      int iters, mpcq::Weights<float> wt) {
  extern __shared__ float ws[];
  constexpr int warps = mpcq::sqp_warps(R);
  const int warp = int(threadIdx.x) / 32;
  const int64_t b = int64_t(blockIdx.x) * warps + warp;
  if (b >= B) return;
  const int nz = N * mpcq::SU;
  mpcq::WarpTeam tm{int(threadIdx.x) % 32};
  mpcq::sqp_from_J_scenario<R, float>(
      tm, N, iters, wt, J + b * N * mpcq::J_STAGE, r + b * N * mpcq::SX,
      dx0 + b * mpcq::SX, ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz,
      ub + b * nz, zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr,
      ws + warp * mpcq::sqp_ws_size(N), z + b * nz, dX + b * (N + 1) * mpcq::SX, kkt + b,
      zl + b * nz, zu + b * nz);
}

template <int R>
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
  mpcq::sqp_step_scenario<R, float>(
      tm, N, iters, c, wt, X + b * (N + 1) * mpcq::SX, U + b * N * mpcq::SU,
      mpcq::drag_of(b, Xb, wb, L, sf, nb), dx0 + b * mpcq::SX,
      ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz, ub + b * nz,
      zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr, ws, z + b * nz,
      dX + b * (N + 1) * mpcq::SX, kkt + b, zl + b * nz, zu + b * nz);
}

extern "C" int mpcq_sqp_fused(const float* J, const float* r, const float* dx0,
                              const float* ex0, const float* gu, const float* lb,
                              const float* ub, const float* zl0, const float* zu0,
                              const float* weights, float* z, float* dX, float* kkt,
                              float* zl, float* zu, int64_t B, int N, int iters,
                              void* stream) {
  const size_t smem = size_t(mpcq_sqp_ws_bytes(N));
  const mpcq::Weights<float> wt = mpcq::weights_from<float>(weights);
  return mpcq::with_slots<mpcq::FUSED_SLOTS>(N * mpcq::SU, [&](auto slots) {
    constexpr int R = decltype(slots)::value;
    constexpr int warps = mpcq::sqp_warps(R);
    cudaError_t err = mpcq::allow_smem(mpcq_sqp_fused_kernel<R>, smem);
    if (err != cudaSuccess) return int(err);
    if (B > 0)
      mpcq_sqp_fused_kernel<R><<<dim3(unsigned((B + warps - 1) / warps)), 32 * warps, smem,
                                 (cudaStream_t)stream>>>(J, r, dx0, ex0, gu, lb, ub, zl0, zu0, z,
                                                         dX, kkt, zl, zu, B, N, iters, wt);
    return int(cudaGetLastError());
  });
}

extern "C" int mpcq_sqp_step(const float* X, const float* U, const float* Xb,
                             const float* wb, const float* L, const float* sf, int nb,
                             const float* dx0, const float* ex0, const float* gu,
                             const float* lb, const float* ub, const float* zl0,
                             const float* zu0, const float* consts, const float* weights,
                             float* z, float* dX, float* kkt, float* zl, float* zu,
                             int64_t B, int N, int iters, void* stream) {
  const size_t smem = size_t(mpcq_sqp_step_ws_bytes(N));
  const mpcq::ModelConsts<float> c = mpcq::consts_from<float>(consts);
  const mpcq::Weights<float> wt = mpcq::weights_from<float>(weights);
  return mpcq::with_slots<mpcq::FUSED_SLOTS>(N * mpcq::SU, [&](auto slots) {
    constexpr int R = decltype(slots)::value;
    cudaError_t err = mpcq::allow_smem(mpcq_sqp_step_kernel<R>, smem);
    if (err != cudaSuccess) return int(err);
    if (B > 0)
      mpcq_sqp_step_kernel<R><<<dim3(unsigned(B)), 32, smem, (cudaStream_t)stream>>>(
          X, U, Xb, wb, L, sf, nb, dx0, ex0, gu, lb, ub, zl0, zu0, z, dX, kkt, zl, zu, N,
          iters, c, wt);
    return int(cudaGetLastError());
  });
}

// Resident blocks per SM of kernel B (step = 0; mpcq_sqp_block_warps(N)
// warps each) or kernel F (step = 1; one warp each) at horizon N, from the
// occupancy API; -1 past FUSED_SLOTS.
extern "C" int mpcq_sqp_occupancy(int step, int N) {
  return mpcq::with_slots<mpcq::FUSED_SLOTS>(N * mpcq::SU, [&](auto slots) {
    constexpr int R = decltype(slots)::value;
    return step ? mpcq::resident_blocks(mpcq_sqp_step_kernel<R>, size_t(mpcq_sqp_step_ws_bytes(N)))
                : mpcq::resident_blocks(mpcq_sqp_fused_kernel<R>, size_t(mpcq_sqp_ws_bytes(N)),
                                        32 * mpcq::sqp_warps(R));
  });
}

#else
#include <limits>
#include <type_traits>
#include <vector>

namespace {

// Kernel B on the host: one serial lane (lanes = 1), a 32-thread team
// (lanes = 32), or (lanes = 0) the card's blocks: mpcq_sqp_block_warps(N)
// teams of 32 threads side by side, each on its slice of one block's
// workspace, which starts as NaN so that a read before a write shows.
int sqp_fused_host(int lanes, const double* J, const double* r, const double* dx0,
                   const double* ex0, const double* gu, const double* lb, const double* ub,
                   const double* zl0, const double* zu0, const double* weights, double* z,
                   double* dX, double* kkt, double* zl, double* zu, int64_t B, int N,
                   int iters) {
  const int nz = N * mpcq::SU;
  if (nz > 256) return -1;
  const mpcq::Weights<double> wt = mpcq::weights_from<double>(weights);
  const int64_t size = mpcq::sqp_ws_size(N);
  const int warps = lanes == 0 ? mpcq::sqp_block_warps(N) : 1;
  std::vector<double> ws(size_t(warps * size), std::numeric_limits<double>::quiet_NaN());
  auto scenario = [&](const auto& tm, int64_t b, int w) {
    constexpr int R = mpcq::host_slots<std::decay_t<decltype(tm)>>;
    mpcq::sqp_from_J_scenario<R, double>(
        tm, N, iters, wt, J + b * N * mpcq::J_STAGE, r + b * N * mpcq::SX,
        dx0 + b * mpcq::SX, ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz,
        ub + b * nz, zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr,
        ws.data() + w * size, z + b * nz, dX + b * (N + 1) * mpcq::SX, kkt + b, zl + b * nz,
        zu + b * nz);
  };
  if (lanes == 0) return mpcq::run_block_teams<32>(warps, B, scenario);
  return mpcq::run_host_team(lanes, B, [&](const auto& tm, int64_t b) { scenario(tm, b, 0); });
}

// Kernel F on the host, likewise.
int sqp_step_host(int lanes, const double* X, const double* U, const double* Xb,
                  const double* wb, const double* L, const double* sf, int nb,
                  const double* dx0, const double* ex0, const double* gu, const double* lb,
                  const double* ub, const double* zl0, const double* zu0,
                  const double* consts, const double* weights, double* z, double* dX,
                  double* kkt, double* zl, double* zu, int64_t B, int N, int iters) {
  const int nz = N * mpcq::SU;
  if (nz > 256) return -1;
  const mpcq::ModelConsts<double> c = mpcq::consts_from<double>(consts);
  const mpcq::Weights<double> wt = mpcq::weights_from<double>(weights);
  std::vector<double> ws(size_t(mpcq::sqp_step_ws_size(N)));
  return mpcq::run_host_team(lanes, B, [&](const auto& tm, int64_t b) {
    constexpr int R = mpcq::host_slots<std::decay_t<decltype(tm)>>;
    mpcq::sqp_step_scenario<R, double>(
        tm, N, iters, c, wt, X + b * (N + 1) * mpcq::SX, U + b * N * mpcq::SU,
        mpcq::drag_of(b, Xb, wb, L, sf, nb), dx0 + b * mpcq::SX,
        ex0 + b * (N + 1) * mpcq::SX, gu + b * nz, lb + b * nz, ub + b * nz,
        zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr, ws.data(), z + b * nz,
        dX + b * (N + 1) * mpcq::SX, kkt + b, zl + b * nz, zu + b * nz);
  });
}

}  // namespace

// Host builds of the same code (f64), for the CPU tests: one serial lane,
// (host32) 32 threads that run the card's lane split and syncs, and (kernel
// B's host_block) the card's block of such teams.
#define MPCQ_SQP_FUSED_ARGS                                                                \
  const double *J, const double *r, const double *dx0, const double *ex0, const double *gu, \
      const double *lb, const double *ub, const double *zl0, const double *zu0,             \
      const double *weights, double *z, double *dX, double *kkt, double *zl, double *zu,    \
      int64_t B, int N, int iters
#define MPCQ_SQP_FUSED_PASS \
  J, r, dx0, ex0, gu, lb, ub, zl0, zu0, weights, z, dX, kkt, zl, zu, B, N, iters
extern "C" int mpcq_sqp_fused_host_f64(MPCQ_SQP_FUSED_ARGS) {
  return sqp_fused_host(1, MPCQ_SQP_FUSED_PASS);
}
extern "C" int mpcq_sqp_fused_host32_f64(MPCQ_SQP_FUSED_ARGS) {
  return sqp_fused_host(32, MPCQ_SQP_FUSED_PASS);
}
extern "C" int mpcq_sqp_fused_host_block_f64(MPCQ_SQP_FUSED_ARGS) {
  return sqp_fused_host(0, MPCQ_SQP_FUSED_PASS);
}

#define MPCQ_SQP_STEP_ARGS                                                                 \
  const double *X, const double *U, const double *Xb, const double *wb, const double *L,   \
      const double *sf, int nb, const double *dx0, const double *ex0, const double *gu,    \
      const double *lb, const double *ub, const double *zl0, const double *zu0,            \
      const double *consts, const double *weights, double *z, double *dX, double *kkt,     \
      double *zl, double *zu, int64_t B, int N, int iters
#define MPCQ_SQP_STEP_PASS                                                                  \
  X, U, Xb, wb, L, sf, nb, dx0, ex0, gu, lb, ub, zl0, zu0, consts, weights, z, dX, kkt, zl, \
      zu, B, N, iters
extern "C" int mpcq_sqp_step_host_f64(MPCQ_SQP_STEP_ARGS) {
  return sqp_step_host(1, MPCQ_SQP_STEP_PASS);
}
extern "C" int mpcq_sqp_step_host32_f64(MPCQ_SQP_STEP_ARGS) {
  return sqp_step_host(32, MPCQ_SQP_STEP_PASS);
}

#endif
