// Kernels B and F: the Gauss-Newton step of one scenario per team —
// condensing, box-QP interior point, KKT residual and dX expansion; kernel F
// linearises the scenario first, in the same block.
//
// Kernel B replaces mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py::
// _fused_from_J_kernel (the "hybrid" pipeline's second kernel); kernel F
// replaces _fused_kernel of the same file (the "fused" pipeline: the whole
// step in one kernel).  Per scenario b, from the linearisation J (N, 17, 13)
// (row j of stage k = column j of [A_k | B_k]) and the defects r (N, 13):
//
// - the condensing of condense.cuh into the packed layout (H's upper
//   triangle and a diagonal column, + rw diagonal), then g += gu;
// - the IPM, `iters` iterations, cold-started or warm-started from the
//   previous duals zl0, zu0 (null for the cold start); it writes the new
//   duals zl, zu (unscaled) on both starts: kernel B runs ipm_box.cuh's,
//   kernel F box_qp.cuh's (the same bits on kernel E's schedule);
// - the projected-gradient KKT residual max |clip(z - (H z + g), lb, ub) - z|
//   against the unscaled H (the packed upper triangle, which the IPM leaves
//   as it was) and g;
// - dX_0 = dx0, dX_{k+1} = r_k + A_k dX_k + B_k z_k.
//
// Kernel B's inputs (contiguous f32): J (B, N, 17, 13), r (B, N, 13),
// dx0 (B, 13), ex0 = X - [y_ref; y_ref_N] (B, N+1, 13), gu, lb, ub (B, nz),
// optional zl0, zu0 (B, nz).  Kernel F takes X (B, N+1, 13), U (B, N, 4) and
// the folded drag Xb, wb (B, 3, nb), L, sigma_f (B, 3) in place of J and r.
// Outputs of both: z (B, nz), dX (B, N+1, 13), kkt (B), zl, zu (B, nz).
// nz = 4 N.
//
// What bounds them on the H100: the IPM's per-scenario latency (nz dependent
// Cholesky columns and 2 nz dependent substitution steps, times `iters`),
// which only many resident scenarios hide; shared memory and registers per
// SM set how many reside, and from 16 warps an SM the SM's instruction issue
// and shared-memory accesses bind as well.
//
// Kernel B keeps one scenario a warp.  Its shared memory holds, a scenario,
// one packed nz x (nz + 1) matrix (H, then H and the factor), g, one 13 x nz
// condensing map M (dead once the IPM starts: the IPM's s and z, its
// triangle table and the solution lie over it) and two d vectors: 8,904 B
// at N = 10, 131,144 B at N = 40.  J stays in device memory and is read
// where it lies, once for the condensing and once for the dX recurrence: in
// the map's recurrence every lane reads the same entry (one broadcast load
// through L1), in d's and dX's the 13 lanes of a row read one stage row.  Up
// to R = 2 (N <= 16) a block holds SQP_BLOCK_WARPS scenarios, one a warp,
// which share the 1 KB the card reserves a block, and ptxas is asked for
// SQP_MIN_BLOCKS such blocks an SM: at N = 10 12 blocks of two fit the
// 233,472 B of an SM, 24 warps, at no more than 80 registers a thread.
// Past R = 2 a block is one warp, and shared memory admits 1-9 of them an SM
// (9 at N = 17, 6 at N = 20, 1 at N = 40); at R = 3 ptxas is asked for 9, so
// that registers do not cut that below shared memory's count.
//
// Kernel F runs a scenario on a team of kernel E's schedule: half a warp
// (HalfWarpTeam) with STEP_PAIR_TEAMS scenarios a block on one strip table
// (nz <= STEP_PAIR_NZ, B >= STEP_PAIR_MIN_B), else a warp a scenario and a
// block.  A team's region of shared memory holds box_qp.cuh's slot (rows x
// ld: 40 x 44 at N = 10), g, one map M and two d vectors (9,392 B at N = 10);
// the block adds the table: 75,584 B for eight, three blocks an SM (24
// scenarios, ptxas fitted to 168 registers).  J and the defects never enter
// shared memory: they are dead through the IPM, most of the time, and
// staged they would halve the scenarios an SM.  Each team writes them to its
// own slice of a device scratch, which the condensing and the dX recurrence
// read back through L1, as kernel B reads kernel A's J.  The grid is the
// blocks that reside at once (SMs x resident blocks), each block walking the
// scenarios' groups in turn, so the scratch is one slice a resident team
// (~29 MB on an H100 at N = 10, under its 50 MB L2) and the strip table is
// built once a block.  A team's step:
//
// 1. the linearisation as kernel A splits it (model.cuh's record): the
//    primal RK4 step once a stage (lanes on stages), recording what the
//    tangents read (R_FIELDS values, a stage's together) and writing r_k =
//    x+_k - X_{k+1}; then the N x 17 (stage, tangent) items, a round of one
//    a lane, each J row into the team's stage buffer and out to the scratch
//    as 16-byte stores.  The record and buffer lie over the team's slot,
//    which is dead until the condensing;
// 2. the condensing into the slot's upper triangle and column nz;
// 3. box_qp.cuh's IPM on the slot, the solution into M's region;
// 4. the KKT residual and the dX recurrence, J and r read back.
//
// model.cuh's explicit rounding, the condensing's chains and box_qp.cuh's
// arithmetic make every element's bits those of kernel A's linearisation,
// then kernel B's step: the three pipelines' U agree bitwise, and both of
// F's schedules give the same bits.  Both kernels are built for nz <= 160
// (N <= 40, ops/sqp.py FUSED_N_MAX, the JAX package's ceiling): one
// instantiation per R register slots a lane.  Nothing is reduced across
// teams, so a NaN in one scenario leaves every other scenario, its block's
// other teams included, bitwise unchanged.

#include "box_qp.cuh"
#include "condense.cuh"
#include "model.cuh"

namespace mpcq {

// Register slots a lane of kernels B and F holds (a warp team): nz <= 32
// FUSED_SLOTS.
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

// Kernel B's shared workspace of one scenario (elements of T): the packed
// matrix A (nz x ld), g (nz), the maps region Mb, db (2 x 13).
template <typename T> struct SqpWork {
  T *A, *g, *Mb, *db;
  MPCQ_HD SqpWork(T* ws, int N) {
    const int nz = N * SU;
    A = ws;
    g = A + packed_size(nz);
    Mb = g + nz;
    db = Mb + sqp_maps_size(nz);
  }
};

// Kernel B's workspace of one scenario.
MPCQ_HD int64_t sqp_ws_size(int N) {
  const int nz = N * SU;
  return packed_size(nz) + nz + sqp_maps_size(nz) + 2 * SX;
}

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

// ---- kernel F ----

// Kernel F's schedule of half-warp teams: the largest nz, the scenarios a
// block, the resident blocks an SM that ptxas fits its registers to, and
// the least batch that takes it (a warp a scenario keeps one scenario's
// chain short when the batch does not fill the card: on an H100 at N = 10
// it is faster at 4096 scenarios and slower at 8192).
constexpr int STEP_PAIR_NZ = 40;
constexpr int STEP_PAIR_TEAMS = 8;
constexpr int STEP_PAIR_BLOCKS = 3;
constexpr int64_t STEP_PAIR_MIN_B = 6144;

MPCQ_HD int64_t round4(int64_t n) { return (n + 3) & ~int64_t(3); }

// Elements of T of a team's region: box_qp.cuh's slot (rows x ld), g (nz),
// the map M (13 x nz) and db (2 x 13), or, before the condensing, the
// linearisation's records (N x R_FIELDS) and its stage buffer (NL rows of
// 13), whichever is larger; a multiple of four, so that every team's slot
// and stage buffer stay 16-byte aligned.
MPCQ_HD int64_t step_team_size(int N, int NL) {
  const int nz = N * SU;
  const int64_t ipm = box_qp_slot_size(nz) + (SX + 1) * int64_t(nz) + 2 * SX;
  const int64_t lin = round4(int64_t(N) * R_FIELDS) + int64_t(NL) * SX;
  return round4(ipm > lin ? ipm : lin);
}
// Elements of T of a block of `teams` teams: the strip table, then theirs.
template <typename T> MPCQ_HD int64_t step_block_size(int N, int NL, int teams) {
  return box_qp_table_size<T>(N * SU) + teams * step_team_size(N, NL);
}
// Elements of a team's slice of the device scratch: J (N x 17 x 13), then
// r (N x 13), a multiple of four.
MPCQ_HD int64_t step_scratch_size(int N) { return round4(int64_t(N) * (J_STAGE + SX)); }

// A team's region, in the order step_team_size counts it; the records and
// the stage buffer over the slot.
template <typename T> struct StepWork {
  T *A, *g, *M, *db, *rec, *stage;
  MPCQ_HD StepWork(T* ws, int N) {
    const int nz = N * SU;
    A = ws;
    g = A + box_qp_slot_size(nz);
    M = g + nz;
    db = M + SX * nz;
    rec = ws;
    stage = ws + round4(int64_t(N) * R_FIELDS);
  }
};

// A scenario's outputs.
template <typename T> struct StepOut { T *z, *dX, *kkt, *zl, *zu; };

// The linearisation of (X, U) as kernel A splits it: each stage's primal
// once (a lane a stage), recorded at rec + k R_FIELDS, r_k = x+_k - X_{k+1}
// into rg; then the N x 17 (stage, tangent) items in rounds of one a lane,
// each J row into the stage buffer, a round's rows out to Jg (16-byte
// aligned) as 16-byte stores.
template <typename T, typename Team>
MPCQ_HD void sqp_step_lin(const Team& tm, int N, const ModelConsts<T>& c, const T* X, const T* U,
                          const DragView<T>& drag, const StepWork<T>& w, T* Jg, T* rg) {
  const int ln = tm.lane, NL = Team::size, items = N * ST;
  for (int k = ln; k < N; k += NL) {
    Val<T> x[SX];
    step_item(X + k * SX, U + k * SU, RecordPrimal<T, 1>{drag, w.rec + k * R_FIELDS}, c, x);
    for (int j = 0; j < SX; ++j) rg[k * SX + j] = x[j].v - X[(k + 1) * SX + j];
  }
  tm.sync();
  for (int i0 = 0; i0 < items; i0 += NL) {
    const int it = i0 + ln;
    if (it < items) {
      Dual<T> x[SX];
      tangent_item(Recorded<T, 1>{w.rec + it / ST * R_FIELDS, drag.nb}, it % ST, c, x);
      for (int j = 0; j < SX; ++j) w.stage[ln * SX + j] = x[j].d;
    }
    tm.sync();
    store_span(ln, NL, Jg + int64_t(i0) * SX, w.stage, (items - i0 < NL ? items - i0 : NL) * SX);
    tm.sync();
  }
}

// The KKT residual against the unscaled H (the slot's upper triangle, its
// diagonal in column nz) and g, then the dX recurrence from J and rg, as
// kernel B forms them; zf the solution.  Ends with a team sync.
template <typename T, typename Team>
MPCQ_HD void sqp_step_tail(const Team& tm, int N, const T* A, int ld, const T* J, const T* rg,
                           const T* g, const T* zf, T* db, const T* dx0, const T* lbg,
                           const T* ubg, const StepOut<T>& o) {
  const int nz = N * SU, ln = tm.lane, NL = Team::size;
  auto h = [&](int i, int j) {
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    return A[lo * ld + (i == j ? nz : hi)];
  };
  T part = T(0);
  for (int i = ln; i < nz; i += NL) {
    T Hz = mul_rn(h(i, 0), zf[0]);
    for (int j = 1; j < nz; ++j) Hz = fmadd(h(i, j), zf[j], Hz);
    T pr = clip(zf[i] - (Hz + g[i]), lbg[i], ubg[i]) - zf[i];
    part = nan_max(part, pr < T(0) ? -pr : pr);
    o.z[i] = zf[i];
  }
  T kkt = tm.max(part);
  if (ln == 0) o.kkt[0] = kkt;

  int cur = 0;
  for (int row = ln; row < SX; row += NL) {
    db[row] = dx0[row];
    o.dX[row] = dx0[row];
  }
  tm.sync();
  const T* Jk = J;
  for (int k = 0; k < N; ++k, Jk += J_STAGE) {
    const T* xk = db + cur * SX;
    T* xn = db + (1 - cur) * SX;
    for (int row = ln; row < SX; row += NL) {
      T acc = rg[k * SX + row];
      for (int j = 0; j < SX; ++j) acc = acc + Jk[j * SX + row] * xk[j];
      for (int a = 0; a < SU; ++a) acc = acc + Jk[(SX + a) * SX + row] * zf[k * SU + a];
      xn[row] = acc;
      o.dX[(k + 1) * SX + row] = acc;
    }
    tm.sync();
    cur = 1 - cur;
  }
}

// Kernel F's scenario on a team: its region ws of the block (StepWork), the
// strip table tbl, its slice of the scratch (Jg, rg).
template <int R, typename T, typename Team>
MPCQ_HD void sqp_step_scenario(const Team& tm, int N, int iters, const ModelConsts<T>& c,
                               const Weights<T>& wt, const uint16_t* tbl, const T* X, const T* U,
                               const DragView<T>& drag, const T* dx0, const T* ex0, const T* gu,
                               const T* lbg, const T* ubg, const T* zl0, const T* zu0, T* ws,
                               T* Jg, T* rg, const StepOut<T>& o) {
  const int nz = N * SU, ld = box_qp_ld(nz);
  const StepWork<T> w(ws, N);
  sqp_step_lin(tm, N, c, X, U, drag, w, Jg, rg);
  condense_packed(tm, N, ld, wt, (const T*)Jg, w.M, w.db, w.A, w.g, (const T*)rg,
                  dx0, ex0);
  for (int i = tm.lane; i < nz; i += Team::size) w.g[i] = w.g[i] + gu[i];
  tm.sync();
  // the solution over the dead map
  T* zf = w.M;
  box_qp_solve<R>(tm, nz, iters, tbl, (const T*)w.g, lbg, ubg, zl0, zu0, w.A,
                  [&](int i, T zi, T zli, T zui) {
                    zf[i] = zi;
                    o.zl[i] = zli;
                    o.zu[i] = zui;
                  });
  tm.sync();
  sqp_step_tail(tm, N, (const T*)w.A, ld, (const T*)Jg, (const T*)rg, (const T*)w.g,
                (const T*)zf, w.db, dx0, lbg, ubg, o);
}

}  // namespace mpcq

// Dynamic shared memory of one block of kernel B (f32), in bytes: 17,808 at
// N = 10 (two scenarios of 8,904), 131,144 at N = 40 (one).  The warm path
// reads and writes its duals in device memory and adds nothing here.
extern "C" int64_t mpcq_sqp_ws_bytes(int N) {
  return mpcq::sqp_block_warps(N) * mpcq::sqp_ws_size(N) * int64_t(sizeof(float));
}
// Kernel B's scenarios (warps) a block at horizon N.
extern "C" int mpcq_sqp_block_warps(int N) { return mpcq::sqp_block_warps(N); }

// Lanes a scenario of kernel F (16: half-warp teams, STEP_PAIR_TEAMS a
// block; 32: a warp a scenario and a block) that mpcq_sqp_step takes at B
// scenarios of horizon N.
extern "C" int mpcq_sqp_step_lanes(int64_t B, int N) {
  return N * mpcq::SU <= mpcq::STEP_PAIR_NZ && B >= mpcq::STEP_PAIR_MIN_B ? 16 : 32;
}
// Scenarios a block of kernel F's schedule of `lanes` lanes a scenario at
// horizon N; 0 where it does not take N.
extern "C" int mpcq_sqp_step_block_scenarios(int lanes, int N) {
  const int nz = N * mpcq::SU;
  if (lanes == 16) return nz <= mpcq::STEP_PAIR_NZ ? mpcq::STEP_PAIR_TEAMS : 0;
  return lanes == 32 && nz <= 32 * mpcq::FUSED_SLOTS ? 1 : 0;
}
// Dynamic shared memory of one block of that schedule (f32), in bytes:
// 75,584 at N = 10 with 16 lanes (eight teams of 9,392 and the table),
// 120,592 at N = 40 with 32.
extern "C" int64_t mpcq_sqp_step_block_bytes(int lanes, int N) {
  const int teams = mpcq_sqp_step_block_scenarios(lanes, N);
  return mpcq::step_block_size<float>(N, lanes, teams ? teams : 1) * int64_t(sizeof(float));
}
// Kernel F's block at the schedule large batches take.
extern "C" int64_t mpcq_sqp_step_ws_bytes(int N) {
  return mpcq_sqp_step_block_bytes(mpcq_sqp_step_lanes(INT64_MAX, N), N);
}
// Device scratch of one block of that schedule, in bytes: a slice a team
// (J and r) and one more, where a team past the batch writes its outputs.
extern "C" int64_t mpcq_sqp_step_scratch_bytes(int lanes, int N) {
  const int teams = mpcq_sqp_step_block_scenarios(lanes, N);
  return (teams + 1) * mpcq::step_scratch_size(N) * int64_t(sizeof(float));
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

// Kernel F: TEAMS teams of NL lanes a block, each on its region of the
// block's shared memory and its slice of the scratch (block blockIdx.x's
// TEAMS + 1 slices), after the block has built the strip table.  The grid
// walks the groups of TEAMS consecutive scenarios, group blockIdx.x +
// gridDim.x i in turn; in the last group a team past B runs scenario B - 1
// beside its warp's other half and writes its outputs into the block's spare
// slice, which nothing reads (both halves reach every warp sync); a warp
// wholly past B stops.
template <int R, int NL, int TEAMS, int MIN_BLOCKS>
__global__ void __launch_bounds__(NL * TEAMS, MIN_BLOCKS)
mpcq_sqp_step_kernel(const float* __restrict__ X, const float* __restrict__ U,
                     const float* __restrict__ Xb, const float* __restrict__ wb,
                     const float* __restrict__ L, const float* __restrict__ sf, int nb,
                     const float* __restrict__ dx0, const float* __restrict__ ex0,
                     const float* __restrict__ gu, const float* __restrict__ lb,
                     const float* __restrict__ ub, const float* __restrict__ zl0,
                     const float* __restrict__ zu0, float* __restrict__ z,
                     float* __restrict__ dX, float* __restrict__ kkt,
                     float* __restrict__ zl, float* __restrict__ zu, float* scratch, int64_t B,
                     int N, int iters, mpcq::ModelConsts<float> c, mpcq::Weights<float> wt) {
  using namespace mpcq;
  extern __shared__ __align__(16) float ws[];
  const int nz = N * SU;
  uint16_t* tbl = reinterpret_cast<uint16_t*>(ws);
  box_qp_table(int(threadIdx.x), NL * TEAMS, nz, tbl);
  __syncthreads();
  const int team = int(threadIdx.x) / NL;
  using Team = std::conditional_t<NL == 16, HalfWarpTeam, WarpTeam>;
  Team tm{int(threadIdx.x) % NL};
  float* region = ws + box_qp_table_size<float>(nz) + team * step_team_size(N, NL);
  const int64_t slice = step_scratch_size(N);
  float* Jg = scratch + (int64_t(blockIdx.x) * (TEAMS + 1) + team) * slice;
  float* spare = scratch + (int64_t(blockIdx.x) * (TEAMS + 1) + TEAMS) * slice;
  const int64_t groups = (B + TEAMS - 1) / TEAMS;
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t first = grp * TEAMS;
    if (first + team / (32 / NL) * (32 / NL) >= B) break;
    const bool live = first + team < B;
    const int64_t b = live ? first + team : B - 1;
    const StepOut<float> o =
        live ? StepOut<float>{z + b * nz, dX + b * (N + 1) * SX, kkt + b, zl + b * nz, zu + b * nz}
             : StepOut<float>{spare, spare + 3 * nz, spare + 3 * nz + (N + 1) * SX,
                              spare + nz, spare + 2 * nz};
    sqp_step_scenario<R, float>(
        tm, N, iters, c, wt, tbl, X + b * (N + 1) * SX, U + b * N * SU,
        drag_of(b, Xb, wb, L, sf, nb), dx0 + b * SX, ex0 + b * (N + 1) * SX, gu + b * nz,
        lb + b * nz, ub + b * nz, zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr,
        region, Jg, Jg + N * J_STAGE, o);
  }
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

namespace {

// f(kernel, teams) for kernel F's schedule of `lanes` lanes a scenario at
// horizon N: half-warp teams (R = 3 slots of 16 lanes, STEP_PAIR_BLOCKS
// blocks an SM) or a warp a block (R = ceil(nz / 32); up to R = 2 ptxas is
// asked for 16 blocks, 128 registers, as for kernel E's).
template <typename F> int with_step_kernel(int lanes, int N, F&& f) {
  if (mpcq_sqp_step_block_scenarios(lanes, N) == 0) return -1;
  if (lanes == 16)
    return f(mpcq_sqp_step_kernel<(mpcq::STEP_PAIR_NZ + 15) / 16, 16, mpcq::STEP_PAIR_TEAMS,
                                  mpcq::STEP_PAIR_BLOCKS>,
             mpcq::STEP_PAIR_TEAMS);
  return mpcq::with_slots<mpcq::FUSED_SLOTS>(N * mpcq::SU, [&](auto slots) {
    constexpr int R = decltype(slots)::value;
    return f(mpcq_sqp_step_kernel<R, 32, 1, (R <= 2 ? 16 : 1)>, 1);
  });
}

// One SmemOnce a kernel F instantiation (lanes 16, then 32 at R = 1..5), and
// its blocks resident on the whole card, by device (0-63), read at first use.
constexpr int STEP_KERNELS = 1 + mpcq::FUSED_SLOTS;
mpcq::SmemOnce step_smem[STEP_KERNELS];
int step_card_blocks[STEP_KERNELS][64];
int step_slot(int lanes, int N) { return lanes == 16 ? 0 : (N * mpcq::SU + 31) / 32; }

}  // namespace

// Resident blocks per SM of kernel F's schedule of `lanes` lanes a scenario
// at horizon N, from the occupancy API; -1 where it does not take N.
extern "C" int mpcq_sqp_step_resident(int lanes, int N) {
  return with_step_kernel(lanes, N, [&](auto kernel, int teams) {
    return mpcq::resident_blocks(kernel, size_t(mpcq_sqp_step_block_bytes(lanes, N)),
                                 teams * lanes);
  });
}

// Kernel F's grid at B scenarios with `lanes` lanes a scenario (0: the
// schedule mpcq_sqp_step_lanes picks): the blocks the whole card holds at
// once, or fewer where B needs fewer; the wrapper's scratch holds one block's
// mpcq_sqp_step_scratch_bytes for each.  0 at B = 0, -1 on an error.
extern "C" int64_t mpcq_sqp_step_grid(int64_t B, int N, int lanes) {
  if (lanes == 0) lanes = mpcq_sqp_step_lanes(B, N);
  const int teams = mpcq_sqp_step_block_scenarios(lanes, N);
  if (teams == 0) return -1;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int* card = dev >= 0 && dev < 64 ? &step_card_blocks[step_slot(lanes, N)][dev] : nullptr;
  int blocks = card ? *card : 0;
  if (blocks <= 0) {
    int sms = 0;
    const int per_sm = mpcq_sqp_step_resident(lanes, N);
    if (per_sm <= 0 ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return -1;
    blocks = sms * per_sm;
    if (card) *card = blocks;
  }
  const int64_t groups = (B + teams - 1) / teams;
  return groups < blocks ? groups : blocks;
}

// Kernel F at B scenarios with `lanes` lanes a scenario (16 or 32; 0: the
// schedule mpcq_sqp_step_lanes picks) on a grid of `blocks` blocks (at most
// the blocks the scratch holds, mpcq_sqp_step_scratch_bytes each).
extern "C" int mpcq_sqp_step_sched(const float* X, const float* U, const float* Xb,
                                   const float* wb, const float* L, const float* sf, int nb,
                                   const float* dx0, const float* ex0, const float* gu,
                                   const float* lb, const float* ub, const float* zl0,
                                   const float* zu0, const float* consts, const float* weights,
                                   float* z, float* dX, float* kkt, float* zl, float* zu,
                                   float* scratch, int64_t blocks, int64_t B, int N, int iters,
                                   int lanes, void* stream) {
  if (lanes == 0) lanes = mpcq_sqp_step_lanes(B, N);
  const size_t smem = size_t(mpcq_sqp_step_block_bytes(lanes, N));
  const mpcq::ModelConsts<float> c = mpcq::consts_from<float>(consts);
  const mpcq::Weights<float> wt = mpcq::weights_from<float>(weights);
  return with_step_kernel(lanes, N, [&](auto kernel, int teams) {
    cudaError_t err = step_smem[step_slot(lanes, N)](kernel);
    if (err != cudaSuccess) return int(err);
    const int64_t groups = (B + teams - 1) / teams, grid = groups < blocks ? groups : blocks;
    if (grid > 0)
      kernel<<<dim3(unsigned(grid)), teams * lanes, smem, (cudaStream_t)stream>>>(
          X, U, Xb, wb, L, sf, nb, dx0, ex0, gu, lb, ub, zl0, zu0, z, dX, kkt, zl, zu, scratch,
          B, N, iters, c, wt);
    else if (B > 0)
      return int(cudaErrorInvalidValue);   // no scratch for a block
    return int(cudaGetLastError());
  });
}

// Kernel F at the schedule mpcq_sqp_step_lanes picks.
extern "C" int mpcq_sqp_step(const float* X, const float* U, const float* Xb, const float* wb,
                             const float* L, const float* sf, int nb, const float* dx0,
                             const float* ex0, const float* gu, const float* lb,
                             const float* ub, const float* zl0, const float* zu0,
                             const float* consts, const float* weights, float* z, float* dX,
                             float* kkt, float* zl, float* zu, float* scratch, int64_t blocks,
                             int64_t B, int N, int iters, void* stream) {
  return mpcq_sqp_step_sched(X, U, Xb, wb, L, sf, nb, dx0, ex0, gu, lb, ub, zl0, zu0, consts,
                             weights, z, dX, kkt, zl, zu, scratch, blocks, B, N, iters, 0,
                             stream);
}

// Resident blocks per SM of kernel B (step = 0; mpcq_sqp_block_warps(N)
// warps each) or of kernel F's schedule for large batches (step = 1) at
// horizon N, from the occupancy API; -1 past FUSED_SLOTS.
extern "C" int mpcq_sqp_occupancy(int step, int N) {
  if (step) return mpcq_sqp_step_resident(mpcq_sqp_step_lanes(INT64_MAX, N), N);
  return mpcq::with_slots<mpcq::FUSED_SLOTS>(N * mpcq::SU, [&](auto slots) {
    constexpr int R = decltype(slots)::value;
    return mpcq::resident_blocks(mpcq_sqp_fused_kernel<R>, size_t(mpcq_sqp_ws_bytes(N)),
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

// Kernel F on the host: one serial lane (lanes = 1) or a 32-thread team
// (lanes = 32), each with its own table, region and scratch slice, or
// (lanes = 16) the card's block of half-warp teams: STEP_PAIR_TEAMS teams of
// 16 threads side by side, each on its region of one block workspace whose
// table is built once and on its slice of the scratch.  Workspace and
// scratch start as NaN, so that a read before a write shows.
int sqp_step_host(int lanes, const double* X, const double* U, const double* Xb,
                  const double* wb, const double* L, const double* sf, int nb,
                  const double* dx0, const double* ex0, const double* gu, const double* lb,
                  const double* ub, const double* zl0, const double* zu0,
                  const double* consts, const double* weights, double* z, double* dX,
                  double* kkt, double* zl, double* zu, int64_t B, int N, int iters) {
  const int nz = N * mpcq::SU;
  if (nz > 256 || (lanes == 16 && nz > mpcq::STEP_PAIR_NZ)) return -1;
  const mpcq::ModelConsts<double> c = mpcq::consts_from<double>(consts);
  const mpcq::Weights<double> wt = mpcq::weights_from<double>(weights);
  const int teams = lanes == 16 ? mpcq::STEP_PAIR_TEAMS : 1;
  const int64_t table = mpcq::box_qp_table_size<double>(nz),
                region = mpcq::step_team_size(N, lanes), slice = mpcq::step_scratch_size(N);
  const double nan = std::numeric_limits<double>::quiet_NaN();
  std::vector<double> ws(size_t(mpcq::step_block_size<double>(N, lanes, teams)), nan);
  std::vector<double> scratch(size_t(teams * slice), nan);
  uint16_t* tbl = reinterpret_cast<uint16_t*>(ws.data());
  mpcq::box_qp_table(0, 1, nz, tbl);
  auto scenario = [&](const auto& tm, int64_t b, int w) {
    constexpr int R = mpcq::host_slots<std::decay_t<decltype(tm)>>;
    double* Jg = scratch.data() + w * slice;
    const mpcq::StepOut<double> o{z + b * nz, dX + b * (N + 1) * mpcq::SX, kkt + b, zl + b * nz,
                                  zu + b * nz};
    mpcq::sqp_step_scenario<R, double>(
        tm, N, iters, c, wt, tbl, X + b * (N + 1) * mpcq::SX, U + b * N * mpcq::SU,
        mpcq::drag_of(b, Xb, wb, L, sf, nb), dx0 + b * mpcq::SX, ex0 + b * (N + 1) * mpcq::SX,
        gu + b * nz, lb + b * nz, ub + b * nz, zl0 ? zl0 + b * nz : nullptr,
        zu0 ? zu0 + b * nz : nullptr, ws.data() + table + w * region, Jg,
        Jg + N * mpcq::J_STAGE, o);
  };
  if (lanes == 16) return mpcq::run_block_teams<16>(teams, B, scenario);
  return mpcq::run_host_team(lanes, B, [&](const auto& tm, int64_t b) { scenario(tm, b, 0); });
}

}  // namespace

// Host builds of the same code (f64), for the CPU tests: one serial lane,
// (host32) 32 threads that run the card's lane split and syncs, and
// (host_block) the card's block of such teams: kernel B's warps, kernel F's
// half-warp teams.
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
extern "C" int mpcq_sqp_step_host_block_f64(MPCQ_SQP_STEP_ARGS) {
  return sqp_step_host(16, MPCQ_SQP_STEP_PASS);
}

#endif
