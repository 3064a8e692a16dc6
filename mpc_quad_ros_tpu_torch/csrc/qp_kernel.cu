// Kernel E: the standalone box-QP interior point — the "split" pipeline's
// third kernel and the small-batch step's.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/qp_kernel.py::_qp_kernel (entries
// solve_box_qp_pdip_pallas_tiled and solve_box_qp_pdip_pallas with
// symmetrize=False).  Per scenario b: min 1/2 z'Hz + g'z s.t. lb <= z <= ub
// by the algorithm of ipm_box.cuh (the IPM kernels B and F run), `iters`
// iterations, cold-started or warm-started from zl0, zu0 (null for the cold
// start).  H (B, nz, nz) must be symmetric, as the split pipeline's is by
// construction (mirrored, never averaged with its transpose: that would flip
// last bits that 12 iterations amplify, qp_kernel.py:287-295); the kernel
// reads its upper triangle and diagonal.  Inputs g, lb, ub and the optional
// zl0, zu0 are (B, nz); outputs z, zl, zu (B, nz), the duals unscaled.
//
// The IPM is box_qp.cuh's box_qp_solve (kernel F runs it too): the bits
// of ipm_box_solve on a schedule of its own, which that header describes.
// What bounds it on the H100: far above the FLOP bound (0.33 ms at B =
// 65536, nz = 40, 12 iterations) and the byte bound (H 0.42 GB in), the
// SM's shared-memory wavefronts and instruction issue, once enough
// scenarios reside to hide each scenario's chain of dependent steps.  E's
// blocks:
//
// - Paired blocks (nz <= BOX_QP_PAIR_NZ, B >= BOX_QP_PAIR_MIN_B): a
//   scenario is half a warp (HalfWarpTeam), so one warp instruction advances
//   two scenarios' substitution steps and serial code; a block holds
//   BOX_QP_PAIR_TEAMS scenarios on one table of the triangle's strips,
//   built once a block: 56,768 B at nz = 40, four blocks an SM (32
//   scenarios, 16 warps at no more than 128 registers: 96, no spill, with
//   the outputs' addresses read afresh).  Below BOX_QP_PAIR_MIN_B
//   scenarios, or past BOX_QP_PAIR_NZ, a scenario is a warp and a block one
//   scenario (7,488 B at nz = 40), which keeps one scenario's chain short
//   when the card is not full.  Both schedules give the same bits.
// - H's upper triangle and diagonal are staged into the slot by cp.async.
//
// Up to nz = 229 in an H100 block's 232,448 B (the wrapper refuses more);
// one instantiation per R = ceil(nz / lanes) register slots a lane.

#include "box_qp.cuh"

namespace mpcq {

// Register slots a lane of a warp team holds: nz <= 32 BOX_QP_SLOTS.
constexpr int BOX_QP_SLOTS = 8;
// The paired schedule: the largest nz, the scenarios (half warps) a block,
// and the least batch that takes it (where one warp a scenario fills an
// H100's 132 SMs at 20-24 each: at nz = 40 a warp a scenario is faster at
// 2048 scenarios and slower at 4096).
constexpr int BOX_QP_PAIR_NZ = 40;
constexpr int BOX_QP_PAIR_TEAMS = 8;
// The paired blocks an SM that ptxas fits their registers to.
constexpr int BOX_QP_PAIR_BLOCKS = 4;
constexpr int64_t BOX_QP_PAIR_MIN_B = 3072;

// One scenario: H's upper triangle and diagonal staged from device memory
// into the slot, then the IPM; out(i, z_i, zl_i, zu_i) takes the solution
// (the card's finds its scenario's outputs afresh: an address held through
// the loop would cost the paired blocks a spilled register).
template <int R, typename T, typename Team, typename Out>
MPCQ_HD void box_qp_scenario(const Team& tm, int nz, int iters, const uint16_t* tbl,
                             const T* Hg, const T* g0, const T* lb0, const T* ub0,
                             const T* zl0, const T* zu0, T* A, const Out& out) {
  const int ln = tm.lane, NL = Team::size, ld = box_qp_ld(nz);
  for (int i = 0; i < nz; ++i)
    for (int j = i + ln; j < nz; j += NL) tm.copy_elem(A + i * ld + (j == i ? nz : j), Hg + i * nz + j);
  tm.commit_async();
  tm.template wait_async<0>();
  box_qp_solve<R>(tm, nz, iters, tbl, g0, lb0, ub0, zl0, zu0, A, out);
}

}  // namespace mpcq

// Lanes a scenario (16: the paired blocks; 32: one warp a block) that
// mpcq_box_qp takes at B scenarios of nz.
extern "C" int mpcq_box_qp_lanes(int64_t B, int nz) {
  return nz <= mpcq::BOX_QP_PAIR_NZ && B >= mpcq::BOX_QP_PAIR_MIN_B ? 16 : 32;
}
// Scenarios a block of the schedule of `lanes` lanes a scenario; 0 where it
// does not take nz.
extern "C" int mpcq_box_qp_block_scenarios(int lanes, int nz) {
  if (lanes == 16) return nz <= mpcq::BOX_QP_PAIR_NZ ? mpcq::BOX_QP_PAIR_TEAMS : 0;
  return lanes == 32 && nz <= 32 * mpcq::BOX_QP_SLOTS ? 1 : 0;
}
// Dynamic shared memory of one block of that schedule (f32), in bytes; past
// the nz it takes, what one scenario's block would need.
extern "C" int64_t mpcq_box_qp_block_bytes(int lanes, int nz) {
  const int scenarios = mpcq_box_qp_block_scenarios(lanes, nz);
  return mpcq::box_qp_block_size<float>(nz, scenarios ? scenarios : 1) * int64_t(sizeof(float));
}
// Dynamic shared memory of one block of the schedule large batches take.
extern "C" int64_t mpcq_box_qp_ws_bytes(int nz) {
  return mpcq_box_qp_block_bytes(mpcq_box_qp_lanes(INT64_MAX, nz), nz);
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

// Scenario blockIdx.x * teams + team, each team on its slot of the block's
// workspace, after the block has built the table.  In the paired blocks a
// half warp past B repeats scenario B - 1 beside its warp's other half and
// writes nothing (both halves reach every warp sync); a warp wholly past B
// returns.
template <int R, int NL, int TEAMS, int MIN_BLOCKS>
__global__ void __launch_bounds__(NL * TEAMS, MIN_BLOCKS)
mpcq_box_qp_kernel(const float* __restrict__ H, const float* __restrict__ g,
                   const float* __restrict__ lb, const float* __restrict__ ub,
                   const float* __restrict__ zl0, const float* __restrict__ zu0,
                   float* __restrict__ z, float* __restrict__ zl, float* __restrict__ zu,
                   int64_t B, int nz, int iters) {
  extern __shared__ __align__(16) float ws[];
  uint16_t* tbl = reinterpret_cast<uint16_t*>(ws);
  mpcq::box_qp_table(int(threadIdx.x), NL * TEAMS, nz, tbl);
  __syncthreads();
  const int team = int(threadIdx.x) / NL;
  const int64_t first = int64_t(blockIdx.x) * TEAMS;
  if (first + team / (32 / NL) * (32 / NL) >= B) return;
  const int64_t b = first + team < B ? first + team : B - 1;
  using Team = std::conditional_t<NL == 16, mpcq::HalfWarpTeam, mpcq::WarpTeam>;
  Team tm{int(threadIdx.x) % NL};
  // the scenario from the block and thread indices read again
  auto out = [&](int i, float zi, float zli, float zui) {
    unsigned cta, tid;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
    const int64_t s = int64_t(cta) * TEAMS + tid / NL;
    if (s >= B) return;
    z[s * nz + i] = zi;
    zl[s * nz + i] = zli;
    zu[s * nz + i] = zui;
  };
  mpcq::box_qp_scenario<R, float>(
      tm, nz, iters, tbl, H + b * nz * nz, g + b * nz, lb + b * nz, ub + b * nz,
      zl0 ? zl0 + b * nz : nullptr, zu0 ? zu0 + b * nz : nullptr,
      ws + mpcq::box_qp_table_size<float>(nz) + team * mpcq::box_qp_slot_size(nz), out);
}

namespace {

// f(kernel, teams) for the schedule of `lanes` lanes a scenario at nz: the
// paired blocks (R = 3 slots of 16 lanes, 4 blocks an SM) or one warp a
// block (R = ceil(nz / 32), up to R = 2 at 128 registers).
template <typename F> int with_box_qp_kernel(int lanes, int nz, F&& f) {
  if (mpcq_box_qp_block_scenarios(lanes, nz) == 0) return -1;
  if (lanes == 16)
    return f(mpcq_box_qp_kernel<(mpcq::BOX_QP_PAIR_NZ + 15) / 16, 16, mpcq::BOX_QP_PAIR_TEAMS,
                                mpcq::BOX_QP_PAIR_BLOCKS>,
             mpcq::BOX_QP_PAIR_TEAMS);
  return mpcq::with_slots<mpcq::BOX_QP_SLOTS>(nz, [&](auto slots) {
    constexpr int R = decltype(slots)::value;
    return f(mpcq_box_qp_kernel<R, 32, 1, (R <= 2 ? 16 : 1)>, 1);
  });
}

// One SmemOnce a kernel instantiation: lanes 16, then 32 at R = 1..8.
mpcq::SmemOnce box_qp_smem[1 + mpcq::BOX_QP_SLOTS];
int smem_slot(int lanes, int nz) { return lanes == 16 ? 0 : (nz + 31) / 32; }

}  // namespace

// Kernel E at B scenarios with `lanes` lanes a scenario (16 or 32; 0: the
// schedule mpcq_box_qp_lanes picks).
extern "C" int mpcq_box_qp_sched(const float* H, const float* g, const float* lb,
                                 const float* ub, const float* zl0, const float* zu0, float* z,
                                 float* zl, float* zu, int64_t B, int nz, int iters, int lanes,
                                 void* stream) {
  if (lanes == 0) lanes = mpcq_box_qp_lanes(B, nz);
  const size_t smem = size_t(mpcq_box_qp_block_bytes(lanes, nz));
  return with_box_qp_kernel(lanes, nz, [&](auto kernel, int teams) {
    cudaError_t err = box_qp_smem[smem_slot(lanes, nz)](kernel);
    if (err != cudaSuccess) return int(err);
    if (B > 0)
      kernel<<<dim3(unsigned((B + teams - 1) / teams)), teams * lanes, smem,
               (cudaStream_t)stream>>>(H, g, lb, ub, zl0, zu0, z, zl, zu, B, nz, iters);
    return int(cudaGetLastError());
  });
}

extern "C" int mpcq_box_qp(const float* H, const float* g, const float* lb, const float* ub,
                           const float* zl0, const float* zu0, float* z, float* zl,
                           float* zu, int64_t B, int nz, int iters, void* stream) {
  return mpcq_box_qp_sched(H, g, lb, ub, zl0, zu0, z, zl, zu, B, nz, iters, 0, stream);
}

// Resident blocks per SM of the schedule of `lanes` lanes a scenario at nz,
// from the occupancy API; -1 where it does not take nz.
extern "C" int mpcq_box_qp_resident(int lanes, int nz) {
  return with_box_qp_kernel(lanes, nz, [&](auto kernel, int teams) {
    return mpcq::resident_blocks(kernel, size_t(mpcq_box_qp_block_bytes(lanes, nz)),
                                 teams * lanes);
  });
}

#else
#include <limits>
#include <type_traits>
#include <vector>

namespace {

// Kernel E on the host: one serial lane (lanes = 1), a 32-thread team
// (lanes = 32), each with its own table and slot, or (lanes = 16) the
// card's paired block: BOX_QP_PAIR_TEAMS teams of 16 threads side by side,
// each on its slot of one block workspace whose table is built once, the
// rest NaN so that a read before a write shows.
int box_qp_host(int lanes, const double* H, const double* g, const double* lb,
                const double* ub, const double* zl0, const double* zu0, double* z, double* zl,
                double* zu, int64_t B, int nz, int iters) {
  if (nz > 256 || (lanes == 16 && nz > mpcq::BOX_QP_PAIR_NZ)) return -1;
  const int teams = lanes == 16 ? mpcq::BOX_QP_PAIR_TEAMS : 1;
  const int64_t table = mpcq::box_qp_table_size<double>(nz), slot = mpcq::box_qp_slot_size(nz);
  std::vector<double> ws(size_t(mpcq::box_qp_block_size<double>(nz, teams)),
                         std::numeric_limits<double>::quiet_NaN());
  uint16_t* tbl = reinterpret_cast<uint16_t*>(ws.data());
  mpcq::box_qp_table(0, 1, nz, tbl);
  auto scenario = [&](const auto& tm, int64_t b, int w) {
    constexpr int R = mpcq::host_slots<std::decay_t<decltype(tm)>>;
    mpcq::box_qp_scenario<R, double>(tm, nz, iters, tbl, H + b * nz * nz, g + b * nz,
                                     lb + b * nz, ub + b * nz, zl0 ? zl0 + b * nz : nullptr,
                                     zu0 ? zu0 + b * nz : nullptr, ws.data() + table + w * slot,
                                     [&](int i, double zi, double zli, double zui) {
                                       z[b * nz + i] = zi;
                                       zl[b * nz + i] = zli;
                                       zu[b * nz + i] = zui;
                                     });
  };
  if (lanes == 16) return mpcq::run_block_teams<16>(teams, B, scenario);
  return mpcq::run_host_team(lanes, B, [&](const auto& tm, int64_t b) { scenario(tm, b, 0); });
}

}  // namespace

// Host builds of the same code (f64), for the CPU tests: one serial lane,
// (host32) 32 threads that run the card's lane split and syncs of a warp,
// and (host_block) the card's paired block of 16-thread teams.
#define MPCQ_BOX_QP_ARGS                                                                    \
  const double *H, const double *g, const double *lb, const double *ub, const double *zl0, \
      const double *zu0, double *z, double *zl, double *zu, int64_t B, int nz, int iters
#define MPCQ_BOX_QP_PASS H, g, lb, ub, zl0, zu0, z, zl, zu, B, nz, iters
extern "C" int mpcq_box_qp_host_f64(MPCQ_BOX_QP_ARGS) { return box_qp_host(1, MPCQ_BOX_QP_PASS); }
extern "C" int mpcq_box_qp_host32_f64(MPCQ_BOX_QP_ARGS) {
  return box_qp_host(32, MPCQ_BOX_QP_PASS);
}
extern "C" int mpcq_box_qp_host_block_f64(MPCQ_BOX_QP_ARGS) {
  return box_qp_host(16, MPCQ_BOX_QP_PASS);
}

// The IPM of ipm_box.cuh (kernels B's and F's) on the same QPs, run by a
// 32-thread team on its own packed matrix (ld = nz + 1): the arithmetic
// kernel E keeps, which the CPU tests hold E's host builds to bit for bit.
extern "C" int mpcq_box_qp_shared_ipm_host32_f64(MPCQ_BOX_QP_ARGS) {
  if (nz > 256) return -1;
  std::vector<double> ws(size_t(mpcq::ipm_ws_size(nz)));
  return mpcq::run_host_team(32, B, [&](const auto& tm, int64_t b) {
    constexpr int R = mpcq::host_slots<std::decay_t<decltype(tm)>>;
    const int ld = nz + 1;
    double* A = ws.data();
    for (int e = tm.lane; e < nz * nz; e += 32) {
      const int i = e / nz, j = e % nz;
      if (j > i) A[i * ld + j] = H[b * nz * nz + e];
      if (j == i) A[i * ld + nz] = H[b * nz * nz + e];
    }
    tm.sync();
    mpcq::ipm_box_solve<R>(tm, nz, iters, A, A + mpcq::packed_size(nz), g + b * nz, lb + b * nz,
                           ub + b * nz, zl0 ? zl0 + b * nz : nullptr,
                           zu0 ? zu0 + b * nz : nullptr, z + b * nz, zl + b * nz, zu + b * nz);
  });
}

#endif
