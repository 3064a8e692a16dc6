// Kernels D and J: condensing, one scenario per warp (D) or per block (J).
//
// Kernel D, the "split" pipeline's second kernel, is fed the linearisation J.
// It replaces mpc_quad_ros_tpu/ops/pallas/condense_kernel.py::_condense_kernel_J
// (entry condense_cost_from_J_tiled).  Per scenario b, the condensing of
// condense.cuh (condense_full: the chains of kernel B's condense_packed, so
// split and hybrid form H and g with the same bits) from J (N, 17, 13),
// r (N, 13), dx0 (13) and ex0 = X - [y_ref; y_ref_N] (N+1, 13), writing H
// (nz, nz) with the control diagonal, g (nz) without the control term gu,
// and every condensing map and drift, M (N+1, 13, nz) and d (N+1, 13), which
// the caller needs for X + d + M z.  Scenario-major layout: H (B, nz, nz),
// g (B, nz), M (B, N+1, 13, nz), d (B, N+1, 13).  nz = 4 N.
//
// Kernel J, the small-batch step's condensing, is fed A (N, 13, 13) and B
// (N, 13, 4), row-major, in place of J.  It replaces
// mpc_quad_ros_tpu/ops/pallas/condense_kernel.py::_condense_kernel (entry
// condense_cost_pallas), which the JAX package's solve_batch runs for
// B < 128.  Its per-stage copy transposes A_k and B_k into J's layout (row j
// of stage k = column j of [A_k | B_k]), then it runs kernel D's stage loop,
// so the two agree bitwise on the same linearisation.
//
// What bounds them on the H100.  Kernel D at B = 65536, N = 10 moves about
// 2.6 GB (J 0.58 GB in; M 1.50 GB, H 0.42 GB out): 0.78 ms at 3.35 TB/s,
// against about 12 GFLOP of condensing (0.2 ms at 67 TFLOP/s).  What kept
// it from that was each warp's serial stage loop (13-term chains read from
// shared memory), which only many resident warps hide.  So the design cuts
// the per-scenario workspace to what is live: J streamed a stage ahead
// through two 221-float slots by cp.async, H as its packed lower triangle,
// M_k column-major; 9,524 B a block at N = 10 (19,824 before), 70,724 B at
// N = 40 (155,760 before).  Each lane runs two chains at once, the
// triangle's live prefix (and g) is walked with no idle lane, and M_k and H
// leave in 16-byte stores.  What is left is the chains' operands: each
// multiply-add still reads two of them from shared memory, about 5,500
// warp-wide loads a scenario at N = 10.  Kernel J runs at B < 128, under one
// wave, where its time is one scenario's serial stage loop: it runs that
// loop on a whole block (CONDENSE_AB_THREADS), so each stage's walks
// spread over more lanes, and each stage's device-memory
// addends are loaded ahead of the chains.  Nothing is reduced across
// blocks, so a NaN in one scenario leaves every other scenario bitwise
// unchanged.

#include "condense.cuh"

// Dynamic shared memory of one block of the card's (f32) kernels D and J, in
// bytes.
extern "C" int64_t mpcq_condense_ws_bytes(int N) {
  return mpcq::condense_ws_size(N) * int64_t(sizeof(float));
}

// Kernel J's threads a block (one scenario a block): of 32, 64, 128 and
// 256, the fastest at B = 1 and 127 on an H100 (PERF.md, kernel J).
constexpr int CONDENSE_AB_THREADS = 256;
extern "C" int mpcq_condense_ab_threads() { return CONDENSE_AB_THREADS; }

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32)
mpcq_condense_kernel(const float* __restrict__ J, const float* __restrict__ r,
                     const float* __restrict__ dx0, const float* __restrict__ ex0,
                     float* __restrict__ H, float* __restrict__ g, float* __restrict__ M,
                     float* __restrict__ d, int N, mpcq::Weights<float> wt) {
  using namespace mpcq;
  extern __shared__ __align__(16) float ws[];
  const int64_t b = blockIdx.x;
  const int64_t nz = N * SU;
  WarpTeam tm{int(threadIdx.x)};
  const CondenseWork<float> cw(ws, N);
  condense_full(tm, N, wt, StreamedJ<float>{J + b * N * J_STAGE, cw.Jb, N}, cw,
                r + b * N * SX, dx0 + b * SX, ex0 + b * (N + 1) * SX, H + b * nz * nz,
                g + b * nz, M + b * (N + 1) * SX * nz, d + b * (N + 1) * SX);
}

__global__ void __launch_bounds__(CONDENSE_AB_THREADS)
mpcq_condense_ab_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                        const float* __restrict__ r, const float* __restrict__ dx0,
                        const float* __restrict__ ex0, float* __restrict__ H,
                        float* __restrict__ g, float* __restrict__ M, float* __restrict__ d,
                        int N, mpcq::Weights<float> wt) {
  using namespace mpcq;
  extern __shared__ __align__(16) float ws[];
  const int64_t b = blockIdx.x;
  const int64_t nz = N * SU;
  BlockTeam<CONDENSE_AB_THREADS> tm{int(threadIdx.x)};
  const CondenseWork<float> cw(ws, N);
  const StreamedAB<float> js{A + b * N * SX * SX, Bm + b * N * SX * SU,
                             StreamedJ<float>{nullptr, cw.Jb, N}};
  condense_full(tm, N, wt, js, cw, r + b * N * SX, dx0 + b * SX, ex0 + b * (N + 1) * SX,
                H + b * nz * nz, g + b * nz, M + b * (N + 1) * SX * nz, d + b * (N + 1) * SX);
}

namespace {

// Shared-memory attributes are set at a kernel's first launch on a device
// only.
mpcq::SmemOnce condense_smem, condense_ab_smem;

}  // namespace

extern "C" int mpcq_condense(const float* J, const float* r, const float* dx0,
                             const float* ex0, const float* weights, float* H, float* g,
                             float* M, float* d, int64_t B, int N, void* stream) {
  cudaError_t err = condense_smem(mpcq_condense_kernel);
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_condense_kernel<<<dim3(unsigned(B)), 32, size_t(mpcq_condense_ws_bytes(N)),
                           (cudaStream_t)stream>>>(J, r, dx0, ex0, H, g, M, d, N,
                                                   mpcq::weights_from<float>(weights));
  return int(cudaGetLastError());
}

extern "C" int mpcq_condense_ab(const float* A, const float* Bm, const float* r,
                                const float* dx0, const float* ex0, const float* weights,
                                float* H, float* g, float* M, float* d, int64_t B, int N,
                                void* stream) {
  cudaError_t err = condense_ab_smem(mpcq_condense_ab_kernel);
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_condense_ab_kernel<<<dim3(unsigned(B)), CONDENSE_AB_THREADS,
                              size_t(mpcq_condense_ws_bytes(N)), (cudaStream_t)stream>>>(
        A, Bm, r, dx0, ex0, H, g, M, d, N, mpcq::weights_from<float>(weights));
  return int(cudaGetLastError());
}

// Resident blocks per SM from the occupancy API at horizon N: kernel D (one
// warp a block) and kernel J (CONDENSE_AB_THREADS a block).
extern "C" int mpcq_condense_occupancy(int N) {
  return mpcq::resident_blocks(mpcq_condense_kernel, size_t(mpcq_condense_ws_bytes(N)));
}
extern "C" int mpcq_condense_ab_occupancy(int N) {
  return mpcq::resident_blocks(mpcq_condense_ab_kernel, size_t(mpcq_condense_ws_bytes(N)),
                               CONDENSE_AB_THREADS);
}

#else
#include <vector>

namespace {

// Kernels D and J on the host: one serial lane (lanes = 1), (kernel D) the
// warp's 32 lanes or (kernel J) its block's, scenarios one after another.
int condense_host(int lanes, const double* J, const double* r, const double* dx0,
                  const double* ex0, const double* weights, double* H, double* g, double* M,
                  double* d, int64_t B, int N) {
  using namespace mpcq;
  const int64_t nz = N * SU;
  const Weights<double> wt = weights_from<double>(weights);
  std::vector<double> ws(size_t(condense_ws_size(N)));
  const CondenseWork<double> cw(ws.data(), N);
  return run_host_team(lanes, B, [&](const auto& tm, int64_t b) {
    condense_full(tm, N, wt, StreamedJ<double>{J + b * N * J_STAGE, cw.Jb, N}, cw,
                  r + b * N * SX, dx0 + b * SX, ex0 + b * (N + 1) * SX, H + b * nz * nz,
                  g + b * nz, M + b * (N + 1) * SX * nz, d + b * (N + 1) * SX);
  });
}

int condense_ab_host(int lanes, const double* A, const double* Bm, const double* r,
                     const double* dx0, const double* ex0, const double* weights, double* H,
                     double* g, double* M, double* d, int64_t B, int N) {
  using namespace mpcq;
  const int64_t nz = N * SU;
  const Weights<double> wt = weights_from<double>(weights);
  std::vector<double> ws(size_t(condense_ws_size(N)));
  const CondenseWork<double> cw(ws.data(), N);
  return run_host_team<CONDENSE_AB_THREADS>(lanes, B, [&](const auto& tm, int64_t b) {
    const StreamedAB<double> js{A + b * N * SX * SX, Bm + b * N * SX * SU,
                                StreamedJ<double>{nullptr, cw.Jb, N}};
    condense_full(tm, N, wt, js, cw, r + b * N * SX, dx0 + b * SX, ex0 + b * (N + 1) * SX,
                  H + b * nz * nz, g + b * nz, M + b * (N + 1) * SX * nz, d + b * (N + 1) * SX);
  });
}

}  // namespace

// Host builds of the same code (f64), for the CPU tests: one serial lane,
// (host32, kernel D) the warp's lane split and syncs on 32 threads, and
// (host256, kernel J) its block's on CONDENSE_AB_THREADS.
#define MPCQ_CONDENSE_ARGS                                                                   \
  const double *J, const double *r, const double *dx0, const double *ex0,                    \
      const double *weights, double *H, double *g, double *M, double *d, int64_t B, int N
#define MPCQ_CONDENSE_PASS J, r, dx0, ex0, weights, H, g, M, d, B, N
#define MPCQ_CONDENSE_AB_ARGS                                                                \
  const double *A, const double *Bm, const double *r, const double *dx0, const double *ex0, \
      const double *weights, double *H, double *g, double *M, double *d, int64_t B, int N
#define MPCQ_CONDENSE_AB_PASS A, Bm, r, dx0, ex0, weights, H, g, M, d, B, N
extern "C" int mpcq_condense_host_f64(MPCQ_CONDENSE_ARGS) {
  return condense_host(1, MPCQ_CONDENSE_PASS);
}
extern "C" int mpcq_condense_host32_f64(MPCQ_CONDENSE_ARGS) {
  return condense_host(32, MPCQ_CONDENSE_PASS);
}
extern "C" int mpcq_condense_ab_host_f64(MPCQ_CONDENSE_AB_ARGS) {
  return condense_ab_host(1, MPCQ_CONDENSE_AB_PASS);
}
extern "C" int mpcq_condense_ab_host256_f64(MPCQ_CONDENSE_AB_ARGS) {
  return condense_ab_host(CONDENSE_AB_THREADS, MPCQ_CONDENSE_AB_PASS);
}

#endif
