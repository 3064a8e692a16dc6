// Kernel A: RK4 shooting-map linearisation with the folded-RGP drag.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/lin_kernel.py::_lin_kernel.  For every
// (scenario b, stage k) it writes x+ = RK4(f, x_k, u_k, dt) (13 values) and
// J = [A | B] as 17 tangent rows of 13 (row i = d x+ / d (x, u)_i), laid out
// scenario-major: xp (B, N, 13), J (B, N, 17, 13).  X is read as the whole
// (B, N+1, 13) trajectory (stage k reads node k), U as (B, N, 4), the folded
// drag per scenario: Xb, wb (B, 3, nb), L, sigma_f (B, 3).
//
// Design: one thread per (column, tangent), 17*B*N threads, each running one
// (stage, tangent) item of model.cuh (the model on forward dual numbers,
// shared with kernel F).  Thread i = 0 also writes the primal x+.
//
// What bounds it on the H100: registers and FLOPs per thread — each thread
// carries 4 RK4 stages of 13 duals and evaluates 3*nb exponentials per stage,
// and the 17 threads of a column recompute the same primal.  J is written
// once (the only large HBM stream).  The simple design accepts the 17x primal
// recomputation; sharing the primal across a column's threads is later work.

#include "model.cuh"

namespace mpcq {

// One (column, tangent) thread: t = (b * N + k) * 17 + i.
template <typename T>
MPCQ_HD void lin_thread(int64_t t, const T* X, const T* U, const T* Xb, const T* wb,
                        const T* L, const T* sf, int nb, T* xp, T* J, int N,
                        const ModelConsts<T>& c) {
  int i = int(t % NT);
  int64_t col = t / NT;
  int k = int(col % N);
  int64_t b = col / N;
  DragView<T> g{nb > 0 ? Xb + b * 3 * nb : nullptr, nb > 0 ? wb + b * 3 * nb : nullptr,
                nb > 0 ? L + b * 3 : nullptr, nb > 0 ? sf + b * 3 : nullptr, nb};
  Dual<T> x[NX];
  lin_item(X + (b * (N + 1) + k) * NX, U + col * NU, g, i, c, x);
  T* Jrow = J + (col * NT + i) * NX;
  for (int j = 0; j < NX; ++j) Jrow[j] = x[j].d;
  if (i == 0)
    for (int j = 0; j < NX; ++j) xp[col * NX + j] = x[j].v;
}

}  // namespace mpcq

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(128)
mpcq_lin_kernel(const float* __restrict__ X, const float* __restrict__ U,
                const float* __restrict__ Xb, const float* __restrict__ wb,
                const float* __restrict__ L, const float* __restrict__ sf, int nb,
                float* __restrict__ xp, float* __restrict__ J, int64_t B, int N,
                mpcq::ModelConsts<float> c) {
  int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * N * mpcq::NT) return;
  mpcq::lin_thread<float>(t, X, U, Xb, wb, L, sf, nb, xp, J, N, c);
}

extern "C" int mpcq_lin(const float* X, const float* U, const float* Xb, const float* wb,
                        const float* L, const float* sf, int nb, float* xp, float* J,
                        int64_t B, int N, const float* consts, void* stream) {
  mpcq::ModelConsts<float> c = mpcq::consts_from<float>(consts);
  int64_t total = B * N * mpcq::NT;
  if (total > 0) {
    const int threads = 128;
    int64_t blocks = (total + threads - 1) / threads;
    mpcq_lin_kernel<<<dim3(unsigned(blocks)), threads, 0, (cudaStream_t)stream>>>(
        X, U, Xb, wb, L, sf, nb, xp, J, B, N, c);
  }
  return int(cudaGetLastError());
}

#else

// Host build of the same code (f64), for the CPU tests.
extern "C" int mpcq_lin_host_f64(const double* X, const double* U, const double* Xb,
                                 const double* wb, const double* L, const double* sf,
                                 int nb, double* xp, double* J, int64_t B, int N,
                                 const double* consts) {
  mpcq::ModelConsts<double> c = mpcq::consts_from<double>(consts);
  for (int64_t t = 0; t < B * N * mpcq::NT; ++t)
    mpcq::lin_thread<double>(t, X, U, Xb, wb, L, sf, nb, xp, J, N, c);
  return 0;
}

#endif
