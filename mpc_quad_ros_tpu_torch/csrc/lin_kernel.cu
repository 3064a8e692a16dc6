// Kernel A: RK4 shooting-map linearisation with the folded-RGP drag.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/lin_kernel.py::_lin_kernel.  For every
// (scenario b, stage k) it writes x+ = RK4(f, x_k, u_k, dt) (13 values) and
// J = [A | B] as 17 tangent rows of 13 (row i = d x+ / d (x, u)_i), laid out
// scenario-major: xp (B, N, 13), J (B, N, 17, 13).  X is read as the whole
// (B, N+1, 13) trajectory (stage k reads node k), U as (B, N, 4), the folded
// drag per scenario: Xb, wb (B, 3, nb), L, sigma_f (B, 3).
//
// Design: one thread per (column, tangent), 17*B*N threads.  The model is
// written once as a template over the scalar type; the tangent threads run
// it on forward dual numbers {val, der} seeded with the unit vector of their
// input, so no derivative is written by hand.  The drag mean uses the
// diagonal-Jacobian rule of the JAX kernel's custom JVP (_mk_drag_mean): each
// axis's mean depends only on v_b[axis], so its tangent is Jdiag * dv_b.
// Thread i = 0 also writes the primal x+ (its val part).
//
// What bounds it on the H100: registers and FLOPs per thread — each thread
// carries 4 RK4 stages of 13 duals and evaluates 3*nb exponentials per stage,
// and the 17 threads of a column recompute the same primal.  J is written
// once (the only large HBM stream).  The simple design accepts the 17x primal
// recomputation; sharing the primal across a column's threads is later work.
//
// Parameters arrive as a POD struct of the scalars the JAX kernel derives
// (_make_f), not as literals.  Built without --use_fast_math: expf stays
// IEEE-accurate so the f32 kernel stays close to the f64 oracle.

#include "common.cuh"

namespace mpcq {

constexpr int NX = 13, NU = 4, NT = 17;

template <typename T> struct ModelConsts {
  T kt[4], x_f[4], y_f[4], z_l[4];
  T inv_m, g2, a_payload_z;
  T J0, J1, J2, J12, J20, J01;   // inertia and its differences J1-J2, J2-J0, J0-J1
  T h, h2, h6;                   // dt, dt/2, dt/6
};

template <typename T> ModelConsts<T> consts_from(const T* c) {
  ModelConsts<T> m;
  for (int i = 0; i < 4; ++i) {
    m.kt[i] = c[i]; m.x_f[i] = c[4 + i]; m.y_f[i] = c[8 + i]; m.z_l[i] = c[12 + i];
  }
  m.inv_m = c[16]; m.g2 = c[17]; m.a_payload_z = c[18];
  m.J0 = c[19]; m.J1 = c[20]; m.J2 = c[21];
  m.J12 = c[22]; m.J20 = c[23]; m.J01 = c[24];
  m.h = c[25]; m.h2 = c[26]; m.h6 = c[27];
  return m;
}

// Forward-mode dual number.
template <typename T> struct Dual { T v, d; };
template <typename T> MPCQ_HD Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T> MPCQ_HD Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T> MPCQ_HD Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T> MPCQ_HD Dual<T> operator*(Dual<T> a, Dual<T> b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
template <typename T> MPCQ_HD Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <typename T> MPCQ_HD Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <typename T> MPCQ_HD Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <typename T> MPCQ_HD Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T> MPCQ_HD Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <typename T> MPCQ_HD Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }

// Folded-RGP drag of one scenario: Xb, wb (3, nb); L, sf (3).
template <typename T> struct DragView {
  const T* Xb; const T* wb; const T* L; const T* sf; int nb;
};

// Per-axis mean sum_j sf^2 exp(-0.5 (vb - X_j)^2 / L^2) w_j.
template <typename T>
MPCQ_HD T drag_mean(T vb, const DragView<T>& g, int a) {
  const T* X = g.Xb + a * g.nb;
  const T* w = g.wb + a * g.nb;
  T L = g.L[a], sf = g.sf[a];
  T sf2 = sf * sf, L2 = L * L, m = T(0);
  for (int j = 0; j < g.nb; ++j) {
    T diff = vb - X[j];
    T k = sf2 * m_exp(T(-0.5) * (diff * diff) / L2);
    m = m + k * w[j];
  }
  return m;
}

// Dual version: value as above, tangent = Jdiag * dvb with
// Jdiag = sum_j k_j w_j (-(vb - X_j) / L^2)  (the JAX custom JVP rule).
template <typename T>
MPCQ_HD Dual<T> drag_mean(Dual<T> vb, const DragView<T>& g, int a) {
  const T* X = g.Xb + a * g.nb;
  const T* w = g.wb + a * g.nb;
  T L = g.L[a], sf = g.sf[a];
  T sf2 = sf * sf, L2 = L * L, m = T(0), jd = T(0);
  for (int j = 0; j < g.nb; ++j) {
    T diff = vb.v - X[j];
    T kw = sf2 * m_exp(T(-0.5) * (diff * diff) / L2) * w[j];
    m = m + kw;
    jd = jd + kw * (-diff / L2);
  }
  return {m, jd * vb.d};
}

// The MPC model f(x, u) with the folded drag — the formulas of _make_f.
template <typename S, typename T>
MPCQ_HD void model_f(const S* x, const S* u, const ModelConsts<T>& c,
                     const DragView<T>& g, S* dx) {
  S qw = x[3], qx = x[4], qy = x[5], qz = x[6];
  S vx = x[7], vy = x[8], vz = x[9];
  S wx = x[10], wy = x[11], wz = x[12];

  S ft0 = u[0] * c.kt[0], ft1 = u[1] * c.kt[1], ft2 = u[2] * c.kt[2], ft3 = u[3] * c.kt[3];
  S thrust = ft0 + ft1 + ft2 + ft3;

  const T half = T(0.5), one = T(1), two = T(2);
  S dqw = half * (-(wx * qx) - wy * qy - wz * qz);
  S dqx = half * (wx * qw + wz * qy - wy * qz);
  S dqy = half * (wy * qw - wz * qx + wx * qz);
  S dqz = half * (wz * qw + wy * qx - wx * qy);

  S r11 = one - two * (qy * qy + qz * qz);
  S r12 = two * (qx * qy - qw * qz);
  S r13 = two * (qx * qz + qw * qy);
  S r21 = two * (qx * qy + qw * qz);
  S r22 = one - two * (qx * qx + qz * qz);
  S r23 = two * (qy * qz - qw * qx);
  S r31 = two * (qx * qz - qw * qy);
  S r32 = two * (qy * qz + qw * qx);
  S r33 = one - two * (qx * qx + qy * qy);

  S a_m = thrust * c.inv_m;
  S avx = r13 * a_m;
  S avy = r23 * a_m;
  S avz = r33 * a_m - c.g2 + c.a_payload_z;

  if (g.nb > 0) {
    S vbx = r11 * vx + r21 * vy + r31 * vz;
    S vby = r12 * vx + r22 * vy + r32 * vz;
    S vbz = r13 * vx + r23 * vy + r33 * vz;
    S m0 = drag_mean(vbx, g, 0), m1 = drag_mean(vby, g, 1), m2 = drag_mean(vbz, g, 2);
    avx = avx + r11 * m0 + r12 * m1 + r13 * m2;
    avy = avy + r21 * m0 + r22 * m1 + r23 * m2;
    avz = avz + r31 * m0 + r32 * m1 + r33 * m2;
  }

  S tx = ft0 * c.y_f[0] + ft1 * c.y_f[1] + ft2 * c.y_f[2] + ft3 * c.y_f[3];
  S ty = -(ft0 * c.x_f[0] + ft1 * c.x_f[1] + ft2 * c.x_f[2] + ft3 * c.x_f[3]);
  S tz = ft0 * c.z_l[0] + ft1 * c.z_l[1] + ft2 * c.z_l[2] + ft3 * c.z_l[3];

  dx[0] = vx; dx[1] = vy; dx[2] = vz;
  dx[3] = dqw; dx[4] = dqx; dx[5] = dqy; dx[6] = dqz;
  dx[7] = avx; dx[8] = avy; dx[9] = avz;
  dx[10] = (tx + c.J12 * wy * wz) / c.J0;
  dx[11] = (ty + c.J20 * wz * wx) / c.J1;
  dx[12] = (tz + c.J01 * wx * wy) / c.J2;
}

// x+ = x + dt/6 (k1 + 2 k2 + 2 k3 + k4), the control held.
template <typename S, typename T>
MPCQ_HD void rk4(S* x, const S* u, const ModelConsts<T>& c, const DragView<T>& g) {
  S k[NX], acc[NX], xs[NX];
  const T two = T(2);
  model_f(x, u, c, g, k);                                    // k1
  for (int j = 0; j < NX; ++j) { acc[j] = k[j]; xs[j] = x[j] + c.h2 * k[j]; }
  model_f(xs, u, c, g, k);                                   // k2
  for (int j = 0; j < NX; ++j) { acc[j] = acc[j] + two * k[j]; xs[j] = x[j] + c.h2 * k[j]; }
  model_f(xs, u, c, g, k);                                   // k3
  for (int j = 0; j < NX; ++j) { acc[j] = acc[j] + two * k[j]; xs[j] = x[j] + c.h * k[j]; }
  model_f(xs, u, c, g, k);                                   // k4
  for (int j = 0; j < NX; ++j) x[j] = x[j] + c.h6 * (acc[j] + k[j]);
}

// One (column, tangent) thread: t = (b * N + k) * 17 + i.
template <typename T>
MPCQ_HD void lin_thread(int64_t t, const T* X, const T* U, const T* Xb, const T* wb,
                        const T* L, const T* sf, int nb, T* xp, T* J, int N,
                        const ModelConsts<T>& c) {
  int i = int(t % NT);
  int64_t col = t / NT;
  int k = int(col % N);
  int64_t b = col / N;
  const T* x0 = X + (b * (N + 1) + k) * NX;
  const T* u0 = U + col * NU;
  DragView<T> g{nb > 0 ? Xb + b * 3 * nb : nullptr, nb > 0 ? wb + b * 3 * nb : nullptr,
                nb > 0 ? L + b * 3 : nullptr, nb > 0 ? sf + b * 3 : nullptr, nb};
  Dual<T> x[NX], u[NU];
  for (int j = 0; j < NX; ++j) x[j] = {x0[j], T(j == i ? 1 : 0)};
  for (int a = 0; a < NU; ++a) u[a] = {u0[a], T(NX + a == i ? 1 : 0)};
  rk4(x, u, c, g);
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
