// The MPC model of the linearisation kernels: the folded-RGP drag model f,
// its RK4 step, and the forward dual numbers that give the step's tangents.
//
// Shared by kernels A (lin_kernel.cu) and F (sqp_fused_kernel.cu), which
// both run the primal step once per column, recorded (step_item on the
// record drags below), then the 17 tangents with the recorded primal read
// back (tangent_item), so both linearise by the same model code and the
// same record.
// The model is written once as a template over the scalar type: the primal
// on Val numbers, a tangent item on forward dual numbers {val, der} seeded
// with the unit vector of its input, so no derivative is written by hand.
// The drag mean uses the diagonal-Jacobian rule of the JAX kernel's custom
// JVP (_mk_drag_mean): each axis's mean depends only on v_b[axis], so its
// tangent is Jdiag * dv_b.
//
// Every operation of the model is one explicitly rounded IEEE operation
// (the rn_* functions; a product added to something is one fma, written
// out), which the compiler fuses into no other: a value and a derivative
// get the same bits in whichever kernel inlines them, so kernels A and F,
// their primal and tangent passes and the dual pass they take apart agree
// bit for bit by construction, not by the compiler's choice of contractions.
//
// Parameters arrive as a POD struct of the scalars the JAX kernel derives
// (_make_f), not as literals.  Built without --use_fast_math: expf stays
// IEEE-accurate so the f32 kernels stay close to the f64 oracle.
#pragma once

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

// Explicitly rounded operations (the host build compiles with
// -ffp-contract=off, so its plain operators round once each too).
#if defined(__CUDA_ARCH__)
MPCQ_HD float rn_add(float a, float b) { return __fadd_rn(a, b); }
MPCQ_HD float rn_sub(float a, float b) { return __fsub_rn(a, b); }
MPCQ_HD float rn_mul(float a, float b) { return __fmul_rn(a, b); }
MPCQ_HD float rn_div(float a, float b) { return __fdiv_rn(a, b); }
MPCQ_HD float rn_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
MPCQ_HD double rn_add(double a, double b) { return __dadd_rn(a, b); }
MPCQ_HD double rn_sub(double a, double b) { return __dsub_rn(a, b); }
MPCQ_HD double rn_mul(double a, double b) { return __dmul_rn(a, b); }
MPCQ_HD double rn_div(double a, double b) { return __ddiv_rn(a, b); }
MPCQ_HD double rn_fma(double a, double b, double c) { return __fma_rn(a, b, c); }
#else
template <typename T> MPCQ_HD T rn_add(T a, T b) { return a + b; }
template <typename T> MPCQ_HD T rn_sub(T a, T b) { return a - b; }
template <typename T> MPCQ_HD T rn_mul(T a, T b) { return a * b; }
template <typename T> MPCQ_HD T rn_div(T a, T b) { return a / b; }
template <typename T> MPCQ_HD T rn_fma(T a, T b, T c) { return std::fma(a, b, c); }
#endif

// A primal number: the model's arithmetic on values alone, rounded as a
// dual number's value is.
template <typename T> struct Val { T v; };
template <typename T> MPCQ_HD Val<T> operator+(Val<T> a, Val<T> b) { return {rn_add(a.v, b.v)}; }
template <typename T> MPCQ_HD Val<T> operator-(Val<T> a) { return {-a.v}; }
template <typename T> MPCQ_HD Val<T> operator*(Val<T> a, Val<T> b) { return {rn_mul(a.v, b.v)}; }
template <typename T> MPCQ_HD Val<T> operator-(Val<T> a, T b) { return {rn_sub(a.v, b)}; }
template <typename T> MPCQ_HD Val<T> operator+(Val<T> a, T b) { return {rn_add(a.v, b)}; }
template <typename T> MPCQ_HD Val<T> operator*(Val<T> a, T b) { return {rn_mul(a.v, b)}; }
template <typename T> MPCQ_HD Val<T> operator*(T a, Val<T> b) { return {rn_mul(a, b.v)}; }
template <typename T> MPCQ_HD Val<T> operator/(Val<T> a, T b) { return {rn_div(a.v, b)}; }
// a b + c; a x + c with a and c constants
template <typename T> MPCQ_HD Val<T> fma(Val<T> a, Val<T> b, Val<T> c) {
  return {rn_fma(a.v, b.v, c.v)};
}
template <typename T> MPCQ_HD Val<T> fma(T a, Val<T> b, Val<T> c) { return {rn_fma(a, b.v, c.v)}; }
template <typename T> MPCQ_HD Val<T> fma(Val<T> a, T b, Val<T> c) { return {rn_fma(a.v, b, c.v)}; }
template <typename T> MPCQ_HD Val<T> axpc(T a, Val<T> x, T c) { return {rn_fma(a, x.v, c)}; }

// Forward-mode dual number: the value as Val's, the derivative of each
// operation from the operands' values (a product's: d(a) b + a d(b), one
// fma on one product).
template <typename T> struct Dual { T v, d; };
template <typename T> MPCQ_HD Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {rn_add(a.v, b.v), rn_add(a.d, b.d)};
}
template <typename T> MPCQ_HD Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T> MPCQ_HD Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {rn_mul(a.v, b.v), rn_fma(a.d, b.v, rn_mul(a.v, b.d))};
}
template <typename T> MPCQ_HD Dual<T> operator+(Dual<T> a, T b) { return {rn_add(a.v, b), a.d}; }
template <typename T> MPCQ_HD Dual<T> operator-(Dual<T> a, T b) { return {rn_sub(a.v, b), a.d}; }
template <typename T> MPCQ_HD Dual<T> operator*(Dual<T> a, T b) {
  return {rn_mul(a.v, b), rn_mul(a.d, b)};
}
template <typename T> MPCQ_HD Dual<T> operator*(T a, Dual<T> b) {
  return {rn_mul(a, b.v), rn_mul(a, b.d)};
}
template <typename T> MPCQ_HD Dual<T> operator/(Dual<T> a, T b) {
  return {rn_div(a.v, b), rn_div(a.d, b)};
}
template <typename T> MPCQ_HD Dual<T> fma(Dual<T> a, Dual<T> b, Dual<T> c) {
  return {rn_fma(a.v, b.v, c.v), rn_fma(a.d, b.v, rn_fma(a.v, b.d, c.d))};
}
template <typename T> MPCQ_HD Dual<T> fma(T a, Dual<T> b, Dual<T> c) {
  return {rn_fma(a, b.v, c.v), rn_fma(a, b.d, c.d)};
}
template <typename T> MPCQ_HD Dual<T> fma(Dual<T> a, T b, Dual<T> c) {
  return {rn_fma(a.v, b, c.v), rn_fma(a.d, b, c.d)};
}
template <typename T> MPCQ_HD Dual<T> axpc(T a, Dual<T> x, T c) {
  return {rn_fma(a, x.v, c), rn_mul(a, x.d)};
}

// Folded-RGP drag of one scenario: Xb, wb (3, nb); L, sf (3).
template <typename T> struct DragView {
  const T* Xb; const T* wb; const T* L; const T* sf; int nb;
};

// Scenario b's drag in the batch's (B, 3, nb) and (B, 3) arrays.
template <typename T>
MPCQ_HD DragView<T> drag_of(int64_t b, const T* Xb, const T* wb, const T* L, const T* sf,
                            int nb) {
  return {nb > 0 ? Xb + b * 3 * nb : nullptr, nb > 0 ? wb + b * 3 * nb : nullptr,
          nb > 0 ? L + b * 3 : nullptr, nb > 0 ? sf + b * 3 : nullptr, nb};
}

// The points of model_f whose value a tangent needs besides its own: slots
// 3-12 the stage's state x[slot], ANCHOR_AM the thrust acceleration a_m.  A
// DragView keeps the value computed there; the record drags overload this
// to record it (the primal pass) or to put the recorded value in a dual's
// place (the tangent pass), so that pass computes the
// derivative half of each dual operation and the compiler drops the rest.
constexpr int ANCHOR_AM = NX;
template <typename T, typename S> MPCQ_HD S anchor(const DragView<T>&, S v, int) { return v; }

// Basis vector j's term of the axis's mean sum_j sf^2 exp(-0.5 (vb - X_j)^2
// / L^2) w_j and of its Jacobian diagonal Jdiag = sum_j k_j w_j (-(vb - X_j)
// / L^2) (the JAX custom JVP rule), added to m and jd.
template <typename T>
MPCQ_HD void drag_term(T vb, T Xj, T wj, T sf2, T L2, T& m, T& jd) {
  const T diff = rn_sub(vb, Xj);
  const T kw = rn_mul(rn_mul(sf2, m_exp(rn_div(rn_mul(T(-0.5), rn_mul(diff, diff)), L2))), wj);
  m = rn_add(m, kw);
  jd = rn_fma(kw, rn_div(-diff, L2), jd);
}

// One axis's mean and Jdiag.
template <typename T> MPCQ_HD void drag_sums(T vb, const DragView<T>& g, int a, T& m, T& jd) {
  const T* X = g.Xb + a * g.nb;
  const T* w = g.wb + a * g.nb;
  const T L = g.L[a], sf = g.sf[a];
  const T sf2 = rn_mul(sf, sf), L2 = rn_mul(L, L);
  m = T(0);
  jd = T(0);
  for (int j = 0; j < g.nb; ++j) drag_term(vb, X[j], w[j], sf2, L2, m, jd);
}

// The three axes' means of vb (3), model_f's call: one axis after another,
// a dual mean's tangent Jdiag dvb.  The record drags overload this to
// record the sums (the primal pass) or read them back (the tangent pass).
template <typename T>
MPCQ_HD void drag_means(const Dual<T>* vb, const DragView<T>& g, Dual<T>* m) {
  for (int a = 0; a < 3; ++a) {
    T jd;
    drag_sums(vb[a].v, g, a, m[a].v, jd);
    m[a].d = rn_mul(jd, vb[a].d);
  }
}

// The drag of RK4 stage s (0-3): a DragView is the same at every stage;
// the recording and recorded drags overload this.
template <typename T> MPCQ_HD const DragView<T>& stage_drag(const DragView<T>& g, int) {
  return g;
}

// The MPC model f(x, u) with the folded drag — the formulas of _make_f, a
// product added to a sum as one fma.  S is Val<T> or Dual<T>; the drag G is
// a DragView, or any type with an `nb` and drag_means and anchor overloads
// (the record drags).
template <typename S, typename T, typename G>
MPCQ_HD void model_f(const S* x, const S* u, const ModelConsts<T>& c, const G& g, S* dx) {
  S qw = anchor(g, x[3], 3), qx = anchor(g, x[4], 4), qy = anchor(g, x[5], 5),
    qz = anchor(g, x[6], 6);
  S vx = anchor(g, x[7], 7), vy = anchor(g, x[8], 8), vz = anchor(g, x[9], 9);
  S wx = anchor(g, x[10], 10), wy = anchor(g, x[11], 11), wz = anchor(g, x[12], 12);

  S ft0 = u[0] * c.kt[0], ft1 = u[1] * c.kt[1], ft2 = u[2] * c.kt[2], ft3 = u[3] * c.kt[3];
  S thrust = ft0 + ft1 + ft2 + ft3;

  const T half = T(0.5), one = T(1), two = T(2);
  // dq = q (x) (0, w) / 2
  S dqw = half * -fma(wz, qz, fma(wy, qy, wx * qx));
  S dqx = half * fma(-wy, qz, fma(wz, qy, wx * qw));
  S dqy = half * fma(wx, qz, fma(-wz, qx, wy * qw));
  S dqz = half * fma(-wx, qy, fma(wy, qx, wz * qw));

  S r11 = axpc(-two, fma(qy, qy, qz * qz), one);
  S r12 = two * fma(-qw, qz, qx * qy);
  S r13 = two * fma(qw, qy, qx * qz);
  S r21 = two * fma(qw, qz, qx * qy);
  S r22 = axpc(-two, fma(qx, qx, qz * qz), one);
  S r23 = two * fma(-qw, qx, qy * qz);
  S r31 = two * fma(-qw, qy, qx * qz);
  S r32 = two * fma(qw, qx, qy * qz);
  S r33 = axpc(-two, fma(qx, qx, qy * qy), one);

  S a_m = anchor(g, thrust * c.inv_m, ANCHOR_AM);
  S avx = r13 * a_m;
  S avy = r23 * a_m;
  S avz = r33 * a_m - c.g2 + c.a_payload_z;

  if (g.nb > 0) {
    const S vb[3] = {fma(r31, vz, fma(r21, vy, r11 * vx)), fma(r32, vz, fma(r22, vy, r12 * vx)),
                     fma(r33, vz, fma(r23, vy, r13 * vx))};
    S m[3];
    drag_means(vb, g, m);
    avx = fma(r13, m[2], fma(r12, m[1], fma(r11, m[0], avx)));
    avy = fma(r23, m[2], fma(r22, m[1], fma(r21, m[0], avy)));
    avz = fma(r33, m[2], fma(r32, m[1], fma(r31, m[0], avz)));
  }

  S tx = fma(ft3, c.y_f[3], fma(ft2, c.y_f[2], fma(ft1, c.y_f[1], ft0 * c.y_f[0])));
  S ty = -fma(ft3, c.x_f[3], fma(ft2, c.x_f[2], fma(ft1, c.x_f[1], ft0 * c.x_f[0])));
  S tz = fma(ft3, c.z_l[3], fma(ft2, c.z_l[2], fma(ft1, c.z_l[1], ft0 * c.z_l[0])));

  dx[0] = vx; dx[1] = vy; dx[2] = vz;
  dx[3] = dqw; dx[4] = dqx; dx[5] = dqy; dx[6] = dqz;
  dx[7] = avx; dx[8] = avy; dx[9] = avz;
  dx[10] = fma(c.J12 * wy, wz, tx) / c.J0;
  dx[11] = fma(c.J20 * wz, wx, ty) / c.J1;
  dx[12] = fma(c.J01 * wx, wy, tz) / c.J2;
}

// x+ = x + dt/6 (k1 + 2 k2 + 2 k3 + k4), the control held; stage s's model
// takes stage_drag(g, s).
template <typename S, typename T, typename G>
MPCQ_HD void rk4(S* x, const S* u, const ModelConsts<T>& c, const G& g) {
  S k[NX], acc[NX], xs[NX];
  const T two = T(2);
  model_f(x, u, c, stage_drag(g, 0), k);                     // k1
  for (int j = 0; j < NX; ++j) { acc[j] = k[j]; xs[j] = fma(c.h2, k[j], x[j]); }
  model_f(xs, u, c, stage_drag(g, 1), k);                    // k2
  for (int j = 0; j < NX; ++j) { acc[j] = fma(two, k[j], acc[j]); xs[j] = fma(c.h2, k[j], x[j]); }
  model_f(xs, u, c, stage_drag(g, 2), k);                    // k3
  for (int j = 0; j < NX; ++j) { acc[j] = fma(two, k[j], acc[j]); xs[j] = fma(c.h, k[j], x[j]); }
  model_f(xs, u, c, stage_drag(g, 3), k);                    // k4
  for (int j = 0; j < NX; ++j) x[j] = fma(c.h6, acc[j] + k[j], x[j]);
}

// One (stage, tangent) item: from the node x0 (13) and the control u0 (4),
// x+ of the RK4 step in x[j].v and row i of its tangents J = d x+ / d (x, u)
// in x[j].d.  The caller writes them out (after the step, so no output
// pointer stays live across it).
template <typename T, typename G>
MPCQ_HD void lin_item(const T* x0, const T* u0, const G& g, int i, const ModelConsts<T>& c,
                      Dual<T>* x) {
  Dual<T> u[NU];
  for (int j = 0; j < NX; ++j) x[j] = {x0[j], T(j == i ? 1 : 0)};
  for (int a = 0; a < NU; ++a) u[a] = {u0[a], T(NX + a == i ? 1 : 0)};
  rk4(x, u, c, g);
}

// Row i of the tangents alone, where the drag G puts a recorded value in
// place of every value the derivatives read (the tangent pass): the
// items' values start at 0 and are dropped.
template <typename T, typename G>
MPCQ_HD void tangent_item(const G& g, int i, const ModelConsts<T>& c, Dual<T>* x) {
  Dual<T> u[NU];
  for (int j = 0; j < NX; ++j) x[j] = {T(0), T(j == i ? 1 : 0)};
  for (int a = 0; a < NU; ++a) u[a] = {T(0), T(NX + a == i ? 1 : 0)};
  rk4(x, u, c, g);
}

// The primal step alone: x+ of the RK4 step from the node x0 and the
// control u0, the values lin_item computes.
template <typename T, typename G>
MPCQ_HD void step_item(const T* x0, const T* u0, const G& g, const ModelConsts<T>& c,
                       Val<T>* x) {
  Val<T> u[NU];
  for (int j = 0; j < NX; ++j) x[j] = {x0[j]};
  for (int a = 0; a < NU; ++a) u[a] = {u0[a]};
  rk4(x, u, c, g);
}

// ---- the primal once, recorded; the tangents on the record (kernels A, F) ----
//
// What a tangent reads besides its own derivatives, recorded by the primal
// step of its column (`anchor`: each RK4 stage's q, v and w, and a_m; the
// drag's means m and their Jacobian diagonal jd at each stage, the JAX
// custom-JVP rule): R_FIELDS values a column.  Field f of a column's record
// lies at rec[f * FS]: kernel A keeps a tile's columns side by side (FS =
// its tile width), kernel F a column's fields together (FS = 1).
constexpr int R_LEAF = 0;                  // stages 0-3: x[3..12] (q, v, w), 10 a stage
constexpr int R_AM = 40;                   // a_m, the same at every stage
constexpr int R_DRAG = 41;                 // stages 0-3: m (3), then jd (3)
constexpr int R_FIELDS = R_DRAG + 4 * 6;

MPCQ_HD int leaf_field(int s, int slot) { return R_LEAF + 10 * s + slot - 3; }
MPCQ_HD int drag_field(int s, int a) { return R_DRAG + 6 * s + a; }

// The primal pass's drag: the scenario's DragView; stage s records into the
// column's record rec.
template <typename T, int FS> struct RecordPrimal {
  DragView<T> g;
  T* rec;
};
template <typename T, int FS> struct RecordStage {
  DragView<T> g;
  T* rec;
  int s, nb;
};
template <typename T, int FS>
MPCQ_HD RecordStage<T, FS> stage_drag(const RecordPrimal<T, FS>& r, int s) {
  return {r.g, r.rec, s, r.g.nb};
}
// each axis's mean and Jdiag (drag_sums, as a DragView's dual mean), recorded
template <typename T, int FS>
MPCQ_HD void drag_means(const Val<T>* vb, const RecordStage<T, FS>& r, Val<T>* m) {
  for (int a = 0; a < 3; ++a) {
    T jd;
    drag_sums(vb[a].v, r.g, a, m[a].v, jd);
    r.rec[drag_field(r.s, a) * FS] = m[a].v;
    r.rec[drag_field(r.s, 3 + a) * FS] = jd;
  }
}
template <typename T, int FS>
MPCQ_HD Val<T> anchor(const RecordStage<T, FS>& r, Val<T> v, int slot) {
  if (slot != ANCHOR_AM)
    r.rec[leaf_field(r.s, slot) * FS] = v.v;
  else if (r.s == 0)
    r.rec[R_AM * FS] = v.v;
  return v;
}

// The tangent pass's drag: stage s's recorded values in place of the duals'
// values, the drag's tangent Jdiag * dvb (the product the dual mean forms).
template <typename T, int FS> struct Recorded {
  const T* rec;
  int nb;
};
template <typename T, int FS> struct RecordedStage {
  const T* rec;
  int s, nb;
};
template <typename T, int FS>
MPCQ_HD RecordedStage<T, FS> stage_drag(const Recorded<T, FS>& r, int s) {
  return {r.rec, s, r.nb};
}
template <typename T, int FS>
MPCQ_HD void drag_means(const Dual<T>* vb, const RecordedStage<T, FS>& r, Dual<T>* m) {
  MPCQ_UNROLL
  for (int a = 0; a < 3; ++a)
    m[a] = {r.rec[drag_field(r.s, a) * FS],
            rn_mul(r.rec[drag_field(r.s, 3 + a) * FS], vb[a].d)};
}
template <typename T, int FS>
MPCQ_HD Dual<T> anchor(const RecordedStage<T, FS>& r, Dual<T> v, int slot) {
  return {r.rec[(slot == ANCHOR_AM ? R_AM : leaf_field(r.s, slot)) * FS], v.d};
}

}  // namespace mpcq
