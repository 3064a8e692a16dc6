// Kernel C: the Riccati-factorised box-constrained interior point of the
// long-horizon OCP, one scenario per warp.
//
// Replaces mpc_quad_ros_tpu/ops/pallas/riccati_kernel.py::_riccati_ipm_kernel.
// Per scenario b, from the linearisation J (N, 17, 13) (row j of stage k =
// column j of [A_k | B_k], so A_k^T[c][j] = J[k][c][j]), the defects c, dx0,
// the linear costs qlin (N, 13), rlin (N, 4), plin (13) and the box
// lb <= du <= ub (N, 4):
//
// - cold start: du at the box midpoint, unit duals; dX the affine rollout of
//   du (defects included);
// - exactly `iters` iterations of
//   mu = 0.1 (sl.zl + su.zu) / (2 N nu);
//   dbar = zl/sl + zu/su,  rhat = rd du + rlin - zl + zu - (mu - sl zl)/sl
//                                 + (mu - su zu)/su;
//   the backward sweep from P = diag(pt), p = pt dX_N + plin, contracting
//   over J's columns: W = J [P | p] (A^T P, B^T P, A^T p, B^T p), M = J W^T
//   (A^T P A, S = B^T P A, B^T P B), G = sym(B^T P B) + diag(rd + dbar_k),
//   rhs2 = rhat_k + B^T p; a 4x4 Cholesky of G with pivots
//   sqrt(max(., 1e-12)) solves [K | kff] jointly; P = diag(q) + sym(A^T P A)
//   - sym(S^T K), p = q dX_k + qlin_k + A^T p - K^T rhs2 (sym(X) = 0.5 (X +
//   X^T) of the accumulated product);
//   the forward Newton pass ddu_k = -kff_k - K_k ddx_k, ddx_{k+1} = A_k ddx_k
//   + B_k ddu_k from ddx_0 = 0; the dual steps and the fraction-to-the-
//   boundary step alpha (0.995); slack floor 1e-10 max(width, 1), dual floor
//   1e-12; du += alpha ddu and dX = rollout(du) + alpha ddx, the rollout of
//   the new du (it is affine in du, and du is not clipped inside the loop),
//   the rollout of the current du formed in the forward pass;
// - du = clip(du, lb, ub) and dX its rollout.
//
// Inputs (contiguous f32): J (B, N, 17, 13), c (B, N, 13), dx0 (B, 13),
// qlin (B, N, 13), rlin (B, N, 4), plin (B, 13), lb, ub (B, N, 4); weights
// q (13), pt (13), rd (4).  Outputs: du (B, N, 4), dX (B, N+1, 13).  Scratch
// in device memory, allocated by the caller (16-byte aligned,
// scratch_size(N) floats a scenario): -[K_k^T | kff_k], the sweep's
// per-stage terms and the forward pass's ddx_{k+1}.
//
// What bounds it on the H100: a stage of the sweep is ~7,500 multiply-adds
// in two dependent 13-deep products, a 4x4 factorisation and a symmetric
// update, four warp syncs apart, serial in N; the forward pass's stages
// are short dependent chains.  Fed from two scalar shared-memory loads a
// FMA (8 B against the SM's 1 B a FMA lane), the products would be bound by
// the shared memory; here they take one 16-byte load for 12 FMAs, and the
// kernel is bound by its instruction issue (~830 a sweep
// stage and ~240 a forward stage on one warp; the products' 312 FMAs use
// 66 % of their lanes, the rest is the solve, the update of P, addressing
// and the streams) and by the chains that its resident warps do not hide:
// 20 an SM, held by the registers (96 a lane, no spill; a sub-partition's
// 16,384 hold five warps of 96; at 80 registers 23 warps fit, as many as
// the workspace allows, but the registers spill and the kernel is slower).  J (221 floats a stage) is read twice an iteration
// (sweep, forward pass) and twice more in all (the first and the final
// rollout): 26 passes, ~60 GB at B=65536, N=40, 12 iterations, ~18 ms of
// HBM time, overlapped; the sweep and the forward pass walk J in opposite
// directions, so each turn finds the latest stages in L2.
//
// Design: one block of one warp per scenario.
// - The sweep's products run as register tiles: lane t < 30 holds rows
//   3 g .. 3 g + 2 of J_k (g = t / 5; 39 registers, loaded once a stage) and
//   owns output columns 4 q .. 4 q + 3 (q = t % 5) of both W = J [P | p] and
//   M = J W^T; each step of the 13-term sums is one 16-byte broadcast load of
//   [P | p] (row stride 16) or of W^T (row stride 20) feeding 12 FMAs.  Each
//   output is still one sum over j = 0 .. 12 in order.
// - W^T (its row 13 is J p: A^T p, B^T p) goes to shared memory in full, so
//   its stores need no test; M (A^T P A, S, G) is stored where J_k was (the
//   rows are in registers by then), in 16-byte rows.
// - G is symmetrised and factored in registers by every lane at once (one
//   instruction stream, 4 rsqrt pivots as ipm_box.cuh's factor, no
//   division); lanes 0-12 solve K's columns and lane 13 kff, each storing
//   its column as one 16-byte store, and lanes 0-12 also form p's entries;
//   S^T and K^T go to shared memory as 16-byte columns for the update of P,
//   which walks P's lower triangle (91 entries, three rounds of the warp,
//   each lane's entries coded in shared memory) and writes both halves.
// - rd + dbar_k, rhat_k and q dX_k + qlin_k are formed once an iteration
//   for every stage, off the sweep's chain (rhat where ddu lives until the
//   forward pass, the others in the scratch, streamed with J_k).
// - The forward pass: lanes 0-12 sum A_k ddx_k while lanes 13-16 sum d =
//   -kff_k - K_k ddx_k (the same 13 steps, one stream of instructions; the
//   scratch holds -K and -kff), then lanes 0-12 add B_k d; ddx_{k+1} goes to
//   the scratch.
// - No rollout pass inside the loop: the forward pass rolls the current du
//   out again beside ddx (lanes 0-12, J_k already in shared memory, c_k
//   loaded a stage ahead), and once alpha is known dX += alpha ddx.
// J streams from device memory by cp.async in 16-byte copies of the quads
// that hold each stage: in the sweep one stage ahead in two slots (with
// the stage's terms); in the forward pass (with -[K_k^T | kff_k]) and the
// rollouts, whose stages are short, two stages ahead in three, the third
// where the sweep keeps [P | p] and W^T.  The weights live in shared memory
// and no array is indexed at run time.  Shared memory: 24 N + 1312 floats
// (9,088 B at N = 40, room for 23 warps an SM; 20,608 B at N = 160); the
// launch bound asks the registers for 20 blocks an SM.  Nothing is reduced
// across blocks, so a NaN in one scenario leaves every other scenario
// bitwise unchanged.

#include "common.cuh"

namespace mpcq {
namespace ric {

constexpr int NX = 13, NU = 4, NT = 17;
constexpr int J_REC = NT * NX;        // one stage of J
constexpr int K_REC = NU * NX + NU;   // one stage of -[K^T | kff]
// The sweep's register tiles: lane t < TILES holds TILE_ROWS rows of J (the
// last group's third row repeats row 16) and owns four output columns.
constexpr int TILE_ROWS = 3, TILE_QUADS = 5, TILES = 6 * TILE_QUADS;
constexpr int LDP = 16;               // row stride of [P | p] (13 rows)
constexpr int LDW = 20;               // row stride of W^T (13 rows) and of M (17 rows)
constexpr int BT_ROWS = 16;           // W^T's rows: W's columns 0-15 (13: J p)
constexpr int AUX_REC = 20;           // a stage's rd + dbar_k, q dX_k + qlin_k (scratch; 3 pad)
constexpr int AUX_OFF = NT * LDW;     // where the sweep's slot holds them, after M
constexpr int J_SPAN = 224;           // J_k's quads in a slot (221 floats and up to 3 before)
constexpr int SLOT = 360;             // a stream slot: J_k [and -K_k^T, -kff_k], or M and a stage's terms
constexpr int XB = 16;                // one recurrence vector of the passes
constexpr int NW = 32;                // the weights q, pt, rd
constexpr int NPC = 32;               // the lanes' codes of P's entries (4 a code word)
constexpr int kPerStage = 6 * NU;     // du, sl, su, zl, zu, ddu (rhat in the sweep)
constexpr int kFixed = NX * LDP + BT_ROWS * LDW + 2 * SLOT + NW + NPC;
// J_k fills at most (3 + 221 + 3) / 4 quads of its slot; the scratch's
// records are whole quads
static_assert(J_SPAN == 4 * ((6 + J_REC) / 4) && AUX_OFF + AUX_REC <= SLOT &&
              J_SPAN + K_REC <= SLOT && K_REC % 4 == 0 && AUX_REC % 4 == 0 &&
              NU + NX <= AUX_REC && SLOT % 4 == 0, "stream slot");
// the passes' third slot and their two vectors where [P | p] and W^T are in the sweep
static_assert(2 * NU * NX <= NX * LDW && SLOT + 4 * XB <= NX * LDP + BT_ROWS * LDW,
              "the passes' slot");
// Resident blocks an SM asked of the compiler: 20, which gives a lane 96
// registers (a sub-partition's 16,384 hold five warps of 96, six of 80); at
// 23 blocks, all the workspace allows at N = 40, 80 registers spill.
constexpr int MIN_BLOCKS = 20;

template <typename T> struct Weights { T q[NX], pt[NX], rd[NU]; };

template <typename T> Weights<T> weights_from(const T* w) {
  Weights<T> out;
  for (int i = 0; i < NX; ++i) { out.q[i] = w[i]; out.pt[i] = w[NX + i]; }
  for (int a = 0; a < NU; ++a) out.rd[a] = w[2 * NX + a];
  return out;
}

// Shared workspace and device scratch of one scenario, in elements of T.
MPCQ_HD int64_t ws_size(int N) { return int64_t(N) * kPerStage + kFixed; }
// The scratch: -[K_k^T | kff_k] by stages (K^T by columns, then kff), the
// sweep's per-stage terms, then the forward pass's ddx_{k+1}; a scenario's
// part a whole number of quads, so with a 16-byte-aligned scratch every
// record of the first two is 16-byte aligned.
MPCQ_HD int64_t scratch_size(int N) { return (int64_t(N) * (K_REC + AUX_REC + NX) + 3) / 4 * 4; }

MPCQ_HD int min_int(int a, int b) { return a < b ? a : b; }

// Four consecutive elements of shared memory (16-byte aligned): one 16-byte
// load on the card.
template <typename T> MPCQ_HD Quad<T> lds4(const T* p) { return {{p[0], p[1], p[2], p[3]}}; }
#if defined(__CUDA_ARCH__)
MPCQ_HD Quad<float> lds4(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
}
#endif

// Stage records streamed from device memory through S shared slots by
// cp.async in 16-byte copies (condense.cuh's StreamedJ, in either
// direction), S - 1 records ahead: record k is J_k (jrec, from the slot's
// start, past its quad_lag, which follows from stage 0's), followed, when
// N2 > 0, by the second array's 16-byte-aligned record k of N2 elements at
// OFF2 (rec2).  Slots 0 and 1 are contiguous at buf, slot 2 at third; the
// callers keep record k's slot index, r = k % S.
template <typename T, int S, int N2 = 0, int OFF2 = 0> struct Stream {
  const T* J;
  const T* R2;
  T* buf;
  T* third;
  MPCQ_HD T* at(int r) const { return S == 3 && r == 2 ? third : buf + r * SLOT; }
  MPCQ_HD int jlag(int k) const { return (quad_lag(J) + k * J_REC) & 3; }
  MPCQ_HD T* jrec(int k, int r) const { return at(r) + jlag(k); }
  MPCQ_HD T* rec2(int r) const { return at(r) + OFF2; }
  // Starts record k's copy into slot r (one commit group).
  template <typename Team> MPCQ_HD void start(const Team& tm, int k, int r) const {
    T* dst = at(r);
    tm.template copy_async_quads<J_REC>(dst, J + k * J_REC, jlag(k));
    if constexpr (N2 > 0) tm.template copy_async_quads<N2>(dst + OFF2, R2 + k * N2, 0);
    tm.commit_async();
  }
  // Waits for the oldest record in flight (with one later record still in
  // flight when `ahead`) and syncs.
  template <typename Team> MPCQ_HD void wait(const Team& tm, bool ahead) const {
    if (ahead)
      tm.template wait_async<1>();
    else
      tm.template wait_async<0>();
  }
};

// The next slot index of a walk over S slots.
template <int S> MPCQ_HD int next_slot(int r) { return r + 1 == S ? 0 : r + 1; }

// A lane's entries (c1, c2) of P's lower triangle, 8 bits each, four to a
// word in shared memory (a word a lane on the card's warp), so that no
// register holds them through the iterations.
struct Pairs {
  unsigned* v;                // the lane's words
  MPCQ_HD void clear(int words) const { for (int w = 0; w < words; ++w) v[w] = 0; }
  MPCQ_HD void set(int s, int c1, int c2) const {
    v[s / 4] |= unsigned(c1 * 16 + c2) << (8 * (s % 4));
  }
  MPCQ_HD unsigned code(int s) const { return (v[s / 4] >> (8 * (s % 4))) & 255u; }
};

// Register slots a lane of the team needs for `items` items a pass (one on
// the card's warp, every item on the serial lane).
template <typename Team> MPCQ_HD constexpr int slots_for(int items) {
  return (items + Team::size - 1) / Team::size;
}

// acc[i][t] = sum_j a[i][j] b[j ldb + t], j = 0 .. 12 in order: one 16-byte
// load of b's row feeds TILE_ROWS x 4 multiply-adds.
template <typename T>
MPCQ_HD void tile_product(const T (&a)[TILE_ROWS][NX], const T* b, int ldb,
                          T (&acc)[TILE_ROWS][4]) {
  Quad<T> v = lds4(b);
  MPCQ_UNROLL
  for (int i = 0; i < TILE_ROWS; ++i)
    MPCQ_UNROLL
    for (int t = 0; t < 4; ++t) acc[i][t] = a[i][0] * v.v[t];
  MPCQ_UNROLL
  for (int j = 1; j < NX; ++j) {
    v = lds4(b + j * ldb);
    MPCQ_UNROLL
    for (int i = 0; i < TILE_ROWS; ++i)
      MPCQ_UNROLL
      for (int t = 0; t < 4; ++t) acc[i][t] = acc[i][t] + a[i][j] * v.v[t];
  }
}

// dX_0 = dx0, dX_{k+1} = c_k + A_k dX_k + B_k du_k into dX (device memory),
// the recurrence through the two vectors xb; J streamed two stages ahead.
template <typename T, typename Team>
MPCQ_HD void rollout(const Team& tm, int N, const Stream<T, 3>& js, const T* c, const T* dx0,
                     const T* du, T* xb, T* dX) {
  const int ln = tm.lane, NL = Team::size;
  js.start(tm, 0, 0);
  if (N > 1) js.start(tm, 1, 1);
  for (int r = ln; r < NX; r += NL) {
    xb[r] = dx0[r];
    dX[r] = dx0[r];
  }
  for (int k = 0, sk = 0, sn = 2; k < N; ++k, sk = next_slot<3>(sk), sn = next_slot<3>(sn)) {
    js.wait(tm, k + 1 < N);
    if (k + 2 < N) js.start(tm, k + 2, sn);
    const T* Jk = js.jrec(k, sk);
    const T* x = xb + (k & 1) * XB;
    for (int r = ln; r < NX; r += NL) {
      T acc = c[k * NX + r];
      for (int j = 0; j < NX; ++j) acc = acc + Jk[j * NX + r] * x[j];
      for (int a = 0; a < NU; ++a) acc = acc + Jk[(NX + a) * NX + r] * du[k * NU + a];
      xb[((k + 1) & 1) * XB + r] = acc;
      dX[(k + 1) * NX + r] = acc;
    }
  }
  tm.sync();
}

// The lower Cholesky factor L of the 4x4 system of one stage (pivots
// sqrt(max(., 1e-12)); L's strict lower part and the pivots' reciprocals in
// inv, from one rsqrt each, as ipm_box.cuh's factor), G symmetrised from the
// product M's rows 13-16, columns 13-16, plus diag(gd).
template <typename T>
MPCQ_HD void factor_G(const T* Gm, const T* gd, T (&L)[NU][NU], T (&inv)[NU]) {
  T g[NU][NU];
  for (int a = 0; a < NU; ++a)
    for (int b = 0; b < NU; ++b) g[a][b] = T(0.5) * (Gm[a * LDW + b] + Gm[b * LDW + a]);
  for (int a = 0; a < NU; ++a) g[a][a] = g[a][a] + gd[a];
  MPCQ_UNROLL
  for (int jc = 0; jc < NU; ++jc) {          // left-looking
    T col[NU];
    MPCQ_UNROLL
    for (int i = jc; i < NU; ++i) col[i] = g[i][jc];
    MPCQ_UNROLL
    for (int kk = 0; kk < jc; ++kk)
      MPCQ_UNROLL
      for (int i = jc; i < NU; ++i) col[i] = col[i] - L[i][kk] * L[jc][kk];
    inv[jc] = m_rsqrt(floor_at(col[jc], T(1e-12)));
    MPCQ_UNROLL
    for (int i = jc + 1; i < NU; ++i) L[i][jc] = col[i] * inv[jc];
  }
}

// z = G^{-1} y from the factor: L w = y, then L^T z = w.
template <typename T>
MPCQ_HD void solve_G(const T (&L)[NU][NU], const T (&inv)[NU], const T (&y)[NU], T (&z)[NU]) {
  T w[NU];
  MPCQ_UNROLL
  for (int jc = 0; jc < NU; ++jc) {
    T v = y[jc];
    MPCQ_UNROLL
    for (int kk = 0; kk < jc; ++kk) v = v - L[jc][kk] * w[kk];
    w[jc] = v * inv[jc];
  }
  MPCQ_UNROLL
  for (int jc = NU - 1; jc >= 0; --jc) {
    T v = w[jc];
    MPCQ_UNROLL
    for (int kk = jc + 1; kk < NU; ++kk) v = v - L[kk][jc] * z[kk];
    z[jc] = v * inv[jc];
  }
}

template <typename T, typename Team>
MPCQ_HD void riccati_ipm_scenario(const Team& tm, int N, int iters, const Weights<T>& wts,
                                  const T* J, const T* c, const T* dx0, const T* qlin,
                                  const T* rlin, const T* plin, const T* lbg, const T* ubg,
                                  T* ws, T* Ks, T* du_out, T* dX) {
  const int ln = tm.lane, NL = Team::size, nv = N * NU;
  constexpr int RT = slots_for<Team>(TILES), RF = slots_for<Team>(NT);
  constexpr int RS = slots_for<Team>(NX + 1), RP = slots_for<Team>(NX * (NX + 1) / 2);

  T* w = ws;
  T* du = w;   w += nv;
  T* sl = w;   w += nv;
  T* su = w;   w += nv;
  T* zl = w;   w += nv;
  T* zu = w;   w += nv;
  T* ddu = w;  w += nv;       // rhat_k in the sweep; ddu from the forward pass
  T* X = w;    w += NX * LDP; // [P | p]; columns 14-15 pad
  T* BT = w;   w += BT_ROWS * LDW;  // W^T (row 13: J p); then S^T and K^T by columns
  T* buf = w;  w += 2 * SLOT; // two stream slots
  T* wq = w;   w += NW;       // the weights: q, pt, rd
  const Pairs pairs{reinterpret_cast<unsigned*>(w) + ln * ((RP + 3) / 4)};
  T* const wpt = wq + NX;
  T* const wrd = wq + 2 * NX;
  T* const rhat = ddu;
  T* const ST = BT;
  T* const KT = BT + NU * NX;
  T* const xb = X + SLOT;     // the passes' vectors, past their third slot
  T* const xr = xb + 2 * XB;  // the forward pass's rollout of du
  T* const Jp = BT + NX * LDW;                // A^T p, B^T p
  T* const aux = Ks + int64_t(N) * K_REC;     // rd + dbar_k, q dX_k + qlin_k
  T* const ddx = aux + int64_t(N) * AUX_REC;
  // the sweep: J_k and aux_k one stage ahead in two slots; the passes: J_k
  // (and [K_k | kff_k]) two stages ahead in three
  const Stream<T, 2, AUX_REC, AUX_OFF> js{J, aux, buf, nullptr};
  const Stream<T, 3> jr3{J, nullptr, buf, X};
  const Stream<T, 3, K_REC, J_SPAN> jks{J, Ks, buf, X};

  static_assert(Team::size * ((RP + 3) / 4) <= NPC, "the pair codes' words");
  {
    pairs.clear((RP + 3) / 4);
    TriWalk e(ln);
    for (int s = 0; s < RP; ++s, e.advance(NL)) pairs.set(s, e.a % 16, e.c);
  }
  if (ln == 0) {               // constant indices: read in place, not copied to the stack
    MPCQ_UNROLL
    for (int i = 0; i < NX; ++i) {
      wq[i] = wts.q[i];
      wpt[i] = wts.pt[i];
    }
    MPCQ_UNROLL
    for (int a = 0; a < NU; ++a) wrd[a] = wts.rd[a];
  }
  // ---- cold start ----
  for (int i = ln; i < nv; i += NL) {
    T l = lbg[i], u = ubg[i], d = T(0.5) * (l + u);
    du[i] = d;
    zl[i] = T(1);
    zu[i] = T(1);
    sl[i] = d - l;
    su[i] = u - d;
  }
  tm.sync();
  if (iters > 0) rollout(tm, N, jr3, c, dx0, du, xb, dX);

  for (int it = 0; it < iters; ++it) {
    T pl = T(0), pu = T(0);
    for (int i = ln; i < nv; i += NL) {
      pl = pl + sl[i] * zl[i];
      pu = pu + su[i] * zu[i];
    }
    const T mu = T(0.1) * ((tm.sum(pl) + tm.sum(pu)) / T(2 * nv));

    // the sweep's per-stage terms, off its chain; these two loops walk from
    // li, which the compiler reads again each iteration instead of keeping
    // their lanes' addresses in registers (which spilled)
    const int li = tm.lane_again();
    for (int i = li; i < nv; i += NL) {
      const int a = i % NU;
      T s1 = sl[i], s2 = su[i], y1 = zl[i], y2 = zu[i];
      aux[(i / NU) * AUX_REC + a] = wrd[a] + (y1 / s1 + y2 / s2);
      rhat[i] = wrd[a] * du[i] + rlin[i] - y1 + y2 - (mu - s1 * y1) / s1 +
                (mu - s2 * y2) / s2;
    }
    for (int e = li; e < N * NX; e += NL) {
      const int k = e / NX, r = e % NX;
      aux[k * AUX_REC + NU + r] = wq[r] * dX[e] + qlin[e];
    }
    for (int e = ln; e < NX * LDP; e += NL) {
      const int j = e / LDP, i = e % LDP;
      X[e] = i == NX ? wpt[j] * dX[N * NX + j] + plin[j] : (i == j ? wpt[j] : T(0));
    }

    // ---- backward Riccati sweep ----
    tm.sync();                                // aux is written
    js.start(tm, N - 1, (N - 1) & 1);
    for (int k = N - 1; k >= 0; --k) {
      js.wait(tm, false);
      if (k > 0) js.start(tm, k - 1, (k - 1) & 1);
      const T* Jk = js.jrec(k, k & 1);
      T* M = js.at(k & 1);                    // the products, once J_k is in registers
      const T* auxk = js.rec2(k & 1);         // rd + dbar_k, q dX_k + qlin_k
      T jr[RT][TILE_ROWS][NX];
      // W = J [P | p]: W^T and J p
      for (int s = 0; s < RT; ++s) {
        const int t = ln + s * NL;
        if (t >= TILES) break;
        const int g = t / TILE_QUADS, q = t % TILE_QUADS;
        MPCQ_UNROLL
        for (int i = 0; i < TILE_ROWS; ++i) {
          const int r = min_int(TILE_ROWS * g + i, NT - 1);
          MPCQ_UNROLL
          for (int j = 0; j < NX; ++j) jr[s][i][j] = Jk[r * NX + j];
        }
        T acc[TILE_ROWS][4];
        tile_product(jr[s], X + 4 * min_int(q, 3), LDP, acc);
        if (q < 4) {                          // W's columns 0-15, rows 0-17, all kept
          T* bt = BT + 4 * q * LDW + TILE_ROWS * g;
          MPCQ_UNROLL
          for (int i = 0; i < TILE_ROWS; ++i)
            MPCQ_UNROLL
            for (int u = 0; u < 4; ++u) bt[u * LDW + i] = acc[i][u];
        }
      }
      tm.sync();
      // M = J W^T: A^T P A (rows 0-12), S and G (rows 13-16) where J_k was
      for (int s = 0; s < RT; ++s) {
        const int t = ln + s * NL;
        if (t >= TILES) break;
        const int g = t / TILE_QUADS, q = t % TILE_QUADS;
        T acc[TILE_ROWS][4];
        tile_product(jr[s], BT + 4 * q, LDW, acc);
        MPCQ_UNROLL
        for (int i = 0; i < TILE_ROWS; ++i)
          if (TILE_ROWS * g + i < NT)
            store4(M + (TILE_ROWS * g + i) * LDW + 4 * q, acc[i][0], acc[i][1], acc[i][2],
                   acc[i][3]);
      }
      tm.sync();
      // [K | kff]: G factored by every lane, column m of S (m < 13) or rhs2
      // (m = 13) solved by lane m; p by lanes 0-12
      {
        const T* Gm = M + NX * LDW;           // rows 13-16: S (columns 0-12), G (13-16)
        T L[NU][NU], inv[NU], rhs2[NU];
        factor_G(Gm + NX, auxk, L, inv);
        for (int a = 0; a < NU; ++a) rhs2[a] = rhat[k * NU + a] + Jp[NX + a];
        for (int s = 0; s < RS; ++s) {
          const int m = ln + s * NL;
          if (m > NX) break;
          const bool col = m < NX;
          const int mc = min_int(m, NX - 1);
          T y[NU], z[NU];
          for (int a = 0; a < NU; ++a) y[a] = col ? Gm[a * LDW + mc] : rhs2[a];
          solve_G(L, inv, y, z);
          store4(Ks + k * K_REC + NU * m, -z[0], -z[1], -z[2], -z[3]);  // -K^T column m, -kff
          if (col) {
            store4(ST + NU * m, y[0], y[1], y[2], y[3]);
            store4(KT + NU * m, z[0], z[1], z[2], z[3]);
            T acc = auxk[NU + m] + Jp[m];
            for (int a = 0; a < NU; ++a) acc = acc - z[a] * rhs2[a];
            X[m * LDP + NX] = acc;
          }
        }
      }
      tm.sync();
      // P = diag(q) + sym(A^T P A) - sym(S^T K), both halves of each entry
      MPCQ_UNROLL
      for (int s = 0; s < RP; ++s) {
        if (ln + s * NL >= NX * (NX + 1) / 2) break;
        const unsigned pc = pairs.code(s);
        const int c1 = int(pc >> 4), c2 = int(pc & 15u);
        const Quad<T> s1 = lds4(ST + NU * c1), k2 = lds4(KT + NU * c2);
        const Quad<T> s2 = lds4(ST + NU * c2), k1 = lds4(KT + NU * c1);
        T u12 = s1.v[0] * k2.v[0], u21 = s2.v[0] * k1.v[0];
        for (int a = 1; a < NU; ++a) {
          u12 = u12 + s1.v[a] * k2.v[a];
          u21 = u21 + s2.v[a] * k1.v[a];
        }
        const T diag = c1 == c2 ? wq[c1] : T(0);
        const T v = (diag + T(0.5) * (M[c1 * LDW + c2] + M[c2 * LDW + c1])) - T(0.5) * (u12 + u21);
        X[c1 * LDP + c2] = v;
        X[c2 * LDP + c1] = v;
      }
    }
    tm.sync();

    // ---- forward Newton pass, ddx_0 = 0, no defects; J and [K | kff] streamed ----
    // Lanes 0-12 also roll the current du out again beside ddx, from the
    // J_k already in shared memory, into dX: the update below then adds to
    // dX only this iteration's alpha ddx, so dX stays the rollout of the
    // rounded du to within one step's rounding (alpha ddx summed over the
    // iterations drifts from it, and du's error grows with N).
    jks.start(tm, 0, 0);
    if (N > 1) jks.start(tm, 1, 1);
    T cn[RF];                                 // c_k, loaded a stage ahead
    for (int s = 0; s < RF; ++s) cn[s] = c[min_int(ln + s * NL, NX - 1)];
    for (int r = ln; r < NX; r += NL) {
      xb[r] = T(0);
      xr[r] = dx0[r];
    }
    for (int k = 0, sk = 0, sn = 2; k < N; ++k, sk = next_slot<3>(sk), sn = next_slot<3>(sn)) {
      jks.wait(tm, k + 1 < N);
      if (k + 2 < N) jks.start(tm, k + 2, sn);
      const T* Jk = jks.jrec(k, sk);
      const T* Kk = jks.rec2(sk);             // -K_k^T by columns, then -kff_k
      const T* xk = xr + (k & 1) * XB;
      T x[XB];
      for (int q = 0; q < XB / 4; ++q) {
        const Quad<T> v = lds4(xb + (k & 1) * XB + 4 * q);
        for (int t = 0; t < 4; ++t) x[4 * q + t] = v.v[t];
      }
      T acc[RF];
      // lanes 0-12: (A_k ddx_k)_o and the rollout's (c_k + A_k dX_k +
      // B_k du_k)_o; lanes 13-16: d_a = -kff_a - (K_k ddx_k)_a (the scratch
      // holds -K and -kff)
      for (int s = 0; s < RF; ++s) {
        const int o = ln + s * NL;
        if (o >= NT) break;
        const bool ax = o < NX;
        const T* row = ax ? Jk + o : Kk + (o - NX);
        const int step = ax ? NX : NU;
        T v = ax ? T(0) : Kk[NU * NX + o - NX];
        MPCQ_UNROLL
        for (int j = 0; j < NX; ++j) v = v + row[j * step] * x[j];
        acc[s] = v;
        if (!ax) ddu[k * NU + o - NX] = v;
        if (ax) {
          T w = cn[s];
          if (k + 1 < N) cn[s] = c[(k + 1) * NX + o];
          for (int j = 0; j < NX; ++j) w = w + Jk[j * NX + o] * xk[j];
          for (int a = 0; a < NU; ++a) w = w + Jk[(NX + a) * NX + o] * du[k * NU + a];
          xr[((k + 1) & 1) * XB + o] = w;
          dX[(k + 1) * NX + o] = w;
        }
      }
      tm.sync();
      for (int s = 0; s < RF; ++s) {
        const int o = ln + s * NL;
        if (o >= NX) break;
        T v = acc[s];
        for (int a = 0; a < NU; ++a) v = v + Jk[(NX + a) * NX + o] * ddu[k * NU + a];
        xb[((k + 1) & 1) * XB + o] = v;
        ddx[k * NX + o] = v;
      }
    }
    tm.sync();

    // ---- dual steps, fraction-to-the-boundary, update ----
    T pmin = T(INFINITY);
    for (int i = ln; i < nv; i += NL) {
      T s1 = sl[i], s2 = su[i], y1 = zl[i], y2 = zu[i], d = ddu[i];
      T dzl = (mu - s1 * y1 - y1 * d) / s1;
      T dzu = (mu - s2 * y2 + y2 * d) / s2;
      pmin = nan_min(pmin, nan_min(nan_min(step_ratio(s1, d), step_ratio(s2, -d)),
                                   nan_min(step_ratio(y1, dzl), step_ratio(y2, dzu))));
    }
    const T alpha = nan_min(T(1), T(0.995) * tm.min(pmin));
    for (int i = ln; i < nv; i += NL) {
      T s1 = sl[i], s2 = su[i], y1 = zl[i], y2 = zu[i], d = ddu[i];
      T dzl = (mu - s1 * y1 - y1 * d) / s1;
      T dzu = (mu - s2 * y2 + y2 * d) / s2;
      T l = lbg[i], u = ubg[i];
      T v = du[i] + alpha * d;
      T eps = T(1e-10) * floor_at(u - l, T(1));
      du[i] = v;
      sl[i] = floor_at(v - l, eps);
      su[i] = floor_at(u - v, eps);
      zl[i] = floor_at(y1 + alpha * dzl, T(1e-12));
      zu[i] = floor_at(y2 + alpha * dzu, T(1e-12));
    }
    for (int e = ln; e < N * NX; e += NL) dX[NX + e] = dX[NX + e] + alpha * ddx[e];
    tm.sync();
  }

  for (int i = ln; i < nv; i += NL) {
    T v = clip(du[i], lbg[i], ubg[i]);
    du[i] = v;
    du_out[i] = v;
  }
  tm.sync();
  rollout(tm, N, jr3, c, dx0, du, xb, dX);
}

}  // namespace ric
}  // namespace mpcq

// Dynamic shared memory of one block of the card's (f32) kernel, and the
// device scratch of one scenario, in bytes.
extern "C" int64_t mpcq_riccati_ws_bytes(int N) {
  return mpcq::ric::ws_size(N) * int64_t(sizeof(float));
}
extern "C" int64_t mpcq_riccati_scratch_bytes(int N) {
  return mpcq::ric::scratch_size(N) * int64_t(sizeof(float));
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

__global__ void __launch_bounds__(32, mpcq::ric::MIN_BLOCKS)
mpcq_riccati_kernel(const float* __restrict__ J, const float* __restrict__ c,
                    const float* __restrict__ dx0, const float* __restrict__ qlin,
                    const float* __restrict__ rlin, const float* __restrict__ plin,
                    const float* __restrict__ lb, const float* __restrict__ ub,
                    float* __restrict__ du, float* __restrict__ dX, float* __restrict__ Ks,
                    int N, int iters, mpcq::ric::Weights<float> wt) {
  using namespace mpcq::ric;
  extern __shared__ __align__(16) float ws[];
  const int64_t b = blockIdx.x;
  mpcq::WarpTeam tm{int(threadIdx.x)};
  riccati_ipm_scenario<float>(
      tm, N, iters, wt, J + b * N * NT * NX, c + b * N * NX, dx0 + b * NX, qlin + b * N * NX,
      rlin + b * N * NU, plin + b * NX, lb + b * N * NU, ub + b * N * NU, ws,
      Ks + b * scratch_size(N), du + b * N * NU, dX + b * (N + 1) * NX);
}

namespace {
mpcq::SmemOnce riccati_smem;   // the shared-memory attributes, once a device
}  // namespace

extern "C" int mpcq_riccati_ipm(const float* J, const float* c, const float* dx0,
                                const float* qlin, const float* rlin, const float* plin,
                                const float* lb, const float* ub, const float* weights,
                                float* du, float* dX, float* scratch, int64_t B, int N,
                                int iters, void* stream) {
  cudaError_t err = riccati_smem(mpcq_riccati_kernel);
  if (err != cudaSuccess) return int(err);
  if (B > 0)
    mpcq_riccati_kernel<<<dim3(unsigned(B)), 32, size_t(mpcq_riccati_ws_bytes(N)),
                          (cudaStream_t)stream>>>(
        J, c, dx0, qlin, rlin, plin, lb, ub, du, dX, scratch, N, iters,
        mpcq::ric::weights_from<float>(weights));
  return int(cudaGetLastError());
}

// Resident blocks (one warp each) per SM at horizon N, from the occupancy API.
extern "C" int mpcq_riccati_occupancy(int N) {
  return mpcq::resident_blocks(mpcq_riccati_kernel, size_t(mpcq_riccati_ws_bytes(N)));
}

#else
#include <vector>

namespace {

// Kernel C on the host: one serial lane (lanes = 1) or a 32-thread team
// that runs the warp's lane split and syncs; scenarios one after another,
// so one scenario's workspace and scratch serve all.
int riccati_host(int lanes, const double* J, const double* c, const double* dx0,
                 const double* qlin, const double* rlin, const double* plin, const double* lb,
                 const double* ub, const double* weights, double* du, double* dX, int64_t B,
                 int N, int iters) {
  using namespace mpcq::ric;
  const Weights<double> wt = weights_from<double>(weights);
  std::vector<double> ws(size_t(ws_size(N))), Ks(size_t(scratch_size(N)));
  return mpcq::run_host_team(lanes, B, [&](const auto& tm, int64_t b) {
    riccati_ipm_scenario<double>(
        tm, N, iters, wt, J + b * N * NT * NX, c + b * N * NX, dx0 + b * NX,
        qlin + b * N * NX, rlin + b * N * NU, plin + b * NX, lb + b * N * NU, ub + b * N * NU,
        ws.data(), Ks.data(), du + b * N * NU, dX + b * (N + 1) * NX);
  });
}

}  // namespace

// Host builds of the same code (f64), for the CPU tests: one serial lane,
// and (host32) 32 threads that run the card's lane split and syncs.
#define MPCQ_RICCATI_ARGS                                                                    \
  const double *J, const double *c, const double *dx0, const double *qlin,                   \
      const double *rlin, const double *plin, const double *lb, const double *ub,            \
      const double *weights, double *du, double *dX, int64_t B, int N, int iters
#define MPCQ_RICCATI_PASS J, c, dx0, qlin, rlin, plin, lb, ub, weights, du, dX, B, N, iters
extern "C" int mpcq_riccati_ipm_host_f64(MPCQ_RICCATI_ARGS) {
  return riccati_host(1, MPCQ_RICCATI_PASS);
}
extern "C" int mpcq_riccati_ipm_host32_f64(MPCQ_RICCATI_ARGS) {
  return riccati_host(32, MPCQ_RICCATI_PASS);
}

#endif
