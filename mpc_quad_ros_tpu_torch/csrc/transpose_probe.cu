// Kernels H and I: the transpose probe — what mirroring a Hessian costs.
//
// Kernel H replaces mpc_quad_ros_tpu/bench/probe_hybrid.py::_mirror_kernel,
// kernel I its baseline ::_elem_kernel.  Per scenario b, on x (B, nz, nz)
// scenario-major, `reps` times with f = 1 + 1e-6 i:
// - H: acc = acc + strict_lower(acc)^T f, i.e. acc[r][c] += acc[c][r] f for
//   c > r; the strict lower triangle never changes;
// - I: acc = acc + strict_lower(acc) f, i.e. acc[r][c] += acc[r][c] f for
//   r > c; the upper triangle and the diagonal never change.
// (The JAX kernels add the masked zeros too; adding nothing leaves the same
// values.)  The difference of the two times over `reps` is one mirror of H,
// the step condense.cuh runs once per solve in kernels B and F.
//
// What bounds both on the H100: bytes, the tiles read and written once (105
// MB each way at B = 16384, nz = 40, twice the L2), so the design keeps HBM
// busy and the passes cheap:
// - persistent warps: a grid sized by the occupancy API, blocks of
//   PROBE_WARPS warps, each warp with its own tile walking scenarios b =
//   warp, warp + W, ... (W warps in the grid);
// - each lane loads its quads of a tile with 16-byte loads, all issued before
//   the first use, into registers; the next scenario's are in flight while
//   the current one runs its passes and its stores;
// - the tile sits in shared memory at ld = nz + 1, the layout of
//   condense_packed that kernels B and F mirror on, and leaves in 16-byte
//   stores;
// - a pass touches only the strict lower triangle's nz (nz - 1) / 2 elements,
//   in a schedule of slots free of bank conflicts (BankWalk): a lane's slot
//   holds the offsets of an element and of its transpose, precomputed once,
//   so a pass does no index arithmetic.  H and I share the schedule, the
//   staging, the block shape and the scenario loop: element (r, c), r > c,
//   is I's target and H's operand, whose target is (c, r).  Each element's
//   chain is the expression acc + operand * f, pass after pass, so the
//   compiler contracts it to the same FFMA as the one-warp kernel before
//   this design did, and the bits are that kernel's.
// Nothing is reduced across warps, so a NaN in one scenario leaves every other
// scenario bitwise unchanged.

#include "common.cuh"

namespace mpcq {

// Warps of a block on the card, each with its own tile (fewer where a block
// cannot hold that many tiles).
constexpr int PROBE_WARPS = 4;
// The quads of the tile a lane keeps in registers, sized for a warp on an
// nz = 40 tile (400 quads, 12.5 a lane).  A larger tile loads its further
// quads in rounds after the first; only the first is prefetched.
constexpr int PROBE_QUADS = 13;
// The slots of the schedule whose words a lane keeps in registers (27 slots
// at nz = 40; see BankWalk); it reads the further ones from its column of
// the slot table.
constexpr int PROBE_HELD = 14;
// The widest tile whose offsets fit 16 bits; the mark of an idle slot.
constexpr int PROBE_NZ_MAX = 252;
constexpr unsigned PROBE_IDLE = 0xffffu;

// Keeps the card's compiler from hoisting work on v out of a loop, where it
// would hold the results in registers.
MPCQ_HD void opaque(int& v) {
#if defined(__CUDA_ARCH__)
  asm volatile("" : "+r"(v));
#else
  (void)v;
#endif
}

// The quads f = f0, f0 + step, ... of a tile with nqr quads a row, in order.
// Quad f (row f / nqr) sits at 4 f + row in the tile at ld = 4 nqr + 1; a step
// is sp rows and so quads, so the walk needs no division after the first.
struct TileQuads {
  int f, row, q;
  MPCQ_HD TileQuads(int f0, int nqr) : f(f0), row(f0 / nqr), q(f0 % nqr) {}
  MPCQ_HD int at() const { return 4 * f + row; }
  MPCQ_HD void advance(int step, int sp, int so, int nqr) {
    f += step;
    row += sp;
    q += so;
    if (q >= nqr) {
      q -= nqr;
      ++row;
    }
  }
  // the walk, recomputed where it is used rather than held
  MPCQ_HD TileQuads fresh() const {
    TileQuads w = *this;
    opaque(w.row);
    opaque(w.q);
    return w;
  }
};

// A lane's share of the strict lower triangle {(r, c): c < r < nz} of the
// tile at ld (odd), in a schedule free of bank conflicts: lane l of nl (a
// power of two) takes the elements at src = r ld + c = l mod nl, one bank of
// I's accesses, and the lanes take the rows in classes r mod k, one class
// after another, k the least power of two with k (ld^2 - 1) = 0 mod nl.  In
// a class the transposed offsets, c ld + r = ld src + r (1 - ld^2) mod nl,
// differ across the lanes too, so H's accesses are free of conflicts as
// well.  A slot of the schedule is one element of every lane that has one
// left in the class: the class takes as many slots as its busiest lane.
struct BankWalk {
  int lane, nl, nz, ld, k, r = 0, c = 0;
  MPCQ_HD BankWalk(int lane_, int nl_, int nz_) : lane(lane_), nl(nl_), nz(nz_), ld(nz_ + 1), k(1) {
    while ((k * (ld * ld - 1)) % nl != 0) k *= 2;
  }
  // the lane's first element of class kc (r >= nz: none)
  MPCQ_HD void start(int kc) {
    r = kc > 0 ? kc : k;
    seek();
  }
  MPCQ_HD void seek() {
    for (; r < nz; r += k) {
      c = (lane - r * ld) & (nl - 1);
      if (c < r) return;
    }
  }
  MPCQ_HD bool live() const { return r < nz; }
  MPCQ_HD void advance() {
    c += nl;
    if (c >= r) {
      r += k;
      seek();
    }
  }
  // the lane's elements in class kc
  MPCQ_HD int count(int kc) {
    int n = 0;
    for (start(kc); live(); advance()) ++n;
    return n;
  }
};

// The schedule's slots for nl lanes: each class's busiest lane's elements.
MPCQ_HD int probe_slots(int nz, int nl) {
  int total = 0;
  for (int kc = 0, k = BankWalk(0, nl, nz).k; kc < k; ++kc) {
    int most = 0;
    for (int l = 0; l < nl; ++l) {
      const int n = BankWalk(l, nl, nz).count(kc);
      most = n > most ? n : most;
    }
    total += most;
  }
  return total;
}

// Words of a team's slot table: a word a lane and slot, for an even count
// of slots (the passes take them two at a time).
MPCQ_HD int probe_table_words(int nz, int nl) { return nl * ((probe_slots(nz, nl) + 1) / 2 * 2); }

// A slot's word: the offsets of the lane's element (r, c), r > c, and of its
// transpose, 16 bits each; I's target is the element itself, H's the
// transpose, with the element its operand.
MPCQ_HD unsigned slot_word(int r, int c, int ld) {
  return unsigned(r * ld + c) | unsigned(c * ld + r) << 16;
}

// One pass's update of the elements of two slots' words.  Both loads come
// before both stores: no element's target is another's operand (H reads the
// strict lower triangle and writes the strict upper one; I's targets are
// distinct), so the order changes no value.  Each element's chain is acc +
// operand * f.  An idle slot loads from `spare` (an offset in the lane's
// bank) and stores nothing, so only the stores are predicated.
template <bool Mirror, typename T>
MPCQ_HD void probe_update(T* ws, const unsigned (&v)[2], int spare, T f) {
  int dst[2];
  bool live[2];
  T acc[2], op[2];
  MPCQ_UNROLL
  for (int g = 0; g < 2; ++g) {
    live[g] = (v[g] & 0xffffu) != PROBE_IDLE;
    const int src = live[g] ? int(v[g] & 0xffffu) : spare;
    dst[g] = Mirror ? (live[g] ? int(v[g] >> 16) : spare) : src;
    acc[g] = ws[dst[g]];
    op[g] = Mirror ? ws[src] : acc[g];
  }
  MPCQ_UNROLL
  for (int g = 0; g < 2; ++g)
    if (live[g]) ws[dst[g]] = acc[g] + op[g] * f;
}

// One persistent warp (team): scenarios first, first + stride, ... of x
// (B, nz, nz) into out, through the tile ws (nz x (nz + 1)) and the slot
// table tab (probe_table_words(nz, size) words).  nz % 4 == 0, nz <=
// PROBE_NZ_MAX.
template <bool Mirror, typename T, typename Team>
MPCQ_HD void transpose_probe_walk(const Team& tm, const T* x, T* out, T* ws, unsigned* tab,
                                  int64_t B, int nz, int reps, int64_t first, int64_t stride) {
  constexpr int NL = Team::size, QR = PROBE_QUADS, NH = PROBE_HELD;
  const int ld = nz + 1, nqr = nz / 4, nq = nz * nqr;
  const int qsp = NL / nqr, qso = NL % nqr;
  const int64_t tile = int64_t(nz) * nz;
  const TileQuads quad0(tm.lane, nqr);
  Quad<T> buf[QR];
  // a round of the lane's quads of tile xb into buf, from w on
  auto load = [&](const T* xb, TileQuads w) {
    MPCQ_UNROLL
    for (int k = 0; k < QR; ++k) {
      if (w.f < nq) buf[k] = load4(xb + 4 * w.f);
      w.advance(NL, qsp, qso, nqr);
    }
  };
  // ... and from buf into the tile; the walk after the round
  auto stage = [&](TileQuads w) {
    MPCQ_UNROLL
    for (int k = 0; k < QR; ++k) {
      if (w.f < nq) {
        T* d = ws + w.at();
        d[0] = buf[k].v[0];
        d[1] = buf[k].v[1];
        d[2] = buf[k].v[2];
        d[3] = buf[k].v[3];
      }
      w.advance(NL, qsp, qso, nqr);
    }
    return w;
  };
  if (first < B) load(x + first * tile, quad0);
  // The lane's column of the slot table, while the first tile is in flight.
  int slots = 0;
  {
    BankWalk bw(tm.lane, NL, nz);
    for (int kc = 0; kc < bw.k; ++kc) {
      const int n = tm.max(bw.count(kc));
      bw.start(kc);
      for (int t = 0; t < n; ++t, ++slots) {
        tab[slots * NL + tm.lane] = bw.live() ? slot_word(bw.r, bw.c, ld) : PROBE_IDLE;
        if (bw.live()) bw.advance();
      }
    }
    if (slots % 2 == 1) tab[slots * NL + tm.lane] = PROBE_IDLE;
  }
  // the first PROBE_HELD slots' words, in registers; what idle slots load:
  // element (0, lane % nz), in the lane's bank where nz > lane
  unsigned held[NH];
  MPCQ_UNROLL
  for (int m = 0; m < NH; ++m) held[m] = m < slots ? tab[m * NL + tm.lane] : PROBE_IDLE;
  const int spare = tm.lane % nz;
  for (int64_t b = first; b < B; b += stride) {
    for (TileQuads w = stage(quad0.fresh()); w.f < nq; w = stage(w)) load(x + b * tile, w);
    tm.sync();
    // the next scenario's first round, in flight during the passes and stores
    if (b + stride < B) load(x + (b + stride) * tile, quad0.fresh());
    for (int i = 0; i < reps; ++i) {
      const T f = T(1.0 + 1e-6 * i);
      MPCQ_UNROLL
      for (int m = 0; m < NH; m += 2) {
        int v0 = int(held[m]), v1 = int(held[m + 1]);
        opaque(v0);
        opaque(v1);
        const unsigned v[2] = {unsigned(v0), unsigned(v1)};
        probe_update<Mirror>(ws, v, spare, f);
      }
      for (int m = NH; m < slots; m += 2) {
        const unsigned v[2] = {tab[m * NL + tm.lane], tab[(m + 1) * NL + tm.lane]};
        probe_update<Mirror>(ws, v, spare, f);
      }
      tm.sync();
    }
    // Each lane stores its own quads and then stages the next scenario's
    // into the same places, so no sync is needed before the staging.
    T* ob = out + b * tile;
    for (TileQuads w = quad0.fresh(); w.f < nq; w.advance(NL, qsp, qso, nqr)) {
      const T* s = ws + w.at();
      store4(ob + 4 * w.f, s[0], s[1], s[2], s[3]);
    }
  }
}

}  // namespace mpcq

// Shared memory of one warp in the card's (f32) kernels, in bytes: its tile
// and its slot table; a block holds up to PROBE_WARPS of them.  0 past
// PROBE_NZ_MAX.
extern "C" int64_t mpcq_transpose_ws_bytes(int nz) {
  if (nz <= 0 || nz > mpcq::PROBE_NZ_MAX) return 0;
  return (int64_t(nz) * (nz + 1) + mpcq::probe_table_words(nz, 32)) * 4;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

// A warp's tile and slot table start `words` words after the previous
// warp's.
template <bool Mirror>
__device__ __forceinline__ void transpose_probe_block(const float* __restrict__ x,
                                                      float* __restrict__ out, int64_t B, int nz,
                                                      int reps, int words) {
  extern __shared__ float smem[];
  const int warp = int(threadIdx.x) / 32, warps = int(blockDim.x) / 32;
  float* ws = smem + warp * words;
  mpcq::transpose_probe_walk<Mirror>(mpcq::WarpTeam{int(threadIdx.x) % 32}, x, out, ws,
                                     reinterpret_cast<unsigned*>(ws + nz * (nz + 1)), B, nz,
                                     reps, int64_t(blockIdx.x) * warps + warp,
                                     int64_t(gridDim.x) * warps);
}

// Four blocks of four warps an SM, at most 128 registers a thread: a lane
// holds a tile's quads and its first slots' words.  (At five blocks, 96
// registers, the compiler spills.)
__global__ void __launch_bounds__(32 * mpcq::PROBE_WARPS, 4)
mpcq_mirror_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t B, int nz,
                   int reps, int words) {
  transpose_probe_block<true>(x, out, B, nz, reps, words);
}

__global__ void __launch_bounds__(32 * mpcq::PROBE_WARPS, 4)
mpcq_elem_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t B, int nz,
                 int reps, int words) {
  transpose_probe_block<false>(x, out, B, nz, reps, words);
}

namespace {

// Warps of a block at nz on the current device: PROBE_WARPS, or as many
// tiles as a block's shared memory holds; 0 if not one, or if nz % 4 != 0
// or nz > PROBE_NZ_MAX.
int probe_block_warps(int nz) {
  int dev = 0, optin = 0;
  if (nz <= 0 || nz % 4 != 0 || nz > mpcq::PROBE_NZ_MAX || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const int64_t fit = optin / mpcq_transpose_ws_bytes(nz);
  return int(fit < mpcq::PROBE_WARPS ? fit : mpcq::PROBE_WARPS);
}

// A kernel's launch shape at the nz and device of its last launch: the
// shared-memory attributes are set once a device (SmemOnce), the resident
// blocks are asked of the occupancy API once a (device, nz).
struct ProbeLaunch {
  mpcq::SmemOnce smem_once;
  int dev = -1, nz = -1, warps = 0;
  int64_t warp_bytes = 0, resident = 0;
};
ProbeLaunch mirror_launch, elem_launch;

template <typename K>
int launch_probe(K kernel, ProbeLaunch& pl, const float* x, float* out, int64_t B, int nz,
                 int reps, void* stream) {
  cudaError_t err = pl.smem_once(kernel);
  if (err != cudaSuccess) return int(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev != pl.dev || nz != pl.nz) {
    const int warps = probe_block_warps(nz);
    const int64_t warp_bytes = mpcq_transpose_ws_bytes(nz);
    int per_sm = 0, sms = 0;
    if (warps < 1) return int(cudaErrorInvalidValue);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps,
                                                        size_t(warps * warp_bytes));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
    pl.dev = dev;
    pl.nz = nz;
    pl.warps = warps;
    pl.warp_bytes = warp_bytes;
    pl.resident = int64_t(per_sm) * sms;
  }
  if (B > 0) {
    const int64_t need = (B + pl.warps - 1) / pl.warps;
    kernel<<<unsigned(need < pl.resident ? need : pl.resident), 32 * pl.warps,
             size_t(pl.warps * pl.warp_bytes), (cudaStream_t)stream>>>(x, out, B, nz, reps,
                                                                       int(pl.warp_bytes / 4));
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int mpcq_mirror(const float* x, float* out, int64_t B, int nz, int reps,
                           void* stream) {
  return launch_probe(mpcq_mirror_kernel, mirror_launch, x, out, B, nz, reps, stream);
}

extern "C" int mpcq_elem(const float* x, float* out, int64_t B, int nz, int reps, void* stream) {
  return launch_probe(mpcq_elem_kernel, elem_launch, x, out, B, nz, reps, stream);
}

// Warps of a block at nz (0 if a tile does not fit a block), and resident
// blocks per SM of kernel H (mirror != 0) or I at that block, from the
// occupancy API.
extern "C" int mpcq_transpose_block_warps(int nz) { return probe_block_warps(nz); }
extern "C" int mpcq_transpose_occupancy(int mirror, int nz) {
  const int warps = probe_block_warps(nz);
  if (warps < 1) return -1;
  const size_t smem = size_t(warps) * size_t(mpcq_transpose_ws_bytes(nz));
  return mirror ? mpcq::resident_blocks(mpcq_mirror_kernel, smem, 32 * warps)
                : mpcq::resident_blocks(mpcq_elem_kernel, smem, 32 * warps);
}

#else
#include <vector>

// Host build of the same code (f64), for the CPU tests: PROBE_WARPS
// persistent warps, one after another, each a serial lane (lanes = 1) or 32
// threads running the warp's lane split (lanes = 32), walking the scenarios
// at the card's stride.  -1 for nz % 4 != 0, nz > PROBE_NZ_MAX or another
// lane count.
static int host_probe(int lanes, const double* x, double* out, int64_t B, int nz, int reps,
                      bool mirror) {
  using namespace mpcq;
  if (nz <= 0 || nz % 4 != 0 || nz > PROBE_NZ_MAX || (lanes != 1 && lanes != 32)) return -1;
  std::vector<double> ws(size_t(nz) * (nz + 1));
  std::vector<unsigned> tab(size_t(probe_table_words(nz, lanes)));
  return run_host_team(lanes, PROBE_WARPS, [&](const auto& tm, int64_t w) {
    if (mirror)
      transpose_probe_walk<true>(tm, x, out, ws.data(), tab.data(), B, nz, reps, w,
                                 int64_t(PROBE_WARPS));
    else
      transpose_probe_walk<false>(tm, x, out, ws.data(), tab.data(), B, nz, reps, w,
                                  int64_t(PROBE_WARPS));
  });
}

extern "C" int mpcq_mirror_host_f64(const double* x, double* out, int64_t B, int nz, int reps) {
  return host_probe(1, x, out, B, nz, reps, true);
}
extern "C" int mpcq_elem_host_f64(const double* x, double* out, int64_t B, int nz, int reps) {
  return host_probe(1, x, out, B, nz, reps, false);
}
extern "C" int mpcq_mirror_host32_f64(const double* x, double* out, int64_t B, int nz,
                                      int reps) {
  return host_probe(32, x, out, B, nz, reps, true);
}
extern "C" int mpcq_elem_host32_f64(const double* x, double* out, int64_t B, int nz, int reps) {
  return host_probe(32, x, out, B, nz, reps, false);
}

#endif
