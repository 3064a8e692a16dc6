"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device -> exit 1 (there is no CPU fallback);
2. build: nvcc compiles ``mpc_quad_ros_tpu_torch/csrc/*.cu`` (timed);
3. kernel A (RK4 linearisation) against its plain PyTorch version, in f32
   and against the f64 plain version, at the main-path shapes;
4. kernel B (condense + IPM + KKT + dX) against the f64 plain version, the
   KKT floor, and NaN isolation between scenarios;
5. kernel C (the Riccati-factorised box IPM) at B=65536, N=40 against its
   f32 and f64 plain versions, dX against the rollout of dU, NaN isolation;
6. kernels D (condensing: H, g, M, d), E (the standalone box-QP IPM) and F
   (the whole Gauss-Newton step) at B=65536, N=10 against their f32 and f64
   plain versions, NaN isolation; then kernels B and E warm-started with
   the duals of a previous solve against the f64 plain warm IPM;
7. the card's solves against the f64 solves on the CPU, N=10 (each
   pipeline) and N=40, and the three pipelines against each other at
   B=65536;
8. the N=10 slice: ``SQPSolver.solve_batch`` at B=65536, 20 chained
   warm-started solves (solves/s), one-scenario latency (p50/p99 of 20 runs
   of 50 chained solves, CUDA events);
9. the closed learning loop: 16384 episodes x 100 ticks on the accelerating
   circle at 8 m/s (tick-solves/s, tracking error from tick 30 on);
10. the "split" and "fused" slices: the N=10 slice's chained solves through
    kernels A, D, E and through kernel F alone;
11. the warm-dual regulation chain (``bench/regulation.py``) at B=65536, 40
    ticks: cold at 12 IPM iterations, warm at 6 and at 12 (hybrid), then one
    warm tick through "split" and one through "fused";
12. the Riccati slice: ``solve_batch(qp_method="auto")`` at N=40, B=65536,
    10 chained solves (solves/s, honest KKT), then "pdip" at N=40, which must
    warn and take kernel C;
13. the backend crossover (``bench/crossover.py``) at B=16384, N = 10, 16,
    20, 30 (condensed and Riccati) and 80 (Riccati only), 2 chained solves
    per row.

The launch counters are reset just before each path (phases 8-9, 10 split,
10 fused, 11, 12) and read just after; each path must have launched its
kernels and no other.  The plain versions are fenced off during phases
8-13.  The line before the last lists every kernel with its launches, its
time, its plain version's and its bound (``bench/bounds.py``); the last line
is the device summary.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mpc_quad_ros_tpu_torch.bench import bounds  # noqa: E402
from mpc_quad_ros_tpu_torch.bench.closed_loop import closed_loop  # noqa: E402
from mpc_quad_ros_tpu_torch.bench.crossover import crossover_row  # noqa: E402
from mpc_quad_ros_tpu_torch.bench.operating_point import N_BASIS, operating_point  # noqa: E402
from mpc_quad_ros_tpu_torch.bench.regulation import regulation_chain, regulation_setup  # noqa: E402
from mpc_quad_ros_tpu_torch.models import fold_drag, make_mpc_dynamics  # noqa: E402
from mpc_quad_ros_tpu_torch.ops import qp_kkt_residual, sqp  # noqa: E402
from mpc_quad_ros_tpu_torch.ops.cuda import (_build, condense_kernel, lin_kernel,  # noqa: E402
                                             qp_kernel, riccati_kernel, sqp_fused_kernel)

SOLVE_B = 65536
CLOSED_B = 16384
CROSS_B = 16384
N_LONG = 40
# Kernel A against its plain version: xp holds positions up to ~20 m, where
# one f32 ulp is ~2e-6, and four RK4 stages add a few ulps -> 1e-5.  J entries
# reach ~15, with the 13-term chain-rule sums of 4 stages behind each -> 1e-4.
LIN_XP_TOL, LIN_J_TOL = 1e-5, 1e-4
# Kernel B against the f64 oracle: the measured 12-iteration f32 IPM floor of
# the JAX package (tests/test_pipeline_equivalence.py) on z, and its f32 KKT
# floor of ~1e-3 on the KKT distribution.  At this operating point the
# 12-iteration Jacobi-scaled IPM (the JAX kernel's algorithm) leaves about a
# quarter of the scenarios above KKT 1e-3 even in f64 (max ~1.6e-2), and the
# terms of Hz + g reach ~1e4, where one f32 ulp is ~1e-3.  So the kernel's
# max KKT may exceed the oracle's max by the floor, and its share of scenarios
# at KKT <= 1e-3 may trail the oracle's by one point — statistics of each run
# against the oracle, not one run against another element by element.
QP_Z_TOL, QP_KKT_TOL = 4e-2, 1e-3
# Kernel C against the f64 plain version of the same 12 iterations: the JAX
# package pins its f32 Riccati kernel at 1e-3 of the f64 oracle
# (tests/test_riccati_kernel.py:91; measured 2.4e-4 there); on random OCPs
# the port's kernel sits at 1.6e-6 of its f64 plain version (CUDA test).
RIC_DU_TOL = 1e-3
# dX against the f64 affine rollout of the kernel's own dU: f32 rounding of a
# 40-stage recurrence of 17-term sums, relative to the largest |dX|.
RIC_DX_REL_TOL = 1e-4
# The Riccati solve on the card (f32) against the CPU's (f64), N=40: the
# same bound as the condensed path's, 4e-2.
RIC_VS_CPU_TOL = QP_Z_TOL
# Kernel D against its f64 plain version, each of H, g, M and d relative to
# its largest entry: f32 keeps 6e-8 of an entry; each is a sum of at most
# 13 (N+1) products formed through an N-stage recurrence of 13-term sums, and
# the kernel's first card run read 5e-7 at B=4096 -> 1e-5.
COND_REL_TOL = 1e-5
# The controls' box in the new paths' checks: U + z in f32 may pass it by an
# ulp of 1 (z = clip(z', lb/s, ub/s) s rounds, in every pipeline and in the
# JAX kernels alike).
U_BOX_SLACK = 1e-6
# The closed loop's tracking error: about twice the physics figure of the
# JAX benchmark's run of the same scenario (0.022 m).
ERR_MEAN_TOL = 0.05
T0 = time.perf_counter()


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(phase: str, **kw) -> None:
    """One phase's JSON line; t_s is the script's elapsed wall time."""
    print(json.dumps({"phase": phase, **kw, "t_s": time.perf_counter() - T0}), flush=True)


def timed_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after a warm-up)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(B: int, device, **kw):
    """The kernels' inputs as the path forms them: one warm-up solve, then
    the next Gauss-Newton step's (X, U) and folded drag (and, with
    warm_start_duals, the warm-up solve's duals in the carry)."""
    solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3, **kw)
    carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    return solver, carry, x0, y_ref, aug


def step_args(solver, carry, x0, y_ref, aug):
    """Kernel B's arguments besides the weights: J from kernel A, then the
    glue."""
    xp, J = lin_kernel.linearize(carry.X, carry.U, aug, solver.f, solver.cfg.dt)
    return [J, *solver.qp_inputs(carry.X, carry.U, x0, y_ref, y_ref[:, -1], xp)]


def qp_stats(z, kkt, z_d, kkt_d) -> dict:
    """A run's z and KKT against the f64 oracle's (kernel B's rules)."""
    return {"z_vs_f64": (z.double() - z_d).abs().max().item(),
            "kkt_max": kkt.max().item(), "kkt_f64_max": kkt_d.max().item(),
            "kkt_share_le_1e-3": (kkt <= QP_KKT_TOL).double().mean().item(),
            "kkt_f64_share_le_1e-3": (kkt_d <= QP_KKT_TOL).double().mean().item()}


def check_qp(name: str, st: dict) -> None:
    check(st["z_vs_f64"] < QP_Z_TOL, f"{name} z: {st}")
    check(st["kkt_max"] <= st["kkt_f64_max"] + QP_KKT_TOL,
          f"{name} max KKT beyond the f32 floor over the oracle's: {st}")
    check(st["kkt_share_le_1e-3"] >= st["kkt_f64_share_le_1e-3"] - 0.01,
          f"{name} converges in fewer scenarios than the f64 oracle: {st}")


def isolated(bad: int, outs, outs_bad) -> bool:
    """Scenario `bad` went NaN and every other scenario's outputs are bitwise
    unchanged."""
    keep = torch.arange(outs[0].shape[0], device=outs[0].device) != bad
    return (bool(torch.isnan(outs_bad[0][bad]).any())
            and all(torch.equal(a[keep], b[keep]) for a, b in zip(outs, outs_bad)))


def phase_environment() -> None:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"
    except FileNotFoundError:
        card = "nvidia-smi: not found"
    print(card, flush=True)
    emit("environment", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    # registers and spills of each kernel, from ptxas -v in the build log
    regs, mangled, props = {}, None, None
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            regs[mangled.split("mpcq_")[1].split("_kernel")[0]] = entry = {}
        elif "Function properties for" in line:
            props = line.split("for ")[1].strip()
        elif mangled and props == mangled and "spill stores" in line:
            entry["spill_stores_bytes"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif mangled and "Used" in line and "registers" in line:
            entry["registers"] = int(line.split("Used")[1].split("registers")[0])
    emit("build", seconds=time.perf_counter() - t0, registers=regs,
         library=str(lib.relative_to(_build.BUILD_ROOT.parents[1])))


def phase_kernel_a(device) -> dict:
    solver, carry, _, _, aug = kernel_inputs(SOLVE_B, device)
    f, dt = solver.f, solver.cfg.dt
    X, U = carry.X, carry.U
    xp, J = lin_kernel.linearize(X, U, aug, f, dt)
    xp_p, J_p = lin_kernel.linearize_plain(f, X, U, aug, dt)
    f64 = make_mpc_dynamics(solver.f.params.map(lambda a: a.double()))
    xp_d, J_d = lin_kernel.linearize_plain(f64, X.double(), U.double(),
                                           aug.map(lambda a: a.double()), dt)
    err = {"xp_vs_plain": (xp - xp_p).abs().max().item(),
           "J_vs_plain": (J - J_p).abs().max().item(),
           "xp_vs_f64": (xp.double() - xp_d).abs().max().item(),
           "J_vs_f64": (J.double() - J_d).abs().max().item()}
    ms = timed_ms(lambda: lin_kernel.linearize(X, U, aug, f, dt), reps=10)
    plain_ms = timed_ms(lambda: lin_kernel.linearize_plain(f, X, U, aug, dt), reps=2)
    work = bounds.lin_work(SOLVE_B, solver.cfg.n_nodes, N_BASIS)
    emit("kernel_a", B=SOLVE_B, **err, ms=ms, plain_ms=plain_ms, **work, tol_xp=LIN_XP_TOL,
         tol_J=LIN_J_TOL)
    check(torch.isfinite(J).all() and torch.isfinite(xp).all(), "kernel A: non-finite output")
    check(err["xp_vs_plain"] <= LIN_XP_TOL and err["xp_vs_f64"] <= LIN_XP_TOL, f"kernel A xp: {err}")
    check(err["J_vs_plain"] <= LIN_J_TOL and err["J_vs_f64"] <= LIN_J_TOL, f"kernel A J: {err}")
    return {"max_abs_err": max(err["xp_vs_plain"], err["J_vs_plain"]), "ms": ms, "plain_ms": plain_ms,
            **work}


def phase_kernel_b(device) -> dict:
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device)
    cfg = solver.cfg
    q, p, rw = cfg.weight_tuples()
    args = step_args(solver, carry, x0, y_ref, aug)
    z, dX, kkt, zl, zu = sqp_fused_kernel.fused_sqp_from_J(*args, q, p, rw, cfg.qp_iters)
    z_p, _, kkt_p, _, _ = sqp_fused_kernel.fused_sqp_from_J_plain(*args, q, p, rw, cfg.qp_iters)
    z_d, dX_d, kkt_d, _, _ = sqp_fused_kernel.fused_sqp_from_J_plain(
        *[a.double() for a in args], q, p, rw, cfg.qp_iters)
    err = {"z_kernel_vs_f64": (z.double() - z_d).abs().max().item(),
           "z_plain_vs_f64": (z_p.double() - z_d).abs().max().item(),
           "dX_kernel_vs_f64": (dX.double() - dX_d).abs().max().item(),
           "kkt_kernel_max": kkt.max().item(), "kkt_plain_max": kkt_p.max().item(),
           "kkt_f64_max": kkt_d.max().item(),
           "kkt_kernel_max_where_f64_converged": kkt[kkt_d <= 1e-4].max().item(),
           "f64_converged_share": (kkt_d <= 1e-4).double().mean().item(),
           "kkt_kernel_share_le_1e-3": (kkt <= QP_KKT_TOL).double().mean().item(),
           "kkt_f64_share_le_1e-3": (kkt_d <= QP_KKT_TOL).double().mean().item()}

    # NaN isolation: poison one scenario's J; every other scenario's outputs
    # must be bitwise unchanged
    bad = 7
    J_bad = args[0].clone()
    J_bad[bad, 3, 5, 8] = float("nan")
    out_b = sqp_fused_kernel.fused_sqp_from_J(J_bad, *args[1:], q, p, rw, cfg.qp_iters)
    nan_isolated = isolated(bad, (z, dX, kkt, zl, zu), out_b)

    ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_from_J(*args, q, p, rw, cfg.qp_iters), reps=5)
    plain_ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_from_J_plain(*args, q, p, rw, cfg.qp_iters),
                        reps=2)
    work = bounds.sqp_from_J_work(SOLVE_B, cfg.n_nodes, cfg.qp_iters)
    emit("kernel_b", B=SOLVE_B, **err, nan_isolated=nan_isolated, ms=ms, plain_ms=plain_ms,
         smem_bytes=_build.load_library().mpcq_sqp_ws_bytes(cfg.n_nodes), **work,
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    check(torch.isfinite(z).all() and torch.isfinite(dX).all(), "kernel B: non-finite output")
    check(torch.isfinite(zl).all() and bool((zl > 0).all()) and bool((zu > 0).all()),
          "kernel B: duals not finite and positive")
    check(err["z_kernel_vs_f64"] < QP_Z_TOL and err["z_plain_vs_f64"] < QP_Z_TOL, f"kernel B z: {err}")
    check(err["kkt_kernel_max"] <= err["kkt_f64_max"] + QP_KKT_TOL,
          f"kernel B max KKT beyond the f32 floor over the oracle's: {err}")
    check(err["kkt_kernel_share_le_1e-3"] >= err["kkt_f64_share_le_1e-3"] - 0.01,
          f"kernel B converges in fewer scenarios than the f64 oracle: {err}")
    check(nan_isolated, "kernel B: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": err["z_kernel_vs_f64"], "ms": ms, "plain_ms": plain_ms, **work}


def phase_kernel_c(device) -> dict:
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device, N=N_LONG, qp_method="riccati")
    cfg = solver.cfg
    w = cfg.weight_tuples()
    X, U = carry.X, carry.U
    xp, J = lin_kernel.linearize(X, U, aug, solver.f, cfg.dt)
    args = [J, *solver.riccati_inputs(X, U, x0, y_ref, y_ref[:, -1], xp)]
    kernel = lambda a: riccati_kernel.riccati_ipm_from_J(*a, *w, cfg.qp_iters)
    du, dX = kernel(args)
    du_p, _ = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args, *w, cfg.qp_iters)
    args64 = [a.double() for a in args]
    du_d, _ = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args64, *w, cfg.qp_iters)
    roll = riccati_kernel.affine_rollout(*args64[:3], du.double())
    err = {"du_kernel_vs_f64": (du.double() - du_d).abs().max().item(),
           "du_plain_vs_f64": (du_p.double() - du_d).abs().max().item(),
           "du_kernel_vs_plain": (du - du_p).abs().max().item(),
           "dX_vs_rollout_of_du": (dX.double() - roll).abs().max().item(),
           "dX_max_abs": roll.abs().max().item()}
    del args64, du_d, du_p, roll

    bad = 7
    J_bad = J.clone()
    J_bad[bad, N_LONG // 2, 5, 8] = float("nan")
    nan_isolated = isolated(bad, (du, dX), kernel([J_bad] + args[1:]))
    del J_bad

    ms = timed_ms(lambda: kernel(args), reps=3)
    plain_ms = timed_ms(lambda: riccati_kernel.solve_ocp_box_riccati_ipm_plain(
        *args, *w, cfg.qp_iters), reps=1)
    work = bounds.riccati_work(SOLVE_B, N_LONG, cfg.qp_iters)
    emit("kernel_c", B=SOLVE_B, N=N_LONG, **err, nan_isolated=nan_isolated,
         smem_bytes=_build.load_library().mpcq_riccati_ws_bytes(N_LONG), ms=ms,
         plain_ms=plain_ms, **work, tol_du=RIC_DU_TOL, tol_dX_rel=RIC_DX_REL_TOL)
    check(torch.isfinite(du).all() and torch.isfinite(dX).all(), "kernel C: non-finite output")
    check(err["du_kernel_vs_f64"] < RIC_DU_TOL and err["du_plain_vs_f64"] < RIC_DU_TOL,
          f"kernel C dU: {err}")
    check(err["dX_vs_rollout_of_du"] <= RIC_DX_REL_TOL * max(1.0, err["dX_max_abs"]),
          f"kernel C dX is not the rollout of dU: {err}")
    check(nan_isolated, "kernel C: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": err["du_kernel_vs_f64"], "ms": ms, "plain_ms": plain_ms, **work}


def phase_kernel_d(device) -> dict:
    """Condensing at the main path's shapes: H, g, M, d against the f32 and
    f64 plain versions, relative to each array's largest entry."""
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device)
    cfg = solver.cfg
    w = cfg.weight_tuples()
    args = step_args(solver, carry, x0, y_ref, aug)[:4]
    out = condense_kernel.condense_cost_from_J(*args, *w)
    ref = condense_kernel.condense_cost_from_J_plain(*[a.double() for a in args], *w)
    plain = condense_kernel.condense_cost_from_J_plain(*args, *w)
    rel = lambda a, b: ((a.double() - b).abs().max() / b.abs().max()).item()
    err = {f"{k}_kernel_vs_f64_rel": rel(a, b) for k, a, b in zip("HgMd", out, ref)}
    err.update({f"{k}_plain_vs_f64_rel": rel(a, b) for k, a, b in zip("HgMd", plain, ref)})
    err["max_abs_err"] = max((a.double() - b).abs().max().item() for a, b in zip(out, ref))
    del ref, plain
    symmetric = torch.equal(out[0], out[0].mT)
    bad = 7
    J_bad = args[0].clone()
    J_bad[bad, 3, 5, 8] = float("nan")
    nan_isolated = isolated(bad, out, condense_kernel.condense_cost_from_J(J_bad, *args[1:], *w))
    del J_bad
    ms = timed_ms(lambda: condense_kernel.condense_cost_from_J(*args, *w), reps=5)
    plain_ms = timed_ms(lambda: condense_kernel.condense_cost_from_J_plain(*args, *w), reps=2)
    work = bounds.condense_work(SOLVE_B, cfg.n_nodes)
    emit("kernel_d", B=SOLVE_B, **err, H_symmetric=symmetric, nan_isolated=nan_isolated, ms=ms,
         plain_ms=plain_ms, smem_bytes=_build.load_library().mpcq_condense_ws_bytes(cfg.n_nodes),
         **work, tol_rel=COND_REL_TOL)
    check(all(torch.isfinite(a).all() for a in out), "kernel D: non-finite output")
    check(all(v < COND_REL_TOL for k, v in err.items() if k.endswith("_rel")), f"kernel D: {err}")
    check(symmetric, "kernel D: H is not exactly symmetric")
    check(nan_isolated, "kernel D: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": err["max_abs_err"], "ms": ms, "plain_ms": plain_ms, **work}


def phase_kernel_e(device, warm_start: bool = False) -> dict:
    """The standalone IPM on kernel D's QPs, cold or warm-started from the
    duals of the previous solve, against the f32 and f64 plain IPMs."""
    solver, carry, x0, y_ref, aug = (regulation_inputs(device) if warm_start
                                     else kernel_inputs(SOLVE_B, device))
    cfg = solver.cfg
    args = step_args(solver, carry, x0, y_ref, aug)
    H, g, _, _ = condense_kernel.condense_cost_from_J(*args[:4], *cfg.weight_tuples())
    box = (H, g + args[4], args[5], args[6])
    d32 = (carry.zl, carry.zu) if warm_start else (None, None)
    z, zl, zu = qp_kernel.solve_box_qp_pdip_batch(*box, cfg.qp_iters, *d32)
    box64 = [a.double() for a in box]
    d64 = [None if d is None else d.double() for d in d32]
    z_d, _, _ = qp_kernel.ipm_box_solve(*box64, cfg.qp_iters, *d64)
    z_p, _, _ = qp_kernel.ipm_box_solve(*box, cfg.qp_iters, *d32)
    st = qp_stats(z, qp_kkt_residual(*box, z), z_d, qp_kkt_residual(*box64, z_d))
    st["z_plain_vs_f64"] = (z_p.double() - z_d).abs().max().item()
    del box64, z_d, z_p
    bad = 7
    H_bad = H.clone()
    H_bad[bad, 5, 6] = float("nan")
    nan_isolated = isolated(bad, (z, zl, zu),
                            qp_kernel.solve_box_qp_pdip_batch(H_bad, *box[1:], cfg.qp_iters, *d32))
    del H_bad
    ms = timed_ms(lambda: qp_kernel.solve_box_qp_pdip_batch(*box, cfg.qp_iters, *d32), reps=5)
    plain_ms = timed_ms(lambda: qp_kernel.ipm_box_solve(*box, cfg.qp_iters, *d32), reps=2)
    nz = H.shape[-1]
    work = bounds.box_qp_work(SOLVE_B, nz, cfg.qp_iters, warm=warm_start)
    name = "kernel_e_warm" if warm_start else "kernel_e"
    emit(name, B=SOLVE_B, **st, nan_isolated=nan_isolated, ms=ms, plain_ms=plain_ms,
         smem_bytes=_build.load_library().mpcq_box_qp_ws_bytes(nz), **work,
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    check(torch.isfinite(z).all(), f"{name}: non-finite output")
    check(torch.isfinite(zl).all() and bool((zl > 0).all()) and bool((zu > 0).all()),
          f"{name}: duals not finite and positive")
    check_qp(name, st)
    check(st["z_plain_vs_f64"] < QP_Z_TOL, f"{name} plain z: {st}")
    check(nan_isolated, f"{name}: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": st["z_vs_f64"], "ms": ms, "plain_ms": plain_ms, **work}


def phase_kernel_f(device) -> dict:
    """The whole step in one kernel against its f32 plain version (kernel
    A's, then kernel B's) and the f64 one, and against kernel B fed by
    kernel A on the same inputs."""
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device)
    cfg = solver.cfg
    w = cfg.weight_tuples()
    X, U = carry.X, carry.U
    si = solver.step_inputs(X, U, x0, y_ref, y_ref[:, -1])
    run = lambda XX: sqp_fused_kernel.fused_sqp_step(XX, U, *si, aug, solver.f, cfg.dt, *w,
                                                     cfg.qp_iters)
    out = run(X)
    z_p, _, kkt_p, _, _ = sqp_fused_kernel.fused_sqp_step_plain(X, U, *si, aug, solver.f, cfg.dt,
                                                                *w, cfg.qp_iters)
    f64 = make_mpc_dynamics(solver.f.params.map(lambda a: a.double()))
    dbl = lambda a: a.double()
    z_d, dX_d, kkt_d, _, _ = sqp_fused_kernel.fused_sqp_step_plain(
        dbl(X), dbl(U), *map(dbl, si), aug.map(dbl), f64, cfg.dt, *w, cfg.qp_iters)
    st = qp_stats(out[0], out[2], z_d, kkt_d)
    st["z_plain_vs_f64"] = (z_p.double() - z_d).abs().max().item()
    st["dX_vs_f64"] = (out[1].double() - dX_d).abs().max().item()
    z_b = sqp_fused_kernel.fused_sqp_from_J(*step_args(solver, carry, x0, y_ref, aug), *w,
                                            cfg.qp_iters)[0]
    st["z_vs_kernel_b"] = (out[0] - z_b).abs().max().item()
    bad = 7
    X_bad = X.clone()
    X_bad[bad, 3, 8] = float("nan")
    nan_isolated = isolated(bad, out, run(X_bad))
    ms = timed_ms(lambda: run(X), reps=5)
    plain_ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_step_plain(
        X, U, *si, aug, solver.f, cfg.dt, *w, cfg.qp_iters), reps=2)
    work = bounds.sqp_step_work(SOLVE_B, cfg.n_nodes, N_BASIS, cfg.qp_iters)
    emit("kernel_f", B=SOLVE_B, **st, nan_isolated=nan_isolated, ms=ms, plain_ms=plain_ms,
         smem_bytes=_build.load_library().mpcq_sqp_step_ws_bytes(cfg.n_nodes), **work,
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    check(all(torch.isfinite(a).all() for a in out), "kernel F: non-finite output")
    check(bool((out[3] > 0).all()) and bool((out[4] > 0).all()), "kernel F: duals not positive")
    check_qp("kernel F", st)
    check(st["z_plain_vs_f64"] < QP_Z_TOL, f"kernel F plain z: {st}")
    check(nan_isolated, "kernel F: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": st["z_vs_f64"], "ms": ms, "plain_ms": plain_ms, **work}


def regulation_inputs(device):
    """Warm-start inputs where warm duals pay: the regulation chain at
    B=65536 after 3 warm ticks, then the next tick's step, with the carry's
    duals."""
    solver, carry, x0, y_ref, rgp = regulation_setup(SOLVE_B, device, True, 12)
    for _ in range(3):
        carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    return solver, carry, x0, y_ref, aug


def phase_kernel_b_warm(device) -> dict:
    """Kernel B warm-started with the duals of the previous solve against
    the f64 plain warm step: on the regulation chain (held to kernel B's
    rules), then on the solve cell's transient, where both f32 and f64 stay
    far from the optimum at 12 iterations, so only the KKT distribution is
    held to the oracle's."""
    rows = {}
    for cell, inputs in (("regulation", regulation_inputs),
                         ("solve_cell", lambda d: kernel_inputs(SOLVE_B, d, warm_start_duals=True))):
        solver, carry, x0, y_ref, aug = inputs(device)
        cfg = solver.cfg
        w = cfg.weight_tuples()
        args = step_args(solver, carry, x0, y_ref, aug)
        duals = (carry.zl, carry.zu)
        z, dX, kkt, zl, zu = sqp_fused_kernel.fused_sqp_from_J(*args, *w, cfg.qp_iters,
                                                               duals=duals)
        z_d, _, kkt_d, _, _ = sqp_fused_kernel.fused_sqp_from_J_plain(
            *[a.double() for a in args], *w, cfg.qp_iters, duals=tuple(d.double() for d in duals))
        z_cold, _, kkt_cold, _, _ = sqp_fused_kernel.fused_sqp_from_J(*args, *w, cfg.qp_iters)
        st = qp_stats(z, kkt, z_d, kkt_d)
        st.update(z_warm_vs_cold=(z - z_cold).abs().max().item(), kkt_cold_max=kkt_cold.max().item(),
                  kkt_cold_median=kkt_cold.median().item(), kkt_median=kkt.median().item())
        rows[cell] = st
        check(torch.isfinite(z).all() and torch.isfinite(dX).all(), f"kernel B warm, {cell}: non-finite")
        check(torch.isfinite(zl).all() and bool((zl > 0).all()) and bool((zu > 0).all()),
              f"kernel B warm, {cell}: duals not finite and positive")
        check(st["z_warm_vs_cold"] > 0, f"kernel B warm, {cell}: the duals were not used")
        if cell == "regulation":
            check_qp(f"kernel B warm, {cell}", st)
            ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_from_J(*args, *w, cfg.qp_iters,
                                                                    duals=duals), reps=5)
        else:
            check(st["kkt_max"] <= st["kkt_f64_max"] + QP_KKT_TOL
                  and st["kkt_share_le_1e-3"] >= st["kkt_f64_share_le_1e-3"] - 0.01,
                  f"kernel B warm, {cell}: KKT distribution off the oracle's: {st}")
    emit("kernel_b_warm", B=SOLVE_B, **{f"{c}_{k}": v for c, r in rows.items() for k, v in r.items()},
         ms=ms, **bounds.sqp_from_J_work(SOLVE_B, cfg.n_nodes, cfg.qp_iters, warm=True),
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    return rows


def time_chained(solver, carry0, x0, y_ref, rgp, iters: int, reps: int):
    """(solves/s over `reps` runs of `iters` chained solves after one, the
    last solution)."""
    def chained(carry, n):
        for _ in range(n):
            carry, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
        return carry, sol

    chained(carry0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, sol = chained(carry0, iters)
    torch.cuda.synchronize()
    B = x0.shape[0]
    return B * iters * reps / (time.perf_counter() - t0), sol


def check_solution(name: str, sol, slack: float = 0.0) -> None:
    check(sol.U.shape == (SOLVE_B, 10, 4) and torch.isfinite(sol.U).all()
          and torch.isfinite(sol.X).all(), f"{name}: bad solve output")
    check(sol.U.min().item() >= -slack and sol.U.max().item() <= 1 + slack,
          f"{name}: controls left the box by more than {slack}")


def phase_pipeline_slice(device, pipeline: str) -> dict:
    """The N=10 slice's chained solves through another pipeline."""
    solver, carry0, x0, y_ref, rgp = operating_point(SOLVE_B, device, pipeline=pipeline)
    solves_per_s, sol = time_chained(solver, carry0, x0, y_ref, rgp, iters=20, reps=3)
    check_solution(f"{pipeline} slice", sol, U_BOX_SLACK)
    emit(f"{pipeline}_slice", B=SOLVE_B, chained_solves=20, solves_per_s=solves_per_s,
         kkt_max=sol.kkt_residual.max().item(), kkt_median=sol.kkt_residual.median().item())
    return {"solves_per_s": solves_per_s}


def phase_pipelines_agree(device) -> None:
    """One solve of the N=10 slice's inputs through each pipeline: max |dU|
    and |dX| of "split" and "fused" against "hybrid" (f32 on the card, each
    held against the f64 oracle in phase slice_vs_cpu_f64)."""
    sols = {}
    for pipe in sqp.PIPELINES:
        solver, carry0, x0, y_ref, rgp = operating_point(SOLVE_B, device, pipeline=pipe)
        _, sols[pipe] = solver.solve_batch(carry0, x0, y_ref, y_ref[:, -1], rgp)
    h = sols["hybrid"]
    row = {}
    for pipe in ("split", "fused"):
        row[f"{pipe}_max_abs_dU_vs_hybrid"] = (sols[pipe].U - h.U).abs().max().item()
        row[f"{pipe}_max_abs_dX_vs_hybrid"] = (sols[pipe].X - h.X).abs().max().item()
        check_solution(f"{pipe} solve", sols[pipe], U_BOX_SLACK)
    emit("pipelines_vs_hybrid", B=SOLVE_B, **row, tol=QP_Z_TOL)
    check(all(v < QP_Z_TOL for k, v in row.items() if "dU" in k), f"pipelines disagree: {row}")


def phase_warm_chain(device) -> dict:
    """The regulation chain at B=65536, 40 ticks: cold at 12 IPM iterations,
    warm at 6 and at 12, each through "hybrid"; then one warm tick through
    "split" and "fused", so kernels E and F run warm on the card too."""
    rows = {}
    for warm, iters in ((False, 12), (True, 6), (True, 12)):
        summary, carry, _ = regulation_chain(SOLVE_B, device, warm, iters, ticks=40)
        key = f"{'warm' if warm else 'cold'}{iters}"
        rows[key] = summary
        check(torch.isfinite(carry.U).all() and carry.U.min().item() >= -U_BOX_SLACK
              and carry.U.max().item() <= 1 + U_BOX_SLACK,
              f"warm chain {key}: controls not finite or out of the box")
        if warm:
            check(torch.isfinite(carry.zl).all() and bool((carry.zl > 0).all())
                  and bool((carry.zu > 0).all()), f"warm chain {key}: duals not finite and positive")
    for pipe in ("split", "fused"):
        summary, carry, _ = regulation_chain(SOLVE_B, device, True, 6, ticks=1, pipeline=pipe)
        rows[f"{pipe}_warm6_one_tick"] = summary
        check(torch.isfinite(carry.U).all() and bool((carry.zl > 0).all()),
              f"warm chain, {pipe}: bad tick")
    emit("warm_chain", B=SOLVE_B, ticks=40,
         **{f"{k}_{m}": v[m] for k, v in rows.items() for m in ("kkt_max", "kkt_median")})
    return rows


def phase_slice(device) -> dict:
    iters = 20
    solver, carry0, x0, y_ref, rgp = operating_point(SOLVE_B, device)
    solves_per_s, sol = time_chained(solver, carry0, x0, y_ref, rgp, iters=iters, reps=3)
    check_solution("slice", sol)

    # one-scenario latency: 50 chained solves per CUDA-event-timed run
    one = lambda a: a[:1]
    c1, x1, y1, r1 = carry0.map(one), x0[:1], y_ref[:1], rgp.map(one)

    def chained():
        carry = c1
        for _ in range(50):
            carry, _ = solver.solve_batch(carry, x1, y1, y1[:, -1], r1)

    chained()
    lat = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chained()
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end) / 50)
    lat.sort()
    p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    emit("slice", B=SOLVE_B, chained_solves=iters, solves_per_s=solves_per_s,
         latency_p50_ms=p50, latency_p99_ms=p99, kkt_max=sol.kkt_residual.max().item())
    return {"solves_per_s": solves_per_s, "p50": p50, "p99": p99}


def phase_slice_vs_cpu(device) -> None:
    """The card's f32 solve against the f64 plain solve on the CPU, through
    each pipeline."""
    B = 256
    s64, c64, x64, y64, r64 = operating_point(B, "cpu", torch.float64, mu_scale=0.3)
    _, ref = s64.solve_batch(c64, x64, y64, y64[:, -1], r64)
    row = {}
    for pipe in sqp.PIPELINES:
        solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3, pipeline=pipe)
        _, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
        row[f"{pipe}_max_abs_dU" if pipe != "hybrid" else "max_abs_dU"] = (
            sol.U.double().cpu() - ref.U).abs().max().item()
    emit("slice_vs_cpu_f64", B=B, **row, tol=QP_Z_TOL)
    check(all(v < QP_Z_TOL for v in row.values()), f"slice: card f32 vs CPU f64 max |dU| {row}")


def phase_riccati_vs_cpu(device) -> None:
    """The card's f32 Riccati solve at N=40 against the f64 one on the CPU."""
    B = 256
    kw = dict(mu_scale=0.3, N=N_LONG, qp_method="riccati")
    solver, carry, x0, y_ref, rgp = operating_point(B, device, **kw)
    _, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    s64, c64, x64, y64, r64 = operating_point(B, "cpu", torch.float64, **kw)
    _, ref = s64.solve_batch(c64, x64, y64, y64[:, -1], r64)
    du = (sol.U.double().cpu() - ref.U).abs().max().item()
    emit("riccati_vs_cpu_f64", B=B, N=N_LONG, max_abs_dU=du,
         max_abs_dX=(sol.X.double().cpu() - ref.X).abs().max().item(),
         kkt_max=sol.kkt_residual.max().item(), kkt_f64_max=ref.kkt_residual.max().item(),
         tol=RIC_VS_CPU_TOL)
    check(du < RIC_VS_CPU_TOL, f"riccati: card f32 vs CPU f64 max |dU| = {du}")


def phase_riccati_slice(device) -> dict:
    """solve_batch(qp_method="auto") at N=40 takes kernels A and C; "pdip" at
    N=40 warns and takes them too."""
    iters = 10
    solver, carry, x0, y_ref, rgp = operating_point(SOLVE_B, device, N=N_LONG, qp_method="auto")
    check(solver._resolve_qp_method() == "riccati", "riccati slice: auto did not pick riccati")
    carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        carry, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    torch.cuda.synchronize()
    solves_per_s = SOLVE_B * iters / (time.perf_counter() - t0)
    check(sol.U.shape == (SOLVE_B, N_LONG, 4) and torch.isfinite(sol.U).all()
          and torch.isfinite(sol.X).all(), "riccati slice: bad solve output")
    check(bool(((sol.U >= 0) & (sol.U <= 1)).all()), "riccati slice: controls left the box")
    kkt = sol.kkt_residual

    c_before = riccati_kernel.riccati_ipm_from_J.launches
    b_before = sqp_fused_kernel.fused_sqp_from_J.launches
    sp, cp, xp0, yp, rp = operating_point(1024, device, N=N_LONG, qp_method="pdip")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, solp = sp.solve_batch(cp, xp0, yp, yp[:, -1], rp)
    torch.cuda.synchronize()
    warned = any("shared-memory ceiling" in str(m.message) for m in caught)
    pdip_took_c = (riccati_kernel.riccati_ipm_from_J.launches == c_before + 1
                   and sqp_fused_kernel.fused_sqp_from_J.launches == b_before)
    emit("riccati_slice", B=SOLVE_B, N=N_LONG, chained_solves=iters, solves_per_s=solves_per_s,
         kkt_max=kkt.max().item(), kkt_median=kkt.median().item(),
         pdip_n40_warned=warned, pdip_n40_took_kernel_c=pdip_took_c)
    check(warned and pdip_took_c, "riccati slice: pdip at N=40 did not fall back to kernel C")
    check(torch.isfinite(solp.U).all(), "riccati slice: pdip fallback gave non-finite controls")
    return {"solves_per_s": solves_per_s}


def phase_crossover(device) -> None:
    """Condensed against Riccati as N grows; N=16 is where "auto" switches.
    Below AUTO_RICCATI_MIN_N the condensed step must keep every scenario."""
    for N in (10, 16, 20, 30, 80):
        row = crossover_row(CROSS_B, N, reps=2, device=device)
        emit("crossover", **row, auto=sqp.SQPSolver(sqp.MPCConfig(n_nodes=N, qp_method="auto"),
                                                    None)._resolve_qp_method())
        if N < sqp.AUTO_RICCATI_MIN_N:
            check(row["condensed_nonfinite_share"] == 0,
                  f"crossover: the condensed step lost scenarios below AUTO_RICCATI_MIN_N: {row}")


def phase_closed_loop(device) -> dict:
    cl = closed_loop(B=CLOSED_B, v=8.0, t_max=10.0, device=device)
    emit("closed_loop", **cl)
    check(math.isfinite(cl["err_mean_m"]) and math.isfinite(cl["err_p95_m"]),
          f"closed loop: non-finite error {cl}")
    check(cl["err_mean_m"] < ERR_MEAN_TOL, f"closed loop: err_mean_m {cl['err_mean_m']} >= {ERR_MEAN_TOL}")
    return cl


def _fenced(name):
    def fence(*args, **kwargs):
        raise RuntimeError(f"{name}: the plain version ran on the CUDA path")
    return fence


# kernels A-F: (wrapper with its launch counter, route, source, the TPU kernel
# it replaces)
KERNELS = {
    "lin_kernel": (lin_kernel.linearize, "mpc_quad_ros_tpu_torch/csrc/lin_kernel.cu",
                   "mpc_quad_ros_tpu/ops/pallas/lin_kernel.py:140"),
    "sqp_fused_kernel": (sqp_fused_kernel.fused_sqp_from_J,
                         "mpc_quad_ros_tpu_torch/csrc/sqp_fused_kernel.cu",
                         "mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py:291"),
    "riccati_ipm": (riccati_kernel.riccati_ipm_from_J, "mpc_quad_ros_tpu_torch/csrc/riccati_ipm.cu",
                    "mpc_quad_ros_tpu/ops/pallas/riccati_kernel.py:54"),
    "condense_kernel": (condense_kernel.condense_cost_from_J,
                        "mpc_quad_ros_tpu_torch/csrc/condense_kernel.cu",
                        "mpc_quad_ros_tpu/ops/pallas/condense_kernel.py:108"),
    "qp_kernel": (qp_kernel.solve_box_qp_pdip_batch, "mpc_quad_ros_tpu_torch/csrc/qp_kernel.cu",
                  "mpc_quad_ros_tpu/ops/pallas/qp_kernel.py:216"),
    "sqp_step_kernel": (sqp_fused_kernel.fused_sqp_step,
                        "mpc_quad_ros_tpu_torch/csrc/sqp_fused_kernel.cu",
                        "mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py:57"),
}
PLAINS = ((lin_kernel, "linearize_plain"), (sqp_fused_kernel, "fused_sqp_from_J_plain"),
          (riccati_kernel, "solve_ocp_box_riccati_ipm_plain"),
          (condense_kernel, "condense_cost_from_J_plain"), (qp_kernel, "ipm_box_solve"),
          (sqp_fused_kernel, "fused_sqp_step_plain"))


def drive(*phases) -> dict:
    """Run the phases with every launch count at 0 first; the counts after,
    by kernel name."""
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    for phase in phases:
        phase()
    torch.cuda.synchronize()
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def launched(counts: dict) -> set:
    return {name for name, n in counts.items() if n > 0}


def main() -> None:
    phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    res = {"lin_kernel": phase_kernel_a(device), "sqp_fused_kernel": phase_kernel_b(device),
           "riccati_ipm": phase_kernel_c(device), "condense_kernel": phase_kernel_d(device),
           "qp_kernel": phase_kernel_e(device), "sqp_step_kernel": phase_kernel_f(device)}
    torch.cuda.empty_cache()
    phase_kernel_b_warm(device)
    phase_kernel_e(device, warm_start=True)
    torch.cuda.empty_cache()
    phase_slice_vs_cpu(device)
    phase_riccati_vs_cpu(device)
    phase_pipelines_agree(device)
    torch.cuda.empty_cache()

    # the main paths: counts from 0 before each, plain versions fenced off
    saved = [getattr(mod, name) for mod, name in PLAINS]
    for mod, name in PLAINS:
        setattr(mod, name, _fenced(mod.__name__))
    try:
        paths = {
            "hybrid": drive(lambda: phase_slice(device), lambda: phase_closed_loop(device)),
            "split": drive(lambda: phase_pipeline_slice(device, "split")),
            "fused": drive(lambda: phase_pipeline_slice(device, "fused")),
            "warm_chain": drive(lambda: phase_warm_chain(device)),
            "riccati": drive(lambda: phase_riccati_slice(device)),
        }
        phase_crossover(device)
    finally:
        for (mod, name), fn in zip(PLAINS, saved):
            setattr(mod, name, fn)
    expect = {"hybrid": {"lin_kernel", "sqp_fused_kernel"},
              "split": {"lin_kernel", "condense_kernel", "qp_kernel"},
              "fused": {"sqp_step_kernel"},
              "warm_chain": {"lin_kernel", "sqp_fused_kernel", "condense_kernel", "qp_kernel",
                             "sqp_step_kernel"},
              "riccati": {"lin_kernel", "riccati_ipm"}}
    for path, counts in paths.items():
        check(launched(counts) == expect[path],
              f"the {path} path launched {counts}, expected exactly {sorted(expect[path])}")
    emit("launches", **paths)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(counts[name] for counts in paths.values()),
         "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"], "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": None}
        for name, (_, source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
