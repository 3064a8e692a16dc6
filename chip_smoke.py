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
6. the card's solves against the f64 solves on the CPU, N=10 and N=40;
7. the N=10 slice: ``SQPSolver.solve_batch`` at B=65536, 20 chained
   warm-started solves (solves/s), one-scenario latency (p50/p99 of 20 runs
   of 50 chained solves, CUDA events);
8. the closed learning loop: 16384 episodes x 100 ticks on the accelerating
   circle at 8 m/s (tick-solves/s, tracking error from tick 30 on);
9. the Riccati slice: ``solve_batch(qp_method="auto")`` at N=40, B=65536,
   10 chained solves (solves/s, honest KKT), then "pdip" at N=40, which must
   warn and take kernel C;
10. the backend crossover (``bench/crossover.py``) at B=16384, N = 10, 16,
    20, 30 (condensed and Riccati) and 80 (Riccati only).

The launch counters are reset just before each path (phases 7-8, phase 9)
and read just after; each path must have launched its kernels and no other.
The plain versions are fenced off during phases 7-10.  The line before the
last lists every kernel; the last line is the device summary.
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

from mpc_quad_ros_tpu_torch.bench.closed_loop import closed_loop  # noqa: E402
from mpc_quad_ros_tpu_torch.bench.crossover import crossover_row  # noqa: E402
from mpc_quad_ros_tpu_torch.bench.operating_point import operating_point  # noqa: E402
from mpc_quad_ros_tpu_torch.models import fold_drag, make_mpc_dynamics  # noqa: E402
from mpc_quad_ros_tpu_torch.ops import sqp  # noqa: E402
from mpc_quad_ros_tpu_torch.ops.cuda import (_build, lin_kernel, riccati_kernel,  # noqa: E402
                                             sqp_fused_kernel)

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
    the next Gauss-Newton step's (X, U) and folded drag."""
    solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3, **kw)
    carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    return solver, carry, x0, y_ref, aug


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
    emit("build", seconds=time.perf_counter() - t0, library=str(lib.relative_to(_build.BUILD_ROOT.parents[1])))


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
    emit("kernel_a", B=SOLVE_B, **err, ms=ms, plain_ms=plain_ms, tol_xp=LIN_XP_TOL, tol_J=LIN_J_TOL)
    check(torch.isfinite(J).all() and torch.isfinite(xp).all(), "kernel A: non-finite output")
    check(err["xp_vs_plain"] <= LIN_XP_TOL and err["xp_vs_f64"] <= LIN_XP_TOL, f"kernel A xp: {err}")
    check(err["J_vs_plain"] <= LIN_J_TOL and err["J_vs_f64"] <= LIN_J_TOL, f"kernel A J: {err}")
    return {"max_abs_err": max(err["xp_vs_plain"], err["J_vs_plain"]), "ms": ms, "plain_ms": plain_ms}


def phase_kernel_b(device) -> dict:
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device)
    cfg = solver.cfg
    q, p, rw = cfg.weight_tuples()
    xp, J = lin_kernel.linearize(carry.X, carry.U, aug, solver.f, cfg.dt)
    args = [J, *solver.qp_inputs(carry.X, carry.U, x0, y_ref, y_ref[:, -1], xp)]
    z, dX, kkt = sqp_fused_kernel.fused_sqp_from_J(*args, q, p, rw, cfg.qp_iters)
    z_p, _, kkt_p = sqp_fused_kernel.fused_sqp_from_J_plain(*args, q, p, rw, cfg.qp_iters)
    z_d, dX_d, kkt_d = sqp_fused_kernel.fused_sqp_from_J_plain(
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
    J_bad = J.clone()
    J_bad[bad, 3, 5, 8] = float("nan")
    z_b, dX_b, kkt_b = sqp_fused_kernel.fused_sqp_from_J(J_bad, *args[1:], q, p, rw, cfg.qp_iters)
    keep = torch.arange(SOLVE_B, device=device) != bad
    isolated = (bool(torch.isnan(z_b[bad]).any())
                and torch.equal(z_b[keep], z[keep]) and torch.equal(dX_b[keep], dX[keep])
                and torch.equal(kkt_b[keep], kkt[keep]))

    ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_from_J(*args, q, p, rw, cfg.qp_iters), reps=5)
    plain_ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_from_J_plain(*args, q, p, rw, cfg.qp_iters),
                        reps=2)
    emit("kernel_b", B=SOLVE_B, **err, nan_isolated=isolated, ms=ms, plain_ms=plain_ms,
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    check(torch.isfinite(z).all() and torch.isfinite(dX).all(), "kernel B: non-finite output")
    check(err["z_kernel_vs_f64"] < QP_Z_TOL and err["z_plain_vs_f64"] < QP_Z_TOL, f"kernel B z: {err}")
    check(err["kkt_kernel_max"] <= err["kkt_f64_max"] + QP_KKT_TOL,
          f"kernel B max KKT beyond the f32 floor over the oracle's: {err}")
    check(err["kkt_kernel_share_le_1e-3"] >= err["kkt_f64_share_le_1e-3"] - 0.01,
          f"kernel B converges in fewer scenarios than the f64 oracle: {err}")
    check(isolated, "kernel B: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": err["z_kernel_vs_f64"], "ms": ms, "plain_ms": plain_ms}


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

    bad = 7
    J_bad = J.clone()
    J_bad[bad, N_LONG // 2, 5, 8] = float("nan")
    du_b, dX_b = kernel([J_bad] + args[1:])
    keep = torch.arange(SOLVE_B, device=device) != bad
    isolated = (bool(torch.isnan(du_b[bad]).any()) and torch.equal(du_b[keep], du[keep])
                and torch.equal(dX_b[keep], dX[keep]))

    ms = timed_ms(lambda: kernel(args), reps=3)
    plain_ms = timed_ms(lambda: riccati_kernel.solve_ocp_box_riccati_ipm_plain(
        *args, *w, cfg.qp_iters), reps=1)
    emit("kernel_c", B=SOLVE_B, N=N_LONG, **err, nan_isolated=isolated,
         smem_bytes=_build.load_library().mpcq_riccati_ws_bytes(N_LONG), ms=ms,
         plain_ms=plain_ms, tol_du=RIC_DU_TOL, tol_dX_rel=RIC_DX_REL_TOL)
    check(torch.isfinite(du).all() and torch.isfinite(dX).all(), "kernel C: non-finite output")
    check(err["du_kernel_vs_f64"] < RIC_DU_TOL and err["du_plain_vs_f64"] < RIC_DU_TOL,
          f"kernel C dU: {err}")
    check(err["dX_vs_rollout_of_du"] <= RIC_DX_REL_TOL * max(1.0, err["dX_max_abs"]),
          f"kernel C dX is not the rollout of dU: {err}")
    check(isolated, "kernel C: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": err["du_kernel_vs_f64"], "ms": ms, "plain_ms": plain_ms}


def phase_slice(device) -> dict:
    iters, reps = 20, 3
    solver, carry0, x0, y_ref, rgp = operating_point(SOLVE_B, device)

    def chained(carry, x0, y_ref, rgp, n):
        for _ in range(n):
            carry, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
        return carry, sol

    chained(carry0, x0, y_ref, rgp, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        carry, sol = chained(carry0, x0, y_ref, rgp, iters)
    torch.cuda.synchronize()
    solves_per_s = SOLVE_B * iters * reps / (time.perf_counter() - t0)
    check(sol.U.shape == (SOLVE_B, 10, 4) and torch.isfinite(sol.U).all()
          and torch.isfinite(sol.X).all(), "slice: bad solve output")
    check(bool(((sol.U >= 0) & (sol.U <= 1)).all()), "slice: controls left the box")

    # one-scenario latency: 50 chained solves per CUDA-event-timed run
    one = lambda a: a[:1]
    c1, x1, y1, r1 = carry0.map(one), x0[:1], y_ref[:1], rgp.map(one)
    chained(c1, x1, y1, r1, 50)
    lat = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chained(c1, x1, y1, r1, 50)
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end) / 50)
    lat.sort()
    p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    emit("slice", B=SOLVE_B, chained_solves=iters, solves_per_s=solves_per_s,
         latency_p50_ms=p50, latency_p99_ms=p99, kkt_max=sol.kkt_residual.max().item())
    return {"solves_per_s": solves_per_s, "p50": p50, "p99": p99}


def phase_slice_vs_cpu(device) -> None:
    """The card's f32 solve against the f64 plain solve on the CPU."""
    B = 256
    solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3)
    _, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    s64, c64, x64, y64, r64 = operating_point(B, "cpu", torch.float64, mu_scale=0.3)
    _, ref = s64.solve_batch(c64, x64, y64, y64[:, -1], r64)
    du = (sol.U.double().cpu() - ref.U).abs().max().item()
    emit("slice_vs_cpu_f64", B=B, max_abs_dU=du, tol=QP_Z_TOL)
    check(du < QP_Z_TOL, f"slice: card f32 vs CPU f64 max |dU| = {du}")


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
        row = crossover_row(CROSS_B, N, reps=3, device=device)
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


COUNTED = (lin_kernel.linearize, sqp_fused_kernel.fused_sqp_from_J,
           riccati_kernel.riccati_ipm_from_J)
PLAINS = ((lin_kernel, "linearize_plain"), (sqp_fused_kernel, "fused_sqp_from_J_plain"),
          (riccati_kernel, "solve_ocp_box_riccati_ipm_plain"))


def drive(*phases):
    """Run the phases with every launch count at 0 first; the counts after
    (kernels A, B, C)."""
    for fn in COUNTED:
        fn.launches = 0
    for phase in phases:
        phase()
    torch.cuda.synchronize()
    return [fn.launches for fn in COUNTED]


def main() -> None:
    phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    res_a = phase_kernel_a(device)
    res_b = phase_kernel_b(device)
    res_c = phase_kernel_c(device)
    phase_slice_vs_cpu(device)
    phase_riccati_vs_cpu(device)

    # the main paths: counts from 0 before each, plain versions fenced off
    saved = [getattr(mod, name) for mod, name in PLAINS]
    for mod, name in PLAINS:
        setattr(mod, name, _fenced(mod.__name__))
    try:
        n10 = drive(lambda: phase_slice(device), lambda: phase_closed_loop(device))
        n40 = drive(lambda: phase_riccati_slice(device))
        phase_crossover(device)
    finally:
        for (mod, name), fn in zip(PLAINS, saved):
            setattr(mod, name, fn)
    check(n10[0] > 0 and n10[1] > 0 and n10[2] == 0, f"N=10 path launched A, B, C {n10} times")
    check(n40[0] > 0 and n40[1] == 0 and n40[2] > 0, f"N=40 Riccati path launched A, B, C {n40} times")

    print(json.dumps({"kernels": [
        {"name": "lin_kernel", "route": "cuda",
         "source": "mpc_quad_ros_tpu_torch/csrc/lin_kernel.cu",
         "replaces": "mpc_quad_ros_tpu/ops/pallas/lin_kernel.py:140",
         "launches": n10[0] + n40[0], **res_a},
        {"name": "sqp_fused_kernel", "route": "cuda",
         "source": "mpc_quad_ros_tpu_torch/csrc/sqp_fused_kernel.cu",
         "replaces": "mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py:291",
         "launches": n10[1], **res_b},
        {"name": "riccati_ipm", "route": "cuda",
         "source": "mpc_quad_ros_tpu_torch/csrc/riccati_ipm.cu",
         "replaces": "mpc_quad_ros_tpu/ops/pallas/riccati_kernel.py:54",
         "launches": n40[2], **res_c},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
