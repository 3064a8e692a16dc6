"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device -> exit 1 (there is no CPU fallback);
2. build: nvcc compiles ``mpc_quad_ros_tpu_torch/csrc/*.cu`` (timed);
3. kernel A (RK4 linearisation) against its plain PyTorch version, in f32
   and against the f64 plain version, at the main-path shapes;
4. kernel B (condense + IPM + KKT + dX) against the f64 plain version, the
   KKT floor, and NaN isolation between scenarios;
5. the slice: ``SQPSolver.solve_batch`` at B=65536, 20 chained warm-started
   solves (solves/s), one-scenario latency (p50/p99 of 20 runs of 50 chained
   solves, CUDA events), and agreement with the f64 CPU solve on a small batch;
6. the closed learning loop: 16384 episodes x 100 ticks on the accelerating
   circle at 8 m/s (tick-solves/s, tracking error from tick 30 on).

The launch counters are reset just before phases 5-6 and must show both
kernels launched there; the plain versions are fenced off during those
phases.  The line before the last lists every kernel; the last line is the
device summary.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mpc_quad_ros_tpu_torch.bench.closed_loop import closed_loop  # noqa: E402
from mpc_quad_ros_tpu_torch.models import (fold_drag, hummingbird_params,  # noqa: E402
                                           make_mpc_dynamics, rgp_init)
from mpc_quad_ros_tpu_torch.ops.cuda import _build, lin_kernel, sqp_fused_kernel  # noqa: E402
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver, init_carry  # noqa: E402

SOLVE_B = 65536
CLOSED_B = 16384
N_NB = 10
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
# The closed loop's tracking error: about twice the physics figure of the
# JAX benchmark's run of the same scenario (0.022 m).
ERR_MEAN_TOL = 0.05


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def bench_inputs(B: int, device, dtype=torch.float32, seed: int = 0, mu_scale: float = 0.0):
    """The benchmark's operating point: hover at 3 m with velocities U(-3, 3),
    reference stepped 1-5 m along x over the horizon, RGP drag with 10 basis
    vectors per axis (mean mu_scale * N(0, 1), 0 in the benchmark).  Drawn in
    f64 and rounded to f32 whatever `dtype` is, so an f64 run sees the very
    inputs of the f32 one."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    f64 = torch.float64
    p = hummingbird_params(dtype=torch.float32).map(lambda a: a.to(device, dtype))
    cfg = MPCConfig(u_ref=float(p.hover_input.float()))
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    N = cfg.n_nodes
    x0 = torch.zeros((B, 13), dtype=f64)
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7:10] += -3.0 + 6.0 * torch.rand((B, 3), generator=gen, dtype=f64)
    y_ref = x0[:, None, :].repeat(1, N, 1)
    step = 1.0 + 4.0 * torch.rand((B, 1), generator=gen, dtype=f64)
    y_ref[:, :, 0] += torch.linspace(0, 1, N, dtype=f64)[None, :] * step
    basis = torch.linspace(-10, 10, N_NB, dtype=f64).expand(B, 3, N_NB)
    rgp = rgp_init(basis, theta=(3.0, 0.1, 0.01))
    rgp = rgp.replace(mu_g=mu_scale * torch.randn((B, 3, N_NB), generator=gen, dtype=f64))
    cast = lambda a: a.float().to(device, dtype)
    x0, y_ref, rgp = cast(x0), cast(y_ref), rgp.map(cast)
    return solver, init_carry(cfg, x0), x0, y_ref, rgp


def kernel_inputs(B: int, device):
    """Kernel A's and kernel B's inputs as the main path forms them: one
    warm-up solve, then the glue of the next Gauss-Newton step."""
    solver, carry, x0, y_ref, rgp = bench_inputs(B, device, mu_scale=0.3)
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


def phase_slice(device) -> dict:
    iters, reps = 20, 3
    solver, carry0, x0, y_ref, rgp = bench_inputs(SOLVE_B, device)

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
    solver, carry, x0, y_ref, rgp = bench_inputs(B, device, mu_scale=0.3)
    _, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    s64, c64, x64, y64, r64 = bench_inputs(B, "cpu", torch.float64, mu_scale=0.3)
    _, ref = s64.solve_batch(c64, x64, y64, y64[:, -1], r64)
    du = (sol.U.double().cpu() - ref.U).abs().max().item()
    emit("slice_vs_cpu_f64", B=B, max_abs_dU=du, tol=QP_Z_TOL)
    check(du < QP_Z_TOL, f"slice: card f32 vs CPU f64 max |dU| = {du}")


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


def main() -> None:
    phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    res_a = phase_kernel_a(device)
    res_b = phase_kernel_b(device)
    phase_slice_vs_cpu(device)

    # the main path: counters from 0, plain versions fenced off
    saved = lin_kernel.linearize_plain, sqp_fused_kernel.fused_sqp_from_J_plain
    lin_kernel.linearize_plain = _fenced("lin_kernel")
    sqp_fused_kernel.fused_sqp_from_J_plain = _fenced("sqp_fused_kernel")
    lin_kernel.linearize.launches = 0
    sqp_fused_kernel.fused_sqp_from_J.launches = 0
    try:
        phase_slice(device)
        phase_closed_loop(device)
    finally:
        lin_kernel.linearize_plain, sqp_fused_kernel.fused_sqp_from_J_plain = saved
    launches_a = lin_kernel.linearize.launches
    launches_b = sqp_fused_kernel.fused_sqp_from_J.launches
    check(launches_a > 0 and launches_b > 0,
          f"main path launched lin {launches_a} / sqp {launches_b} times")

    print(json.dumps({"kernels": [
        {"name": "lin_kernel", "route": "cuda",
         "source": "mpc_quad_ros_tpu_torch/csrc/lin_kernel.cu",
         "replaces": "mpc_quad_ros_tpu/ops/pallas/lin_kernel.py:140",
         "launches": launches_a, **res_a},
        {"name": "sqp_fused_kernel", "route": "cuda",
         "source": "mpc_quad_ros_tpu_torch/csrc/sqp_fused_kernel.cu",
         "replaces": "mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py:291",
         "launches": launches_b, **res_b},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
