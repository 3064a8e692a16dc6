"""The headline benchmark line: batched MPC solves/s on one GPU.

Counterpart of the JAX package's root ``bench.py``, with its metric names:
solves/s of ``SQPSolver.solve_batch`` at the reference operating point (N=10,
1 s horizon, the RGP drag with 10 basis vectors per axis, "hybrid", 12 IPM
iterations) over B scenarios with the reference stepped 1-5 m along x,
`iters` chained warm-started solves timed 3 times; the latency of one
scenario's solve (50 chained solves per run, 20 runs, CUDA events; p99 is
the largest of the 20), which at B=1 takes the small-batch step (kernels A,
J and E) as ``bench.py``'s takes the JAX package's B < 128 route; the
closed learning loop; the operations per solve
and the utilisation against the card's f32 rate measured in the same run
(``phases.vpu_peak``, the shared-memory streaming rate).  The TPU's bf16
peak table and ``mfu_vs_bf16_mxu_peak`` are not carried over.

    python -m mpc_quad_ros_tpu_torch.bench.headline

Environment, as for ``bench.py``: BENCH_BATCH (65536), BENCH_ITERS (20),
BENCH_SKIP_CLOSED=1 skips the closed loop, BENCH_CLOSED_B (16384).
"""

from __future__ import annotations

import json
import os

import torch

from . import bounds
from .closed_loop import closed_loop
from .operating_point import N_BASIS, operating_point
from .phases import (analytic_vpu_flops, device_kind, executed_vpu_flops, resolve_device,
                     time_solves, vpu_peak)

TARGET_SOLVES_PER_S = 10000.0
LATENCY_CHAIN, LATENCY_RUNS = 50, 20


def one_scenario_latency(solver, carry, x0, y_ref, rgp, device,
                         method: str = "solve_batch") -> tuple[float, float]:
    """(p50, largest) ms per solve of the first scenario alone, chained:
    through ``solve_batch`` the small-batch step (kernels A, J, E), as
    ``bench.py``'s B=1 latency takes the JAX package's B < 128 route; through
    "solve" the per-scenario path on x0 of shape (13,)."""
    one = (lambda a: a[0]) if method == "solve" else (lambda a: a[:1])
    times, _ = time_solves(solver, carry.map(one), one(x0), one(y_ref), rgp.map(one),
                           LATENCY_CHAIN, device, LATENCY_RUNS, method=method)
    lat = sorted(t * 1e3 for t in times)
    return lat[len(lat) // 2], lat[-1]


def measure(B: int = 65536, iters: int = 20, skip_closed: bool = False, closed_B: int = 16384,
            device="cuda", peak: dict | None = None, reps: int = 3) -> dict:
    """The headline numbers as a dict (`peak`: a ``vpu_peak`` result of this
    run, measured here when None)."""
    dev = resolve_device(device)
    solver, carry, x0, y_ref, rgp = operating_point(B, dev)
    cfg = solver.cfg

    times, _ = time_solves(solver, carry, x0, y_ref, rgp, iters, dev, reps)
    solves_per_s = B * len(times) / sum(times)
    p50, p99 = one_scenario_latency(solver, carry, x0, y_ref, rgp, dev)

    closed = {}
    if not skip_closed:
        cl = closed_loop(B=closed_B, v=8.0, t_max=10.0, device=dev)
        closed = {"closed_loop_tick_solves_per_s": cl["tick_solves_per_s"],
                  "closed_loop_episodes": cl["episodes"], "closed_loop_ticks": cl["ticks"],
                  "closed_loop_err_mean_m": cl["err_mean_m"],
                  "closed_loop_err_p95_m": cl["err_p95_m"]}

    peak = peak or vpu_peak(dev)
    rate = peak["smem_streaming_f32_flops_per_s"]
    fps_exec = executed_vpu_flops(N=cfg.n_nodes, qp_iters=cfg.qp_iters)["total"]
    fps_naive = analytic_vpu_flops(N=cfg.n_nodes, nb=N_BASIS, qp_iters=cfg.qp_iters)["total"]
    fps_port = bounds.step_flops(cfg.n_nodes, N_BASIS, cfg.qp_iters)["total"]
    return {
        "metric": "batched MPC solves/s (N=10, RGP-augmented, 1 chip)",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / TARGET_SOLVES_PER_S,
        "latency_p50_ms": p50,
        "latency_p99_ms": p99,
        "latency_budget_ms": 10.0,
        # the JAX kernel's executed count (bench.py's numerator), the naive
        # convention, and the port's own count from its kernels' code
        "flops_per_solve_executed": fps_exec,
        "flops_per_solve_naive_convention": fps_naive,
        "flops_per_solve_port": fps_port,
        "executed_tflops": solves_per_s * fps_exec / 1e12,
        "effective_tflops_naive_convention": solves_per_s * fps_naive / 1e12,
        "port_tflops": solves_per_s * fps_port / 1e12,
        "vpu_utilization_vs_measured_sol": solves_per_s * fps_exec / rate,
        "port_utilization_vs_measured_sol": solves_per_s * fps_port / rate,
        "measured_smem_streaming_tflops": rate / 1e12,
        "measured_register_resident_tflops": peak["register_resident_tflops"],
        "device_kind": device_kind(dev),
        "card": peak["card"],
        "pipeline": cfg.pipeline,
        "batch": B,
        "chained_solves": iters,
        **closed,
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("headline: needs a CUDA device")
    print(json.dumps(measure(B=int(os.environ.get("BENCH_BATCH", 65536)),
                             iters=int(os.environ.get("BENCH_ITERS", 20)),
                             skip_closed=os.environ.get("BENCH_SKIP_CLOSED") == "1",
                             closed_B=int(os.environ.get("BENCH_CLOSED_B", 16384)))),
          flush=True)


if __name__ == "__main__":
    main()
