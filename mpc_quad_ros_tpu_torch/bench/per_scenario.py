"""The per-scenario controller: one quadrotor's closed loop and its solve, as
the reference's simulation and its ROS node run them (one MPC solve a tick
for one drone; the JAX package's ``run.py`` and ``node.py``).

- ``episode``: ``run_episode`` for one hummingbird (the preset's drag) on the
  accelerating 10 m circle at v, RGP on (10 basis vectors per axis over
  (-v, v)), from hover at 3 m, one tick at a time (``carry0`` and
  ``start_tick``), each tick timed on the host clock up to a synchronise:
  the wall time a controller waits for its control;
- ``solve_latency``: 20 runs of 50 chained ``SQPSolver.solve`` calls on one
  scenario (x0 of shape (13,)) at the solve cell's operating point, N=10,
  timed by ``headline.one_scenario_latency`` (CUDA events on the card).

    python -m mpc_quad_ros_tpu_torch.bench.per_scenario
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..loop import EpisodeConfig, run_episode
from ..models import hummingbird_params, make_mpc_dynamics, rgp_init
from ..ops.sqp import MPCConfig, SQPSolver
from ..traj import circle_trajectory_accelerating, states_from_flat_outputs
from .headline import LATENCY_CHAIN, LATENCY_RUNS, one_scenario_latency
from .operating_point import N_BASIS, operating_point
from .phases import card, resolve_device

ERR_FROM_TICK = 30   # the closed loop's error skips the climb from 3 m


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentiles(seconds: list) -> tuple[float, float]:
    """(median, largest) in milliseconds: with 100 samples the largest is
    the p99."""
    ms = sorted(s * 1e3 for s in seconds)
    return ms[len(ms) // 2], ms[-1]


def episode(device="cuda", dtype=torch.float32, v: float = 8.0, t_max: float = 10.0) -> dict:
    """One episode, a tick a call: the tick's wall time (p50 and largest,
    ms), the tracking error from tick ERR_FROM_TICK on (mean and p95, m),
    whether every state and control is finite, and the controls' range."""
    dev = resolve_device(device)
    p = hummingbird_params(dtype=torch.float32).map(lambda a: a.to(dev, dtype))
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(p.hover_input.float())),
                        log_rgp_posterior=False)
    solver = SQPSolver(cfg.mpc, make_mpc_dynamics(p))
    _, pos, vel, _ = circle_trajectory_accelerating(10.0, v, t_max=t_max, dt=cfg.mpc.dt)
    traj = torch.as_tensor(states_from_flat_outputs(pos, vel), dtype=dtype, device=dev)
    x0 = torch.zeros(13, dtype=dtype, device=dev)
    x0[3] = 1.0
    x0[2] = 3.0
    basis = torch.linspace(-v, v, N_BASIS, dtype=dtype, device=dev).expand(3, N_BASIS)
    rgp = rgp_init(basis, theta=(3.0, 0.1, 0.01))
    carry, outs, ticks = None, [], []
    for i in range(traj.shape[0]):
        t0 = time.perf_counter()
        carry, out = run_episode(cfg, solver, p, x0, traj, 1, rgp, carry0=carry, start_tick=i)
        _sync(dev)
        ticks.append(time.perf_counter() - t0)
        outs.append(out)
    x_odom = torch.cat([o.x_odom for o in outs])
    x_ref = torch.cat([o.x_ref for o in outs])
    w_odom = torch.cat([o.w_odom for o in outs])
    err = (x_odom[ERR_FROM_TICK:, :3] - x_ref[ERR_FROM_TICK:, :3]).double().norm(dim=-1).cpu()
    p50, p99 = percentiles(ticks)
    return {"device": card() if dev.type == "cuda" else "cpu", "dtype": str(dtype), "v": v,
            "ticks": len(ticks), "tick_p50_ms": p50, "tick_p99_ms": p99,
            "err_mean_m": float(err.mean()), "err_p95_m": float(np.percentile(err.numpy(), 95)),
            "finite": bool(torch.isfinite(x_odom).all() and torch.isfinite(w_odom).all()),
            "u_min": float(w_odom.min()), "u_max": float(w_odom.max())}


def solve_latency(device="cuda") -> dict:
    """p50 and largest ms of one scenario's ``solve`` over LATENCY_RUNS runs
    of LATENCY_CHAIN chained solves (``headline.one_scenario_latency``)."""
    dev = resolve_device(device)
    solver, carry, x0, y_ref, rgp = operating_point(1, dev)
    p50, p99 = one_scenario_latency(solver, carry, x0, y_ref, rgp, dev, method="solve")
    return {"device": card() if dev.type == "cuda" else "cpu", "B": 1, "N": solver.cfg.n_nodes,
            "chained": LATENCY_CHAIN, "runs": LATENCY_RUNS, "solve_p50_ms": p50,
            "solve_p99_ms": p99}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("per_scenario: needs a CUDA device")
    print(json.dumps(solve_latency()), flush=True)
    print(json.dumps(episode()), flush=True)


if __name__ == "__main__":
    main()
