"""The closed-loop learning scenario of the benchmark.  Counterpart of
``mpc_quad_ros_tpu/bench/suite.py::closed_loop``: B episodes with
per-episode randomised drag (scales U(0.5, 2)) and per-episode RGP state
track the accelerating 10 m-radius circle at v for t_max seconds, one MPC
tick per 0.1 s."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..loop import EpisodeConfig, run_episode_batch_fused
from ..models.augmented import make_mpc_dynamics
from ..models.params import hummingbird_params, randomize_params
from ..models.rgp import rgp_init
from ..ops.sqp import MPCConfig, SQPSolver
from ..traj import circle_trajectory_accelerating, states_from_flat_outputs


N_BASIS = 10       # RGP basis vectors per axis
WARMUP_TICKS = 2   # a short untimed run first: library load, allocator


def setup(B: int, v: float = 8.0, t_max: float = 10.0, device="cuda", seed: int = 0):
    """(cfg, solver, plant params, x0, trajectories, RGP state) of the
    scenario, in float32."""
    dtype = torch.float32
    p1 = hummingbird_params(dtype=dtype, device=device)
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(p1.hover_input)),
                        log_rgp_posterior=False)
    solver = SQPSolver(cfg.mpc, make_mpc_dynamics(p1))
    _, pos, vel, _ = circle_trajectory_accelerating(10.0, v, t_max=t_max, dt=cfg.mpc.dt)
    x_traj = torch.as_tensor(states_from_flat_outputs(pos, vel), dtype=dtype, device=device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pb = randomize_params(p1, B, generator=gen)
    x0 = torch.zeros((B, 13), dtype=dtype, device=device)
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    traj = x_traj.expand((B,) + x_traj.shape)
    basis = torch.linspace(-v, v, N_BASIS, dtype=dtype, device=device).expand(3, N_BASIS)
    rgp = rgp_init(basis, theta=(3.0, 0.1, 0.01)).map(lambda a: a.expand((B,) + a.shape))
    return cfg, solver, pb, x0, traj, rgp


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(B: int = 1024, v: float = 8.0, t_max: float = 10.0, device="cuda",
                seed: int = 0) -> dict:
    """Run the scenario once short and once in full; time the full run.  The
    tracking error is taken from tick 30 on, as in the JAX benchmark."""
    cfg, solver, pb, x0, traj, rgp = setup(B, v, t_max, device, seed)
    T = traj.shape[1]
    run_episode_batch_fused(cfg, solver, pb, x0, traj, WARMUP_TICKS, rgp)
    _sync(device)
    t0 = time.perf_counter()
    _, outs = run_episode_batch_fused(cfg, solver, pb, x0, traj, T, rgp)
    _sync(device)
    dt = time.perf_counter() - t0
    err = np.linalg.norm(
        (outs.x_odom[:, 30:, :3] - outs.x_ref[:, 30:, :3]).double().cpu().numpy(), axis=2)
    return {
        "metric": "closed-loop learning throughput",
        "device": (torch.cuda.get_device_name(device)
                   if torch.device(device).type == "cuda" else "cpu"),
        "episodes": B, "ticks": T,
        "tick_solves_per_s": B * T / dt,
        "err_mean_m": float(err.mean()),
        "err_p95_m": float(np.percentile(err, 95)),
    }
