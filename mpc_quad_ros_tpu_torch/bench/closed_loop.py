"""The closed-loop learning scenario of the benchmark.  Counterpart of
``mpc_quad_ros_tpu/bench/suite.py::closed_loop``: B episodes with
per-episode randomised drag (scales U(0.5, 2)) and per-episode RGP state
track the accelerating 10 m-radius circle at v for t_max seconds, one MPC
tick per 0.1 s, through the fused loop (``solve_batch``) or, with
`per_scenario`, ``run_episode_batch`` (the per-scenario ``solve``).  The
MPC's drag model is the online RGP (gp2), or with `drag` none (gp0) or a
pretrained GP shared by the episodes (gp1).

``velocity_error_covariances`` reads the paper's learning metric off each
episode of a run.

``hetero_closed_loop`` runs the fused loop on a heterogeneous batch: each
episode draws v_max from (4, 8, 12) m/s and flies the accelerating circle
for HETERO_PATH_M metres (its own trajectory length and tick count, as the
JAX comparison matrix's batched runs do, ``mpc_quad_ros_tpu/compare.py:
56-138``).  ``skip_closed_loop`` runs `ticks` ticks with control_skip = 10
on the circle sampled 10x finer and on its every tenth sample."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..io.viz import Visualiser
from ..loop import (EpisodeConfig, run_episode_batch, run_episode_batch_fused,
                    tracking_rmse_masked)
from ..models.augmented import make_mpc_dynamics
from ..models.params import hummingbird_params, randomize_params
from ..models.rgp import rgp_init
from ..ops.sqp import MPCConfig, SQPSolver
from ..traj import circle_trajectory_accelerating, states_from_flat_outputs


N_BASIS = 10       # RGP basis vectors per axis
WARMUP_TICKS = 2   # a short untimed run first: library load, allocator
HETERO_V_MAX = (4.0, 8.0, 12.0)
HETERO_PATH_M = 40.0


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
                seed: int = 0, per_scenario: bool = False, drag="rgp", err_from: int = 30,
                outputs: bool = False):
    """Run the scenario once short and once in full; time the full run.  The
    tracking error is taken from tick `err_from` on (30, as in the JAX
    benchmark).  `drag`: "rgp" (gp2), None (gp0) or a GP record with a
    leading (3,) axis (gp1).  Returns the summary, and with `outputs` the
    full run's ``EpisodeOutput`` beside it."""
    cfg, solver, pb, x0, traj, rgp = setup(B, v, t_max, device, seed)
    T = traj.shape[1]
    loop = run_episode_batch if per_scenario else run_episode_batch_fused
    learn = drag == "rgp"
    rgp0, gp_aug = (rgp, None) if learn else (None, drag)
    loop(cfg, solver, pb, x0, traj, WARMUP_TICKS, rgp0, gp_aug)
    _sync(device)
    t0 = time.perf_counter()
    _, outs = loop(cfg, solver, pb, x0, traj, T, rgp0, gp_aug)
    _sync(device)
    dt = time.perf_counter() - t0
    err = np.linalg.norm((outs.x_odom[:, err_from:, :3] - outs.x_ref[:, err_from:, :3])
                         .double().cpu().numpy(), axis=2)
    summary = {
        "metric": "closed-loop learning throughput",
        "device": (torch.cuda.get_device_name(device)
                   if torch.device(device).type == "cuda" else "cpu"),
        "loop": loop.__name__, "drag": "gp2" if learn else "gp0" if drag is None else "gp1",
        "episodes": B, "ticks": T, "err_from_tick": err_from,
        "tick_solves_per_s": B * T / dt,
        "err_mean_m": float(err.mean()),
        "err_p95_m": float(np.percentile(err, 95)),
    }
    return (summary, outs) if outputs else summary


def velocity_error_covariances(outs) -> np.ndarray:
    """(B, 3): each episode's cov(v_axis, position error_axis) over its
    ticks, ``Visualiser.velocity_error_covariance`` (the paper's learning
    metric)."""
    x = outs.x_odom.double().cpu().numpy()
    r = outs.x_ref.double().cpu().numpy()
    return np.stack([Visualiser({"x_odom": x[b], "x_ref": r[b]}).velocity_error_covariance()
                     for b in range(x.shape[0])])


def hetero_setup(B: int, device="cuda", seed: int = 0, path_m: float = HETERO_PATH_M):
    """(cfg, solver, plant params, x0, padded trajectories, traj_len, RGP
    state, v_max) of the heterogeneous batch, in float32: v_max drawn from
    HETERO_V_MAX, each circle `path_m` long from its own start state, the
    RGP basis over (-v_max, v_max)."""
    dtype = torch.float32
    cfg, solver, pb, _, _, _ = setup(B, device=device, seed=seed)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    pick = torch.randint(len(HETERO_V_MAX), (B,), generator=gen)
    trajs = []
    for v in HETERO_V_MAX:
        _, pos, vel, _ = circle_trajectory_accelerating(10.0, v, t_max=path_m / v,
                                                        dt=cfg.mpc.dt)
        trajs.append(torch.as_tensor(states_from_flat_outputs(pos, vel), dtype=dtype))
    lens = torch.tensor([len(tr) for tr in trajs])
    T = int(lens.max())
    padded = torch.stack([torch.cat([tr, tr[-1:].expand(T - len(tr), 13)]) for tr in trajs])
    traj = padded[pick].to(device)
    v_max = torch.tensor(HETERO_V_MAX, dtype=dtype)[pick]
    basis = (torch.linspace(-1, 1, N_BASIS, dtype=dtype) * v_max[:, None]).to(device)
    rgp = rgp_init(basis[:, None].expand(B, 3, N_BASIS), theta=(3.0, 0.1, 0.01))
    return cfg, solver, pb, traj[:, 0].contiguous(), traj, lens[pick].to(device), rgp, v_max


def hetero_closed_loop(B: int = 1024, device="cuda", seed: int = 0,
                       path_m: float = HETERO_PATH_M) -> tuple[dict, object, object]:
    """The heterogeneous batch once short and once in full (traj_len and
    episode_ticks each episode's own trajectory length), the full run timed:
    (summary, final carry, outputs).  The error is the masked RMSE over each
    episode's active ticks."""
    cfg, solver, pb, x0, traj, lens, rgp, v_max = hetero_setup(B, device, seed, path_m)
    T = traj.shape[1]
    run_episode_batch_fused(cfg, solver, pb, x0, traj, WARMUP_TICKS, rgp, traj_len=lens,
                            episode_ticks=lens)
    _sync(device)
    t0 = time.perf_counter()
    final, outs = run_episode_batch_fused(cfg, solver, pb, x0, traj, T, rgp, traj_len=lens,
                                          episode_ticks=lens)
    _sync(device)
    dt = time.perf_counter() - t0
    rmse = tracking_rmse_masked(outs).double().cpu().numpy()
    by_v = {f"rmse_mean_m_at_{v:g}": float(rmse[(v_max == v).numpy()].mean())
            for v in HETERO_V_MAX}
    return ({"loop": "run_episode_batch_fused (traj_len, episode_ticks)", "episodes": B,
             "ticks": T, "path_m": path_m,
             "active_tick_solves_per_s": float(lens.sum()) / dt,
             "rmse_mean_m": float(rmse.mean()), "rmse_max_m": float(rmse.max()), **by_v},
            final, outs)


def skip_closed_loop(B: int = 1024, ticks: int = 10, device="cuda", seed: int = 0) -> dict:
    """`ticks` ticks of the fused loop with control_skip = 10 on the 8 m/s
    circle sampled at 0.01 s, and with control_skip = 1 on its every tenth
    sample (the same references): whether the two runs are bitwise equal."""
    cfg, solver, pb, x0, _, rgp = setup(B, device=device, seed=seed)
    _, pos, vel, _ = circle_trajectory_accelerating(10.0, 8.0, t_max=10.0, dt=cfg.mpc.dt / 10)
    fine = torch.as_tensor(states_from_flat_outputs(pos, vel), dtype=torch.float32,
                           device=device)
    fine = fine.expand((B,) + fine.shape)
    cfg10 = EpisodeConfig(mpc=cfg.mpc, control_skip=10, log_rgp_posterior=False)
    _, a = run_episode_batch_fused(cfg10, solver, pb, x0, fine, ticks, rgp)
    _, b = run_episode_batch_fused(cfg, solver, pb, x0, fine[:, ::10], ticks, rgp)
    same = all(torch.equal(va, getattr(b, k)) for k, va in a.fields().items() if va is not None)
    return {"episodes": B, "ticks": ticks, "fine_samples": fine.shape[1],
            "bitwise_equal_to_coarse": same,
            "finite": bool(torch.isfinite(a.x_odom).all() and torch.isfinite(a.w_odom).all())}
