"""Closed-loop simulation CLI: the reference's ``execute_trajectory.py``.

Counterpart of ``mpc_quad_ros_tpu/run.py``, with its flags:

    python -m mpc_quad_ros_tpu_torch.run --gpe 2 --trajectory 2 --v_max 10 --a_max 10 [--batch N] [--cpu]

--gpe 0: nominal MPC, 1: the pretrained GP in --gp_path (a model directory
of ``models/train.py``, or one the JAX package wrote), 2: the online RGP.
--trajectory 0: the waypoint file ($MPCQUAD_WAYPOINTS, else the package's
``data/user_defined_waypoints.csv``), 1: random waypoints, 2: the
accelerating circle; 0 and 1 through the numpy min-snap.  -o writes the
episode log (the reference's keys; episode 0 of a batch).  float32 unless
$MPCQUAD_X64 is set.

One drone (--batch 1) flies ``run_episode`` (kernels A and J); a batch of
drones with per-episode drag drawn from a ``torch.Generator`` seeded with
--seed flies ``run_episode_batch`` below 32 (kernels A and D) and
``run_episode_batch_fused`` from 32 (kernels A and B).  It runs on the card
unless --cpu is given (the plain versions).  -p writes the tracking report
(``io.viz.Visualiser.plot_data``, matplotlib on the Agg backend).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .io.config import SimConfig

# the batch from which the fused loop (solve_batch) flies the scenarios
FUSED_MIN_BATCH = 32


def build_trajectory(cfg: SimConfig, x0_pos, mpc_dt: float):
    """The episode's reference: (x_traj (T, 13), t (T,))."""
    from .traj import (circle_trajectory_accelerating, min_snap_trajectory, random_waypoints,
                       sample_polynomial_trajectory, states_from_flat_outputs)

    if cfg.trajectory == 2:
        # the circle: radius 10 m, 30 s
        ts, pos, vel, _ = circle_trajectory_accelerating(10.0, cfg.v_max, t_max=30.0, dt=mpc_dt)
        return states_from_flat_outputs(pos, vel), ts
    if cfg.trajectory == 1:
        # random waypoints: half-size 30 m, 10 of them
        wp = random_waypoints(hsize=30.0, num_waypoints=10, start_point=np.asarray(x0_pos),
                              seed=cfg.seed)
    elif cfg.trajectory == 0:
        path = os.environ.get("MPCQUAD_WAYPOINTS", os.path.join(
            os.path.dirname(__file__), "data", "user_defined_waypoints.csv"))
        wp = np.loadtxt(path, delimiter=",", ndmin=2)[:, :3]
    else:
        raise ValueError(f"invalid trajectory type {cfg.trajectory}")
    poly = min_snap_trajectory(wp, cfg.v_max, cfg.a_max, backend="python")
    ts, pos, vel, _ = sample_polynomial_trajectory(poly, mpc_dt)
    return states_from_flat_outputs(pos, vel), ts


def run_sim(cfg: SimConfig, verbose: bool = True, device="cuda"):
    """Build everything and fly the closed loop: (logger, outputs, extras
    with the elapsed seconds, the tracking RMSE and the trajectory's times)."""
    from .io.logger import Logger
    from .loop import (EpisodeConfig, run_episode, run_episode_batch, run_episode_batch_fused,
                       tracking_rmse)
    from .models.augmented import make_mpc_dynamics
    from .models.ensemble import GPEnsemble
    from .models.params import (crazyflie_params, default_params, hummingbird_params,
                                randomize_params)
    from .ops.sqp import MPCConfig, SQPSolver
    from .utils.device import resolve_device

    cfg = cfg.clamp_limits()
    dev = resolve_device(device)
    dtype = torch.float64 if os.environ.get("MPCQUAD_X64") else torch.float32
    quad_mk = {"hummingbird": hummingbird_params, "default": default_params,
               "crazyflie": crazyflie_params}[cfg.quad]
    p = quad_mk(dtype=dtype, device=dev, payload=cfg.payload)

    mpc = MPCConfig(n_nodes=cfg.n_nodes, t_horizon=cfg.t_lookahead, u_ref=float(p.hover_input))
    # the full RGP posterior (C_g is (3, nb, nb) a tick) is logged for runs
    # a human looks at; large batches skip it
    ecfg = EpisodeConfig(mpc=mpc, simulation_dt=cfg.simulation_dt,
                         log_rgp_posterior=cfg.batch <= 8)
    solver = SQPSolver(mpc, make_mpc_dynamics(p))
    x0 = torch.tensor([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=dev)
    x_traj_np, t_traj = build_trajectory(cfg, x0[:3].cpu().numpy(), mpc.dt)
    x_traj = torch.as_tensor(x_traj_np, dtype=dtype, device=dev)
    n_ticks = x_traj.shape[0]

    rgp0 = gp_aug = None
    if cfg.gpe == 1:
        if not cfg.gp_path:
            raise ValueError("--gp_path is required for --gpe 1")
        # the GP in the files' dtype: the loops fold it once, then cast
        gp_aug = GPEnsemble.fromdir(cfg.gp_path, "GP", device=dev).state
    elif cfg.gpe == 2:
        if cfg.gp_from_file:
            gpe = GPEnsemble.fromdir(cfg.gp_path, "RGP", device=dev)
        else:
            gpe = GPEnsemble.fromrange([(-cfg.v_max, cfg.v_max)] * 3, cfg.n_basis,
                                       theta=cfg.rgp_theta, dtype=dtype, device=dev)
        rgp0 = gpe.state.map(lambda a: a.to(dtype))

    if verbose:
        print(f"Optimizer MPC lookahead={cfg.t_lookahead}s, nodes={cfg.n_nodes}, "
              f"trajectory {n_ticks} ticks, gpe={cfg.gpe}, batch={cfg.batch}, device={dev}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    if cfg.batch > 1:
        B = cfg.batch
        pb = randomize_params(p, B, generator=torch.Generator(device="cpu").manual_seed(cfg.seed))
        x0b = x0.expand(B, 13).contiguous()
        trajb = x_traj.expand((B,) + x_traj.shape)
        rgpb = None if rgp0 is None else rgp0.map(lambda a: a.expand((B,) + a.shape))
        loop = run_episode_batch_fused if B >= FUSED_MIN_BATCH else run_episode_batch
        _, outs = loop(ecfg, solver, pb, x0b, trajb, n_ticks, rgpb, gp_aug=gp_aug)
        sync()
        elapsed = time.perf_counter() - t0
        rmse = tracking_rmse(outs).double().cpu().numpy()
        if verbose:
            print(f"{B} episodes x {n_ticks} ticks in {elapsed:.2f}s "
                  f"({B * n_ticks / elapsed:.0f} solves/s); rmse mean={rmse.mean():.3f} m "
                  f"min={rmse.min():.3f} max={rmse.max():.3f}")
        logger = Logger.from_episode(outs.map(lambda a: a[0]), t_odom=t_traj[:n_ticks],
                                     filepath=cfg.output, solve_time_s=elapsed / B)
        return logger, outs, {"elapsed": elapsed, "rmse": rmse, "t": t_traj}

    _, outs = run_episode(ecfg, solver, p, x0, x_traj, n_ticks, rgp0=rgp0, gp_aug=gp_aug)
    sync()
    elapsed = time.perf_counter() - t0
    rmse = float(tracking_rmse(outs))
    if verbose:
        print(f"episode: {n_ticks} ticks in {elapsed:.2f}s; RMSE pos = {rmse:.3f} m")
    logger = Logger.from_episode(outs, t_odom=t_traj[:n_ticks], filepath=cfg.output,
                                 solve_time_s=elapsed)
    return logger, outs, {"elapsed": elapsed, "rmse": rmse, "t": t_traj}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-o", "--output", type=str, default=None, help="Output data file (.pkl)")
    parser.add_argument("-p", "--plot_output", type=str, default=None, help="Output plot file")
    parser.add_argument("--gpe", type=int, required=True, choices=(0, 1, 2))
    parser.add_argument("--trajectory", type=int, required=True, choices=(0, 1, 2),
                        help="0 waypoint file, 1 random waypoints, 2 circle")
    parser.add_argument("--v_max", type=float, required=True)
    parser.add_argument("--a_max", type=float, required=True)
    parser.add_argument("--show", type=int, default=0)
    parser.add_argument("--batch", type=int, default=1, help="scenario batch size")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quad", type=str, default="hummingbird",
                        choices=("hummingbird", "default", "crazyflie"))
    parser.add_argument("--payload", action="store_true")
    parser.add_argument("--n_basis", type=int, default=10)
    parser.add_argument("--n_nodes", type=int, default=10)
    parser.add_argument("--t_lookahead", type=float, default=1.0)
    parser.add_argument("--gp_path", type=str, default=None)
    parser.add_argument("--gp_from_file", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain versions); the default is the card")
    args = parser.parse_args(argv)

    cfg = SimConfig(
        gpe=args.gpe, trajectory=args.trajectory, v_max=args.v_max, a_max=args.a_max,
        output=args.output, plot_output=args.plot_output, show=bool(args.show),
        batch=args.batch, seed=args.seed, quad=args.quad, payload=args.payload,
        n_basis=args.n_basis, n_nodes=args.n_nodes, t_lookahead=args.t_lookahead,
        gp_path=args.gp_path, gp_from_file=args.gp_from_file,
    )
    logger, _, _ = run_sim(cfg, device="cpu" if args.cpu else "cuda")
    if args.output:
        print(f"Saving trajectory to {logger.save_log()}")
    if args.plot_output or args.show:
        from .io.viz import Visualiser

        Visualiser.from_logger(logger).plot_data(save_path=args.plot_output, show=bool(args.show))
    return 0


if __name__ == "__main__":
    sys.exit(main())
