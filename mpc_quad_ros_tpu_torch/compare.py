"""A/B comparison matrix: the reference's ``compare_trajectories.py``.

Counterpart of ``mpc_quad_ros_tpu/compare.py``.  Reads the run-matrix JSON
({"runs": [{gpe, trajectory, v_max, a_max}, ...]}), flies every run and
reports each run's mean position error against its peak velocity, gpe
against no gpe:

- ``run_matrix``: one ``run_sim`` a run, in-process;
- ``run_matrix_batched``: the whole matrix as one heterogeneous fused batch
  per gpe mode (mixed v_max: mixed trajectory lengths, through
  ``run_episode_batch_fused(traj_len=, episode_ticks=)``), float32.

Both write each run's log under `out_dir` and run on the card unless given
``device="cpu"`` (``--cpu``).

    python -m mpc_quad_ros_tpu_torch.compare --config matrix.json [--batched] [--plot out.png] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .io.config import SimConfig


def _log_name(c: SimConfig) -> str:
    return f"sim_{c.gpe}_trajectory{c.trajectory}_v_max{c.v_max:g}_a_max{c.a_max:g}.pkl"


def _row(c: SimConfig, x: np.ndarray, ref: np.ndarray, n_keep: int) -> dict:
    """A run's result over its first n_keep ticks (the last second of the
    trajectory, where it holds position, left out).  Where that second is
    no tick (n_nodes < t_lookahead) every tick is kept; the JAX package's
    ``x[:-0]`` keeps none there and its ``max`` raises."""
    e = np.linalg.norm(x[:n_keep, :3] - ref[:n_keep, :3], axis=1)
    return {"gpe": c.gpe, "trajectory": c.trajectory, "v_max": c.v_max, "a_max": c.a_max,
            "mean_rmse_pos": float(e.mean()),
            "v_peak": float(np.linalg.norm(x[:n_keep, 7:10], axis=1).max())}


def run_matrix(config_path: str, out_dir: str = "outputs/comparison", verbose: bool = True,
               device="cuda"):
    """Every run of the matrix through ``run_sim``, one after the other."""
    from .run import run_sim

    os.makedirs(out_dir, exist_ok=True)
    results = []
    for cfg in SimConfig.from_json(config_path):
        logger, outs, _ = run_sim(cfg, verbose=verbose, device=device)
        n_drop = int(1.0 / cfg.t_lookahead * cfg.n_nodes)
        x, ref = outs.x_odom.double().cpu().numpy(), outs.x_ref.double().cpu().numpy()
        results.append(_row(cfg, x, ref, len(x) - n_drop))
        logger.save_log(os.path.join(out_dir, _log_name(cfg)))
    return results


def run_matrix_batched(config_path: str, out_dir: str = "outputs/comparison",
                       verbose: bool = True, max_ticks: int | None = None,
                       gp_path: str | None = None, device="cuda"):
    """The matrix as one heterogeneous fused batch per gpe mode (the runs of
    a mode share a drag model, so they batch), with the rows of
    ``run_matrix``, each from its own masked episode.  `max_ticks` cuts
    every trajectory; `gp_path` is the model directory of the gpe-1 runs
    (the JSON names none)."""
    from .io.logger import Logger
    from .loop import EpisodeConfig, run_episode_batch_fused
    from .models.augmented import make_mpc_dynamics
    from .models.ensemble import GPEnsemble
    from .models.params import hummingbird_params
    from .ops.sqp import MPCConfig, SQPSolver
    from .run import build_trajectory
    from .utils.containers import stack_records
    from .utils.device import resolve_device

    dev = resolve_device(device)
    dtype = torch.float32
    runs = [c.clamp_limits() for c in SimConfig.from_json(config_path)]
    if gp_path is not None:
        runs = [dataclasses.replace(c, gp_path=gp_path) if c.gpe == 1 else c for c in runs]
    os.makedirs(out_dir, exist_ok=True)
    results = [None] * len(runs)
    t_start = time.perf_counter()

    by_gpe: dict[int, list[int]] = {}
    for i, c in enumerate(runs):
        by_gpe.setdefault(c.gpe, []).append(i)

    for gpe, idxs in sorted(by_gpe.items()):
        group = [runs[i] for i in idxs]
        n_nodes, t_look = group[0].n_nodes, group[0].t_lookahead
        if any(c.n_nodes != n_nodes or c.t_lookahead != t_look for c in group):
            raise ValueError(f"the gpe-{gpe} runs mix MPC horizons: one solver serves a batch")
        p = hummingbird_params(dtype=dtype, device=dev)
        mpc = MPCConfig(n_nodes=n_nodes, t_horizon=t_look, u_ref=float(p.hover_input))
        ecfg = EpisodeConfig(mpc=mpc, log_rgp_posterior=False)
        solver = SQPSolver(mpc, make_mpc_dynamics(p))
        x0 = torch.tensor([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=dev)

        trajs, tss = [], []
        for c in group:
            xt, ts = build_trajectory(c, x0[:3].cpu().numpy(), mpc.dt)
            trajs.append(xt[:max_ticks])
            tss.append(ts[:max_ticks])
        lens = [len(tr) for tr in trajs]
        B, T_max = len(group), max(lens)
        traj = np.zeros((B, T_max, 13))
        for b, tr in enumerate(trajs):
            traj[b, :len(tr)] = tr

        pb = p.map(lambda a: a.expand((B,) + a.shape).contiguous())
        rgpb = gp_aug = None
        if gpe == 2:
            # each run's basis spans its own (-v_max, v_max), as run_sim's
            rgpb = stack_records([
                GPEnsemble.fromrange([(-c.v_max, c.v_max)] * 3, c.n_basis, theta=c.rgp_theta,
                                     dtype=dtype, device=dev).state for c in group])
        elif gpe == 1:
            if not all(c.gp_path for c in group):
                raise ValueError("gp_path is required for the gpe-1 runs")
            gp_aug = GPEnsemble.fromdir(group[0].gp_path, "GP", device=dev).state

        len_t = torch.tensor(lens, device=dev)
        _, outs = run_episode_batch_fused(
            ecfg, solver, pb, x0.expand(B, 13).contiguous(),
            torch.as_tensor(traj, dtype=dtype, device=dev), T_max, rgpb, gp_aug=gp_aug,
            traj_len=len_t, episode_ticks=len_t)
        x, ref = outs.x_odom.double().cpu().numpy(), outs.x_ref.double().cpu().numpy()
        n_drop = int(1.0 / t_look * n_nodes)
        for b, (i, c) in enumerate(zip(idxs, group)):
            results[i] = _row(c, x[b], ref[b], lens[b] - n_drop)
            row = outs.map(lambda a: a[b, :lens[b]])
            Logger.from_episode(row, t_odom=tss[b]).save_log(os.path.join(out_dir, _log_name(c)))
    elapsed = time.perf_counter() - t_start
    if verbose:
        print(f"batched matrix: {len(runs)} runs in {elapsed:.2f}s "
              f"({len(by_gpe)} batched computations)")
    return results


def plot_results(results, save_path=None, show=False):
    """Mean position error against peak velocity, a colour per gpe mode
    (matplotlib, imported here)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 6), dpi=100)
    colors = {0: "b", 1: "r", 2: "g"}
    names = {0: "no_gpe", 1: "gpe", 2: "rgp"}
    for r in results:
        ax.scatter(r["v_peak"], r["mean_rmse_pos"], c=colors[r["gpe"]], label=names[r["gpe"]])
    handles, labels = ax.get_legend_handles_labels()
    uniq = dict(zip(labels, handles))
    ax.legend(uniq.values(), uniq.keys())
    ax.set_xlabel("peak velocity [m/s]")
    ax.set_ylabel("mean pos RMSE [m]")
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True, help="run-matrix JSON")
    parser.add_argument("--out_dir", type=str, default="outputs/comparison")
    parser.add_argument("--plot", type=str, default=None)
    parser.add_argument("--batched", action="store_true",
                        help="one heterogeneous batched computation per gpe mode")
    parser.add_argument("--gp_path", type=str, default=None,
                        help="GP model directory of the gpe-1 runs")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain versions); the default is the card")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.batched:
        results = run_matrix_batched(args.config, args.out_dir, gp_path=args.gp_path,
                                     device=device)
    else:
        results = run_matrix(args.config, args.out_dir, device=device)
    for r in results:
        print(r)
    if args.plot:
        plot_results(results, save_path=args.plot)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
