"""Iterative exploration runner: the reference's ``explore_trajectories.py``.

Counterpart of ``mpc_quad_ros_tpu/explore.py``: each round flies a random
trajectory at the current exploration velocity (``run_sim``; gp0 first, then
gp1 with the last round's model), trains a GP on the flight's log
(``train_gp``) and asks the ``Explorer`` for the next velocity.  It runs on
the card unless given ``device="cpu"`` (``--cpu``).

    python -m mpc_quad_ros_tpu_torch.explore [--rounds 5] [--out_dir DIR] [--v_start 10] [--cpu]
"""

from __future__ import annotations

import argparse
import os

from .explorer import Explorer
from .io.config import SimConfig


def explore(rounds: int = 5, out_dir: str = "outputs/exploration", v_start: float = 10.0,
            trajectory: int = 1, verbose: bool = True, device="cuda"):
    from .models.train import train_gp
    from .run import run_sim

    os.makedirs(out_dir, exist_ok=True)
    model_dir = os.path.join(out_dir, "gp_models")
    gpe = None
    v = v_start
    history = []
    for rnd in range(rounds):
        cfg = SimConfig(gpe=0 if gpe is None else 1, trajectory=trajectory, v_max=v, a_max=v,
                        seed=rnd, gp_path=model_dir if gpe else None)
        logger, _, extras = run_sim(cfg, verbose=verbose, device=device)
        log_path = logger.save_log(os.path.join(out_dir, f"exploration_dataset_run_{rnd + 1}.pkl"))
        gpe = train_gp(log_path, model_dir, plot=False, device=device)
        history.append({"round": rnd, "v_max": v, "rmse": extras["rmse"]})
        v = Explorer(gpe).velocity_to_explore
        if verbose:
            print(f"round {rnd}: flew v_max={history[-1]['v_max']:.1f}, "
                  f"next exploration velocity {v:.1f}")
    return history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--out_dir", type=str, default="outputs/exploration")
    parser.add_argument("--v_start", type=float, default=10.0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain versions); the default is the card")
    args = parser.parse_args(argv)
    for h in explore(args.rounds, args.out_dir, args.v_start,
                     device="cpu" if args.cpu else "cuda"):
        print(h)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
