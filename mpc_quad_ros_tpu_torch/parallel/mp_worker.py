"""One process (rank) of the multi-process scenario farm.

Counterpart of ``mpc_quad_ros_tpu/parallel/mp_worker.py``.  Every rank runs
the same program: it joins the process group, builds only its own
contiguous scenario slice on its own device, runs `chain` warm-started
``solve_batch`` calls (the hybrid pipeline, kernels A and B from 128
scenarios a rank) with the metric sums all-reduced over the ranks, times
the step with `repeats` > 1, and with `ticks` > 0 runs the closed-loop
RGP-learning leg, ``run_episode`` on the rank's batch (kernels A and D from
128).  ``parallel/launch.py`` starts the ranks on one host:

    python -m mpc_quad_ros_tpu_torch.parallel.launch --nproc 2 --device cuda

and ``torchrun`` can start them too (its environment is the rendezvous):

    torchrun --nproc-per-node 2 -m mpc_quad_ros_tpu_torch.parallel.mp_worker \\
        --global-batch 131072 --qp-iters 12 --chain 3 --out shard.npz

(``--out`` gets the rank: ``shard.npz`` -> ``shard.rank0.npz``.)

The worker runs on the card unless given ``--device cpu``; a rank with no
card raises.  The dtype is float32, as in the JAX worker.  The inputs are
``build_inputs``, a copy of the JAX worker's numpy function: keyed by the
global scenario index only, so any slice, and the single-process oracle,
is bitwise the same in both packages.  The result (``.npz``) has the JAX
worker's keys, plus the backend and the rank's launch counts.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_inputs(global_B: int, n_nodes: int = 10, nb: int = 10,
                 dtype=np.float32):
    """Deterministic global scenario set: hover states with a per-scenario
    velocity offset and a shifted position reference.  Pure numpy keyed only
    by the global index — every process (and the oracle) reproduces any
    slice bit-identically."""
    i = np.arange(global_B, dtype=np.float64)
    x0 = np.zeros((global_B, 13), dtype)
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7] = np.asarray(np.sin(0.7 * i) * 1.5, dtype)
    x0[:, 8] = np.asarray(np.cos(1.3 * i) * 1.0, dtype)
    ref = x0.copy()
    ref[:, 0] += np.asarray(0.25 + 0.5 * np.sin(0.3 * i), dtype)
    y_ref = np.broadcast_to(ref[:, None, :], (global_B, n_nodes, 13)).copy()
    return x0, y_ref, ref


EPISODE_SAMPLES = 6   # the episode leg's trajectory: a 1 m line along x at 3 m


def episode_inputs(B: int) -> np.ndarray:
    """The episode leg's (B, EPISODE_SAMPLES, 13) reference, the JAX worker's."""
    xt = np.zeros((B, EPISODE_SAMPLES, 13), np.float32)
    xt[:, :, 3] = 1.0
    xt[:, :, 2] = 3.0
    xt[:, :, 0] = np.linspace(0, 1, EPISODE_SAMPLES, dtype=np.float32)[None, :]
    return xt


def solver_setup(qp_iters: int, device):
    """(params, MPCConfig, SQPSolver, RGP prior) of the worker: hummingbird in
    float32, u_ref at hover, 10 basis vectors over (-10, 10), theta (3, 0.1,
    0.01)."""
    from ..models import hummingbird_params, make_mpc_dynamics, rgp_init
    from ..ops.sqp import MPCConfig, SQPSolver

    p = hummingbird_params(dtype=torch.float32, device=device)
    cfg = MPCConfig(u_ref=float(p.hover_input), qp_iters=qp_iters)
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    rgp1 = rgp_init(torch.linspace(-10, 10, 10, dtype=torch.float32, device=device),
                    theta=(3.0, 0.1, 0.01))
    return p, cfg, solver, rgp1


def batch_rgp(rgp1, B: int):
    """The prior broadcast to (B, 3, ...)."""
    return rgp1.map(lambda a: a.expand((B, 3) + a.shape).contiguous())


def kernel_counters() -> dict:
    """The solver kernels' wrappers by kernel name, each with its launch
    count."""
    from ..ops.cuda import (condense_kernel, lin_kernel, qp_kernel, riccati_kernel,
                            sqp_fused_kernel)

    return {"lin_kernel": lin_kernel.linearize,
            "sqp_fused_kernel": sqp_fused_kernel.fused_sqp_from_J,
            "riccati_ipm": riccati_kernel.riccati_ipm_from_J,
            "condense_kernel": condense_kernel.condense_cost_from_J,
            "qp_kernel": qp_kernel.solve_box_qp_pdip_batch,
            "sqp_step_kernel": sqp_fused_kernel.fused_sqp_step,
            "condense_ab_kernel": condense_kernel.condense_cost_from_AB}


def _reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def _counts(prefix: str) -> dict:
    return {f"{prefix}_{k}": int(fn.launches) for k, fn in kernel_counters().items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_worker(num_processes: int, process_id: int, init_method: str | None,
               global_batch: int, qp_iters: int, out_path: str | None, ticks: int = 0,
               repeats: int = 1, chain: int = 1, device="cuda") -> dict:
    """Body of one rank; returns the result dict it also saves."""
    import torch.distributed as dist

    from ..loop import EpisodeConfig, run_episode
    from ..ops.sqp import init_carry
    from .distributed import (global_mesh, initialize, local_shard, make_global_batch,
                              process_slice, rank_device)
    from .mesh import sharded_step_fn

    backend = initialize(init_method, num_processes, process_id, device=device)
    dev = rank_device(device)
    mesh = global_mesh(device)
    p, cfg, solver, rgp1 = solver_setup(qp_iters, dev)

    # --- this rank's scenario slice only ---
    x0_g, y_ref_g, ref_g = build_inputs(global_batch, cfg.n_nodes)
    sl = process_slice(global_batch)
    x0_l = torch.as_tensor(x0_g[sl], device=dev)
    B_l = x0_l.shape[0]
    rgp_l = batch_rgp(rgp1, B_l)
    batch = make_global_batch(mesh, (init_carry(cfg, x0_l), x0_l, y_ref_g[sl], ref_g[sl], rgp_l))

    def step(b):
        carry, x0, y_ref, ref, rgp = b
        # `chain` warm-started RTI solves back to back (the tick chain)
        sol = None
        for _ in range(max(chain, 1)):
            carry, sol = solver.solve_batch(carry, x0, y_ref, ref, rgp)
        metrics = {"kkt_sum": sol.kkt_residual.sum(), "cost_sum": sol.cost.sum(),
                   "n": torch.tensor(float(x0.shape[0]), dtype=torch.float32, device=x0.device)}
        return (sol.U, sol.cost, sol.kkt_residual), metrics

    _reset_counts()
    sharded = sharded_step_fn(mesh, step)
    (U, cost, kkt), metrics = sharded(batch)
    _sync(dev)

    elapsed = None
    if repeats > 1:
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(repeats):
            (U, cost, kkt), metrics = sharded(batch)
        _sync(dev)
        dist.barrier()
        elapsed = (time.perf_counter() - t0) / repeats

    result = {
        "U_local": local_shard(U),
        "cost_local": local_shard(cost),
        "kkt_sum": float(metrics["kkt_sum"]),
        "cost_sum": float(metrics["cost_sum"]),
        "n": float(metrics["n"]),
        "process_id": process_id,
        "num_processes": num_processes,
        "n_devices_global": num_processes,
        "slice_start": sl.start,
        "backend": backend,
        "device": str(dev),
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        **_counts("launches_solve"),
    }
    if elapsed is not None:
        result["sec_per_step"] = elapsed
        result["solves_per_sec"] = global_batch * max(chain, 1) / elapsed

    # --- the closed-loop learning leg: run_episode on the rank's batch ---
    if ticks > 0:
        ecfg = EpisodeConfig(mpc=cfg)

        def ep_step(b):
            x0, traj, rgp = b
            _, outs = run_episode(ecfg, solver, p, x0, traj, ticks, rgp0=rgp)
            err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
            return outs.x_odom, {"ep_sq_err_sum": (err**2).sum(),
                                 "ep_n": torch.tensor(float(x0.shape[0]), dtype=torch.float32,
                                                      device=x0.device)}

        _reset_counts()
        ep_batch = make_global_batch(mesh, (x0_l, episode_inputs(B_l), rgp_l))
        x_hist, ep_metrics = sharded_step_fn(mesh, ep_step)(ep_batch)
        _sync(dev)
        result["ep_x_local"] = local_shard(x_hist)
        result["ep_sq_err_sum"] = float(ep_metrics["ep_sq_err_sum"])
        result["ep_n"] = float(ep_metrics["ep_n"])
        result.update(_counts("launches_episode"))

    if out_path:
        np.savez(out_path, **result)
    print(f"[mp_worker {process_id}/{num_processes}] OK: backend {backend} on {dev}, "
          f"local B={B_l}, kkt_sum={result['kkt_sum']:.3e}", flush=True)
    dist.destroy_process_group()
    return result


def main(argv=None):
    import os

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-method", default=None,
                    help="rendezvous (tcp://host:port, file:///path); default env://")
    ap.add_argument("--num-processes", type=int, default=None, help="default $WORLD_SIZE")
    ap.add_argument("--process-id", type=int, default=None, help="default $RANK")
    ap.add_argument("--global-batch", type=int, default=1024)
    ap.add_argument("--qp-iters", type=int, default=12)
    ap.add_argument("--ticks", type=int, default=0,
                    help="closed-loop MPC ticks for the episode leg (0 = skip)")
    ap.add_argument("--repeats", type=int, default=1,
                    help=">1: time the solve step (scaling harness mode)")
    ap.add_argument("--chain", type=int, default=1,
                    help="warm-started RTI solves chained per step")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="npz output path")
    a = ap.parse_args(argv)
    world = a.num_processes if a.num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = a.process_id if a.process_id is not None else int(os.environ["RANK"])
    out = a.out
    if out and a.process_id is None:
        root, ext = os.path.splitext(out)
        out = f"{root}.rank{rank}{ext or '.npz'}"
    run_worker(world, rank, a.init_method, a.global_batch, a.qp_iters, out, a.ticks,
               a.repeats, a.chain, a.device)


if __name__ == "__main__":
    main()
