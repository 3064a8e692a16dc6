"""The measurement suite: one-solve latency, throughput against the batch,
the closed learning loop and the backend crossover.

Counterpart of ``mpc_quad_ros_tpu/bench/suite.py``; ``bench/headline.py``
prints the one headline line.  Entry points run on the card unless the
caller passes ``device="cpu"``.  The inputs are the JAX suite's
(``bench/suite.py:25-42``, ``phases._bench_setup``): hover at 3 m,
velocities U(-3, 3), y_ref = x0, RGP drag with 10 basis vectors per axis,
N=10, "hybrid".

    python -m mpc_quad_ros_tpu_torch.bench.suite --what latency
    python -m mpc_quad_ros_tpu_torch.bench.suite --what throughput
    python -m mpc_quad_ros_tpu_torch.bench.suite --what closed_loop
    python -m mpc_quad_ros_tpu_torch.bench.suite --what riccati_crossover
    python -m mpc_quad_ros_tpu_torch.bench.suite --what phases
    python -m mpc_quad_ros_tpu_torch.bench.suite --what scaling [--devices N] [--cpu]
    python -m mpc_quad_ros_tpu_torch.bench.suite --what scaling_multiprocess [--nproc N] [--cpu]

The two scaling harnesses are weak scaling: fixed work per shard or rank,
growing shard or rank counts.  Shards or ranks that share a device (CPU
shards, or more ranks than cards: two ranks on one H100) time-share it, so
their "efficiency" measures contention there, not scaling; the rows say so.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .closed_loop import closed_loop
from .crossover import crossover_row
from .phases import _bench_setup, device_kind, phase_table, resolve_device, time_solves

THROUGHPUT_BATCHES = (1024, 4096, 8192, 16384, 65536)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def latency(iters: int = 200, device="cuda", chained: int = 50) -> dict:
    """One scenario's solve (the small-batch step, as ``bench.py``'s B=1
    latency takes the JAX package's B < 128 route): host-clock percentiles of
    `iters` solves, each synchronised (what a control loop on the host waits
    for), and the device time per solve of `chained` chained solves."""
    dev = resolve_device(device)
    solver, carry, x0, y_ref, rgp = _bench_setup(1, dev)
    solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts) * 1e3
    dev_ms = time_solves(solver, carry, x0, y_ref, rgp, chained, dev)[0][0] * 1e3
    return {"metric": "single MPC solve latency", "device_kind": device_kind(dev),
            "p50_ms": float(np.percentile(ts, 50)), "p99_ms": float(np.percentile(ts, 99)),
            "mean_ms": float(ts.mean()), "device_ms_per_solve": dev_ms, "budget_ms": 10.0}


def throughput(batches=THROUGHPUT_BATCHES, iters: int = 10, device="cuda", reps: int = 3) -> list:
    """Warm-started solves chained `iters` at a time, `reps` chains per batch
    size after one untimed solve: ms per batched solve and solves/s."""
    dev = resolve_device(device)
    out = []
    for B in batches:
        solver, carry, x0, y_ref, rgp = _bench_setup(B, dev)
        dt = float(np.mean(time_solves(solver, carry, x0, y_ref, rgp, iters, dev, reps)[0]))
        out.append({"batch": B, "ms": dt * 1e3, "solves_per_s": B / dt,
                    "device_kind": device_kind(dev)})
    return out


def riccati_crossover(Ns=(10, 20, 40, 80, 160), B: int = 256, device="cuda",
                      reps: int = 3) -> list:
    """The condensed and Riccati backends' time per solve as the horizon
    grows (``bench/crossover.py``)."""
    return [crossover_row(B, N, reps, resolve_device(device)) for N in Ns]


def _shared(n: int, device) -> bool:
    """Whether n shards or ranks on `device` share one (the CPU, or more
    than the host's cards)."""
    dev = torch.device(device)
    return dev.type == "cpu" or torch.cuda.device_count() < n


def scaling(n_devices: int, episodes_per_device: int = 8, ticks: int = 10, device="cuda",
            reps: int = 3) -> list:
    """Weak scaling of the closed-loop learning step over a mesh of 1 ..
    `n_devices` shards (``parallel/mesh.py``), `episodes_per_device`
    episodes each, `ticks` ticks (the JAX ``suite.scaling``'s step: RGP drag
    with 8 basis vectors, 4 IPM iterations, hover at 3 m): tick-solves/s
    over `reps` steps after one untimed step.  ``make_mesh`` raises where
    the cards are fewer than `n_devices`; CPU shards share its cores."""
    from ..loop import EpisodeConfig, run_episode
    from ..models import hummingbird_params, make_mpc_dynamics, rgp_init
    from ..ops.sqp import MPCConfig, SQPSolver
    from ..parallel import make_mesh, shard_episode_batch, sharded_step_fn

    make_mesh(n_devices, device=device)
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(hummingbird_params().hover_input), qp_iters=4))
    results, base_rate = [], None
    for nd in range(1, n_devices + 1):
        mesh = make_mesh(nd, device=device)
        home = mesh.devices[0]
        # the model and solver on each card of the mesh
        models = {}
        for dev in mesh.devices:
            p = hummingbird_params(dtype=torch.float32, device=dev)
            models[dev] = (p, SQPSolver(cfg.mpc, make_mpc_dynamics(p)))
        rgp1 = rgp_init(torch.linspace(-5, 5, 8, dtype=torch.float32, device=home),
                        theta=(3.0, 0.1, 0.01))
        B = nd * episodes_per_device
        x0 = torch.zeros(B, 13, device=home)
        x0[:, 3], x0[:, 2] = 1.0, 3.0
        traj = x0[:, None].expand(B, ticks + cfg.mpc.n_nodes, 13).contiguous()
        rgp = rgp1.map(lambda a: a.expand((B, 3) + a.shape).contiguous())

        def step(batch):
            x0, tr, r = batch
            p, solver = models[x0.device]
            _, outs = run_episode(cfg, solver, p, x0, tr, ticks, rgp0=r)
            err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
            return outs.w_odom, {"sq": (err**2).sum()}

        fn = sharded_step_fn(mesh, step)
        batch = shard_episode_batch(mesh, (x0, traj, rgp))
        fn(batch)
        for dev in set(mesh.devices):
            _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            _, m = fn(batch)
        for dev in set(mesh.devices):
            _sync(dev)
        dt = (time.perf_counter() - t0) / reps
        rate = B * ticks / dt
        base_rate = rate if base_rate is None else base_rate
        results.append({"devices": nd, "episodes": B, "tick_solves_per_s": rate,
                        "weak_scaling_efficiency": rate / (base_rate * nd),
                        "sq_err_sum": float(m["sq"]), "device_kind": device_kind(home),
                        "shared_device": _shared(nd, device)})
    return results


def scaling_multiprocess(nproc: int = 2, batch_per_rank: int = 65536, qp_iters: int = 12,
                         repeats: int = 5, chain: int = 1, device="cuda") -> dict:
    """Weak scaling of the multi-process farm (``parallel/launch.py``): 1 ..
    `nproc` ranks, `batch_per_rank` scenarios each, the hybrid
    ``solve_batch`` timed over `repeats` steps of `chain` solves.  Where the
    ranks outnumber the cards (one H100: two ranks over gloo) or run on the
    CPU, they time-share the device and the efficiency measures contention,
    not scaling."""
    from ..parallel.launch import launch_workers, summary

    rows, base = [], None
    for n in range(1, nproc + 1):
        res = launch_workers(nproc=n, global_batch=batch_per_rank * n, qp_iters=qp_iters,
                             repeats=repeats, chain=chain, device=device)
        s = summary(res)
        base = s["solves_per_sec"] if base is None else base
        rows.append({"processes": n, "global_batch": batch_per_rank * n,
                     "backend": s["backend"], "device_kind": s["device_kind"],
                     "solves_per_s": s["solves_per_sec"],
                     "weak_scaling_efficiency": s["solves_per_sec"] / (base * n),
                     "shared_device": _shared(n, device)})
    shared = any(r["shared_device"] for r in rows)
    return {"metric": "multi-process weak scaling", "rows": rows,
            "note": ("ranks time-share a device: the efficiency measures contention, not scaling"
                     if shared else "one device a rank")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=("latency", "throughput", "closed_loop",
                                       "riccati_crossover", "phases", "scaling",
                                       "scaling_multiprocess"), default="latency")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size for --what scaling (default: every card; 2 with --cpu)")
    ap.add_argument("--nproc", type=int, default=2, help="ranks for --what scaling_multiprocess")
    ap.add_argument("--cpu", action="store_true", help="scaling on the CPU (shards share it)")
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else "cuda"
    n_dev = args.devices or (2 if args.cpu else max(torch.cuda.device_count(), 1))
    fn = {"latency": latency, "throughput": throughput,
          "closed_loop": lambda: closed_loop(B=1024),
          "riccati_crossover": riccati_crossover, "phases": phase_table,
          "scaling": lambda: scaling(n_dev, device=dev),
          "scaling_multiprocess": lambda: scaling_multiprocess(
              args.nproc, batch_per_rank=1024 if args.cpu else 65536, device=dev)}[args.what]
    print(json.dumps(fn(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
