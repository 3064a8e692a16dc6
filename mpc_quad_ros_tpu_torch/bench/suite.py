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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=("latency", "throughput", "closed_loop",
                                       "riccati_crossover", "phases"), default="latency")
    args = ap.parse_args(argv)
    fn = {"latency": latency, "throughput": throughput,
          "closed_loop": lambda: closed_loop(B=1024),
          "riccati_crossover": riccati_crossover, "phases": phase_table}[args.what]
    print(json.dumps(fn(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
