"""Backend crossover on the card: time per solve of the condensed ("pdip",
kernels A + B) and the Riccati ("riccati", kernels A + C + line search)
backends as the horizon grows, nodes 0.1 s apart.

Counterpart of ``mpc_quad_ros_tpu/bench/suite.py::riccati_crossover`` for the
port's one batched path.  Each row times `reps` chained warm-started
``solve_batch`` calls with CUDA events after one untimed solve, at the
solve benchmark's operating point, and the share of scenarios whose controls
came out non-finite: the condensed f32 IPM loses scenarios there from N~16
on (the JAX package's algorithm does the same), the Riccati one must not.
Past ``FUSED_N_MAX`` the condensed row is None with the guard's note:
``solve_batch`` would take the Riccati path there.

    python -m mpc_quad_ros_tpu_torch.bench.crossover --B 16384 --N 10 16 20 30 80
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.sqp import FUSED_N_MAX
from .operating_point import operating_point
from .phases import time_solves


def time_backend(B: int, N: int, qp_method: str, reps: int, device,
                 method: str = "solve_batch") -> tuple[float, float]:
    """(milliseconds per batched solve over `reps` chained solves that
    follow a first solve (``phases.time_solves``), share of scenarios with
    non-finite controls after the last: solve 1 + `reps` from the initial
    carry, the count behind ``AUTO_RICCATI_MIN_N``, for ``solve_batch`` and,
    with `method` "solve", for the per-scenario path)."""
    solver, carry, x0, y_ref, rgp = operating_point(B, device, N=N, qp_method=qp_method)
    carry, _ = getattr(solver, method)(carry, x0, y_ref, y_ref[:, -1], rgp)
    times, sol = time_solves(solver, carry, x0, y_ref, rgp, reps, device, method=method)
    bad = (~torch.isfinite(sol.U)).flatten(1).any(1).double().mean().item()
    return times[0] * 1e3, bad


def crossover_row(B: int, N: int, reps: int = 3, device="cuda") -> dict:
    row = {"n_nodes": N, "B": B}
    for method, key in (("pdip", "condensed"), ("riccati", "riccati")):
        if method == "pdip" and N > FUSED_N_MAX:
            row[f"{key}_ms"] = row[f"{key}_solves_per_s"] = None
            row[f"{key}_note"] = (f"condensed kernels' ceiling: N > FUSED_N_MAX = {FUSED_N_MAX}; "
                                  "solve_batch falls back to the Riccati backend")
            continue
        ms, bad = time_backend(B, N, method, reps, device)
        row[f"{key}_ms"] = ms
        row[f"{key}_solves_per_s"] = B / ms * 1e3
        row[f"{key}_nonfinite_share"] = bad
    if row["riccati_nonfinite_share"] > 0:
        raise RuntimeError(f"crossover: non-finite Riccati controls at N={N}: {row}")
    return row


def per_scenario_row(B: int, N: int, reps: int = 2, device="cuda") -> dict:
    """The per-scenario ``solve``'s condensed step (kernels A and D, the
    unscaled IPM in tensor code) at horizon N: ms per batched solve and the
    share of scenarios with non-finite controls."""
    ms, bad = time_backend(B, N, "pdip", reps, device, method="solve")
    return {"n_nodes": N, "B": B, "per_scenario_pdip_ms": ms,
            "per_scenario_pdip_nonfinite_share": bad}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--N", type=int, nargs="+", default=[10, 16, 20, 30, 80])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("crossover: needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    for N in args.N:
        print(json.dumps(crossover_row(args.B, N, args.reps)), flush=True)


if __name__ == "__main__":
    main()
