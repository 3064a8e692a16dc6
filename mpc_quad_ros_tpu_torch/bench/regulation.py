"""The warm-dual regulation chain: the near-steady scenario on which the JAX
package measured that warm-started IPM duals halve the factorisations
(``tests/test_warm_start.py:25-45``, ``mpc_quad_ros_tpu/ops/sqp.py:129-145``).

B scenarios hover at 3 m with x-velocities spread over linspace(-0.5, 0.5)
m/s, the reference is the start state itself (y_ref = x0 at every node), the
model carries the RGP drag (10 basis vectors per axis, zero posterior mean),
and `ticks` chained ``solve_batch`` calls from the same x0 each hand their
carry, duals included, to the next.

    python -m mpc_quad_ros_tpu_torch.bench.regulation --B 65536 --ticks 40
"""

from __future__ import annotations

import argparse
import json

import torch

from ..models import hummingbird_params, make_mpc_dynamics, rgp_init
from ..ops.sqp import MPCConfig, SQPSolver, init_carry

N_BASIS = 10


def regulation_setup(B: int, device, warm_start_duals: bool, qp_iters: int,
                     pipeline: str = "hybrid", dtype=torch.float32):
    """(solver, carry, x0, y_ref, rgp) of the chain."""
    p = hummingbird_params(dtype=torch.float32).map(lambda a: a.to(device, dtype))
    cfg = MPCConfig(u_ref=float(p.hover_input.float()), qp_iters=qp_iters,
                    warm_start_duals=warm_start_duals, pipeline=pipeline)
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    kw = dict(dtype=dtype, device=device)
    x0 = torch.zeros((B, 13), **kw)
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7] += torch.linspace(-0.5, 0.5, B, **kw)
    y_ref = x0[:, None, :].repeat(1, cfg.n_nodes, 1)
    rgp = rgp_init(torch.linspace(-10, 10, N_BASIS, **kw).expand(B, 3, N_BASIS),
                   theta=(3.0, 0.1, 0.01))
    return solver, init_carry(cfg, x0), x0, y_ref, rgp


def regulation_chain(B: int, device, warm_start_duals: bool, qp_iters: int, ticks: int = 40,
                     pipeline: str = "hybrid", dtype=torch.float32):
    """Run the chain; returns (summary dict, last carry, KKT (ticks, B))."""
    solver, carry, x0, y_ref, rgp = regulation_setup(B, device, warm_start_duals, qp_iters,
                                                     pipeline, dtype)
    kkts = []
    for _ in range(ticks):
        carry, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
        kkts.append(sol.kkt_residual)
    kkt = torch.stack(kkts)
    summary = {"B": B, "ticks": ticks, "pipeline": pipeline, "warm_start_duals": warm_start_duals,
               "qp_iters": qp_iters, "kkt_max": kkt.max().item(),
               "kkt_median": kkt.median().item(),
               "kkt_last_tick_max": kkt[-1].max().item()}
    return summary, carry, kkt


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=65536)
    ap.add_argument("--ticks", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("regulation: needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    for warm, iters in ((False, 12), (True, 6), (True, 12)):
        summary, _, _ = regulation_chain(args.B, "cuda", warm, iters, args.ticks)
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
