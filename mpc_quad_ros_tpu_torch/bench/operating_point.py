"""The solve benchmark's operating point, at any horizon.

Counterpart of the inputs of the JAX ``bench.py`` solve (``bench.py:71-96``):
hover at 3 m with velocities U(-3, 3) m/s, the reference stepped 1-5 m along
x over the horizon, the RGP drag with 10 basis vectors per axis, nodes 0.1 s
apart (N=10 is the benchmark's 1 s horizon)."""

from __future__ import annotations

import torch

from ..models import hummingbird_params, make_mpc_dynamics, rgp_init
from ..ops.sqp import MPCConfig, SQPSolver, init_carry

N_BASIS = 10


def operating_point(B: int, device, dtype=torch.float32, seed: int = 0, mu_scale: float = 0.0,
                    N: int = 10, qp_method: str = "pdip", pipeline: str = "hybrid",
                    warm_start_duals: bool = False, qp_iters: int = 12):
    """(solver, carry, x0, y_ref, rgp) of B scenarios.  The RGP posterior
    mean is mu_scale * N(0, 1) (0 in the benchmark).  Drawn in f64 and
    rounded to f32 whatever `dtype` is, so an f64 run sees the very inputs of
    the f32 one.  `qp_method`, `pipeline`, `warm_start_duals` and `qp_iters`
    go to the solver's ``MPCConfig``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    f64 = torch.float64
    p = hummingbird_params(dtype=torch.float32).map(lambda a: a.to(device, dtype))
    cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N, u_ref=float(p.hover_input.float()),
                    qp_method=qp_method, pipeline=pipeline, warm_start_duals=warm_start_duals,
                    qp_iters=qp_iters)
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    x0 = torch.zeros((B, 13), dtype=f64)
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7:10] += -3.0 + 6.0 * torch.rand((B, 3), generator=gen, dtype=f64)
    y_ref = x0[:, None, :].repeat(1, N, 1)
    step = 1.0 + 4.0 * torch.rand((B, 1), generator=gen, dtype=f64)
    y_ref[:, :, 0] += torch.linspace(0, 1, N, dtype=f64)[None, :] * step
    basis = torch.linspace(-10, 10, N_BASIS, dtype=f64).expand(B, 3, N_BASIS)
    rgp = rgp_init(basis, theta=(3.0, 0.1, 0.01))
    rgp = rgp.replace(mu_g=mu_scale * torch.randn((B, 3, N_BASIS), generator=gen, dtype=f64))
    cast = lambda a: a.float().to(device, dtype)
    x0, y_ref, rgp = cast(x0), cast(y_ref), rgp.map(cast)
    return solver, init_carry(cfg, x0), x0, y_ref, rgp
