"""Batch-major closed learning loop.

Counterpart of ``mpc_quad_ros_tpu/loop/batch.py::run_episode_batch_fused``
for homogeneous batches: one Python loop over ticks whose body runs on the
whole episode batch —

1. the reference chunk of each tick, clipped to the last sample T-1;
2. one batched SQP-RTI solve, warm-started from the previous tick;
3. the nominal one-step prediction (no learned drag) for the learning label;
4. n_sub = round(dt_mpc / dt_sim) RK4 substeps of the drag plant under the
   held first control, with per-episode plant parameters;
5. the per-axis RGP Kalman update from the previous tick's prediction error.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.dynamics import compute_a_drag_target, plant_substeps
from ..models.params import QuadParams
from ..models.rgp import RGPState, rgp_regress
from ..ops.sqp import SQPSolver, init_carry
from .episode import EpisodeCarry, EpisodeConfig, EpisodeOutput


def run_episode_batch_fused(
    cfg: EpisodeConfig,
    solver: SQPSolver,
    plant_params: QuadParams,      # fields with leading (B,)
    x0: torch.Tensor,              # (B, 13)
    x_trajectory: torch.Tensor,    # (B, T, 13)
    n_ticks: int,
    rgp0: Optional[RGPState] = None,   # fields with leading (B, 3) or None
) -> tuple[EpisodeCarry, EpisodeOutput]:
    """Run n_ticks closed-loop MPC ticks for B episodes at once; returns the
    final carry and the per-tick logs stacked to (B, n_ticks, ...)."""
    mpc = cfg.mpc
    N = mpc.n_nodes
    n_sub = cfg.n_substeps
    T = x_trajectory.shape[1]
    use_rgp = rgp0 is not None
    log_post = use_rgp and cfg.log_rgp_posterior
    nodes = torch.arange(N, device=x0.device)

    carry = EpisodeCarry(x=x0, solver=init_carry(mpc, x0), rgp=rgp0, x_pred_prev=x0)
    ticks = []
    for i in range(n_ticks):
        x = carry.x
        idx = (i + nodes).clamp(0, T - 1)
        x_ref = x_trajectory[:, idx]                                   # (B, N, 13)

        solver_carry, sol = solver.solve_batch(carry.solver, x, x_ref, x_ref[:, -1], carry.rgp)
        u = sol.U[:, 0]

        x_pred = solver.discrete_dynamics(x, u, mpc.dt, None)
        x_next = plant_substeps(x, u, plant_params, cfg.simulation_dt, n_sub)

        v_body = a_drag = None
        rgp_new = carry.rgp
        if use_rgp:
            v_body, a_drag = compute_a_drag_target(x, carry.x_pred_prev, mpc.dt)
            rgp_new = rgp_regress(carry.rgp, v_body[..., None], a_drag[..., None])

        ticks.append(EpisodeOutput(
            x_odom=x, x_pred_odom=x_pred, x_ref=x_ref[:, 0], w_odom=u,
            cost_solution=sol.cost, kkt_residual=sol.kkt_residual,
            rgp_mu_g_t=rgp_new.mu_g if use_rgp else None,
            v_body=v_body, a_drag=a_drag,
            rgp_basis_vectors=rgp_new.X if log_post else None,
            rgp_C_g_t=rgp_new.C_g if log_post else None,
            rgp_theta=rgp_new.theta if log_post else None,
        ))
        carry = EpisodeCarry(x=x_next, solver=solver_carry, rgp=rgp_new, x_pred_prev=x_pred)

    first = ticks[0].fields()
    outs = EpisodeOutput(**{
        k: None if v is None else torch.stack([t.fields()[k] for t in ticks], dim=1)
        for k, v in first.items()})
    return carry, outs
