"""Scenario batches of the closed learning loop.

Counterpart of ``mpc_quad_ros_tpu/loop/batch.py``:

- ``run_episode_batch``: ``run_episode`` on leading-(B,) tensors, the JAX
  ``vmap`` of the episode: each scenario's solve is the per-scenario
  ``SQPSolver.solve`` (the unscaled IPM);
- ``run_episode_batch_fused``: one Python loop over ticks whose body runs
  the whole batch through ``SQPSolver.solve_batch`` (the batched kernels) —
  1. the reference chunk of each tick, clipped to each episode's last
     sample (`traj_len`, else T - 1), `control_skip` samples a tick;
  2. one batched SQP-RTI solve, warm-started from the previous tick;
  3. the nominal one-step prediction (no learned drag) for the learning
     label;
  4. n_sub = round(dt_mpc / dt_sim) RK4 substeps of the drag plant under
     the held first control, with per-episode plant parameters;
  5. the per-axis RGP Kalman update from the previous tick's prediction
     error (gp2; gp1's static `gp_aug` is folded once before the ticks);
  6. with `episode_ticks`, the carry of every finished episode frozen, and
     the per-tick `active` mask logged;
- ``tracking_rmse_masked``: the RMS tracking error over the active ticks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.dynamics import compute_a_drag_target, plant_substeps
from ..models.params import QuadParams
from ..models.rgp import RGPState, rgp_regress
from ..ops.sqp import SQPSolver, init_carry
from .episode import (EpisodeCarry, EpisodeConfig, EpisodeOutput, run_episode, stack_ticks,
                      static_drag, tick_output)


def run_episode_batch(
    cfg: EpisodeConfig,
    solver: SQPSolver,
    plant_params: QuadParams,      # fields with leading (B,)
    x0: torch.Tensor,              # (B, 13)
    x_trajectory: torch.Tensor,    # (B, T, 13)
    n_ticks: int,
    rgp0: Optional[RGPState] = None,   # fields with leading (B, 3) or None
    gp_aug=None,                       # static pretrained GP (3, ...) shared by all episodes
) -> tuple[EpisodeCarry, EpisodeOutput]:
    """B independent episodes, each as ``run_episode`` runs it; logs stacked
    to (B, n_ticks, ...)."""
    return run_episode(cfg, solver, plant_params, x0, x_trajectory, n_ticks, rgp0, gp_aug)


def _freeze(active: torch.Tensor, new, old):
    """`new` with the old value of every finished episode (active False), in
    a tensor or in every tensor of a record (the carry, its solver carry
    and RGP state)."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(active.reshape(active.shape + (1,) * (new.dim() - 1)), new, old)
    return type(new)(**{f.name: _freeze(active, getattr(new, f.name), getattr(old, f.name))
                        for f in dataclasses.fields(new)})


def run_episode_batch_fused(
    cfg: EpisodeConfig,
    solver: SQPSolver,
    plant_params: QuadParams,      # fields with leading (B,)
    x0: torch.Tensor,              # (B, 13)
    x_trajectory: torch.Tensor,    # (B, T, 13)
    n_ticks: int,
    rgp0: Optional[RGPState] = None,   # fields with leading (B, 3) or None
    gp_aug=None,                       # static pretrained GP, (B, 3, ...) or shared (3, ...)
    traj_len: Optional[torch.Tensor] = None,       # (B,) valid samples of each episode <= T
    episode_ticks: Optional[torch.Tensor] = None,  # (B,) ticks of each episode <= n_ticks
) -> tuple[EpisodeCarry, EpisodeOutput]:
    """Run n_ticks closed-loop MPC ticks for B episodes at once; returns the
    final carry and the per-tick logs stacked to (B, n_ticks, ...).

    Heterogeneous batches: trajectories padded to one T, with `traj_len` each
    episode's own length (its reference clips to its own last sample), and
    `episode_ticks` each episode's tick count (its carry freezes after it,
    and ``EpisodeOutput.active`` marks its live ticks).  With identical
    shapes a masked run is bitwise the unmasked one."""
    mpc = cfg.mpc
    n_sub = cfg.n_substeps
    T = x_trajectory.shape[1]
    use_rgp = rgp0 is not None
    nodes = torch.arange(mpc.n_nodes, device=x0.device)
    last = None if traj_len is None else (traj_len.to(x0.device) - 1)[:, None]
    if episode_ticks is not None:
        episode_ticks = episode_ticks.to(x0.device)

    aug_static = static_drag(gp_aug, x0)
    carry = EpisodeCarry(x=x0, solver=init_carry(mpc, x0), rgp=rgp0, x_pred_prev=x0)
    ticks = []
    for i in range(n_ticks):
        x = carry.x
        steps = (i + nodes) * cfg.control_skip                         # (N,)
        if last is None:
            x_ref = x_trajectory[:, steps.clamp(0, T - 1)]             # (B, N, 13)
        else:
            idx = torch.minimum(steps[None, :], last)                  # (B, N)
            x_ref = torch.take_along_dim(x_trajectory, idx[..., None], dim=1)

        aug = carry.rgp if use_rgp else aug_static
        solver_carry, sol = solver.solve_batch(carry.solver, x, x_ref, x_ref[:, -1], aug)
        u = sol.U[:, 0]

        x_pred = solver.discrete_dynamics(x, u, mpc.dt, None)
        x_next = plant_substeps(x, u, plant_params, cfg.simulation_dt, n_sub)

        v_body = a_drag = None
        rgp_new = carry.rgp
        if use_rgp:
            v_body, a_drag = compute_a_drag_target(x, carry.x_pred_prev, mpc.dt)
            rgp_new = rgp_regress(carry.rgp, v_body[..., None], a_drag[..., None])

        new = EpisodeCarry(x=x_next, solver=solver_carry, rgp=rgp_new, x_pred_prev=x_pred)
        active = None
        if episode_ticks is not None:
            active = i < episode_ticks
            new = _freeze(active, new, carry)
        carry = new
        ticks.append(tick_output(x, x_pred, x_ref[:, 0], u, sol, carry.rgp, v_body, a_drag,
                                 cfg.log_rgp_posterior, active))
    return carry, stack_ticks(ticks, dim=1)


def tracking_rmse_masked(outs: EpisodeOutput) -> torch.Tensor:
    """Per-episode RMS position tracking error over the active ticks only
    (all ticks without a mask)."""
    err2 = ((outs.x_odom[..., :3] - outs.x_ref[..., :3]) ** 2).sum(-1)
    if outs.active is None:
        return torch.sqrt(err2.mean(-1))
    m = outs.active.to(err2.dtype)
    return torch.sqrt((err2 * m).sum(-1) / m.sum(-1).clamp_min(1))
