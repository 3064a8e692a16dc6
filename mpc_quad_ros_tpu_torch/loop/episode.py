"""Closed-loop episode: MPC ticks as a Python loop over tensors.

Counterpart of ``mpc_quad_ros_tpu/loop/episode.py``.  Each tick:

1. the reference chunk (the clipped strided gather of ``utils/reference.py``);
2. one SQP-RTI solve (``SQPSolver.solve``), warm-started from the previous
   tick;
3. the nominal one-step prediction (no learned drag) for the learning label;
4. n_sub = round(dt_mpc / dt_sim) RK4 substeps of the drag plant under the
   held first control, with the scheduled rotor fault from `fault_tick` on;
5. the per-axis RGP Kalman update from the previous tick's prediction error,
   so the solve at tick i uses the posterior updated through measurement
   i - 1;
6. the per-tick logs.

The MPC's drag model is the online RGP (gp2, `rgp0`), a static pretrained
GP (gp1, `gp_aug`: a ``GPState``, or any drag record, folded once before the
tick loop) or none (gp0).

``run_episode`` takes one episode (x0 (13,)) or a batch (x0 (B, 13), every
other input with a leading (B,)): the batch is the JAX package's ``vmap`` of
the episode, ``loop/batch.py::run_episode_batch``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.augmented import FoldedDrag, fold_drag
from ..models.dynamics import compute_a_drag_target, plant_substeps
from ..models.params import QuadParams
from ..models.rgp import RGPState, rgp_regress
from ..ops.sqp import MPCConfig, SQPSolver, SolverCarry, init_carry
from ..utils.containers import Tensors


@dataclasses.dataclass(frozen=True)
class EpisodeConfig:
    mpc: MPCConfig = MPCConfig()
    simulation_dt: float = 5e-3       # physics RK4 step
    # one MPC tick advances this many trajectory samples: 1 when the
    # trajectory is sampled at the MPC rate, 10 on the ROS path
    control_skip: int = 1
    # from tick `fault_tick` on (< 0: never) the plant's per-rotor
    # functionality is `fault_rotors`
    fault_tick: int = -1
    fault_rotors: tuple = (1.0, 1.0, 1.0, 1.0)
    log_rgp_posterior: bool = True    # log C_g / basis vectors / theta per tick

    @property
    def n_substeps(self) -> int:
        return round(self.mpc.dt / self.simulation_dt)


@dataclasses.dataclass(frozen=True)
class EpisodeCarry:
    x: torch.Tensor                 # ([B,] 13) plant state
    solver: SolverCarry             # warm-started primal trajectory
    rgp: Optional[RGPState]         # ([B,] 3, ...) or None
    x_pred_prev: torch.Tensor       # ([B,] 13) last tick's prediction of this tick


@dataclasses.dataclass(frozen=True)
class EpisodeOutput(Tensors):
    """Per-tick logs stacked to ([B,] n_ticks, ...)."""

    x_odom: torch.Tensor
    x_pred_odom: torch.Tensor
    x_ref: torch.Tensor
    w_odom: torch.Tensor
    cost_solution: torch.Tensor
    kkt_residual: torch.Tensor
    rgp_mu_g_t: Optional[torch.Tensor] = None
    v_body: Optional[torch.Tensor] = None
    a_drag: Optional[torch.Tensor] = None
    rgp_basis_vectors: Optional[torch.Tensor] = None
    rgp_C_g_t: Optional[torch.Tensor] = None
    rgp_theta: Optional[torch.Tensor] = None
    # heterogeneous fused batches only: False where the episode had finished
    # and its carry was frozen (metrics mask with it)
    active: Optional[torch.Tensor] = None


def static_drag(gp_aug, x: torch.Tensor) -> Optional[FoldedDrag]:
    """The static drag model (gp1) folded once for a whole run, in x's dtype
    and on its device (the fold in gp_aug's own dtype), broadcast to x's
    leading (B,) where gp_aug has none; None stays None."""
    if gp_aug is None:
        return None
    aug = fold_drag(gp_aug)
    if not isinstance(aug, FoldedDrag):
        raise TypeError(f"unsupported augmentation state: {type(gp_aug)}")
    aug = aug.map(lambda a: a.to(x.device, x.dtype))
    if aug.X.dim() - 2 < x.dim() - 1:
        aug = aug.map(lambda a: a.expand(x.shape[:-1] + a.shape).contiguous())
    return aug


def tick_output(x, x_pred, x_ref0, u, sol, rgp, v_body, a_drag, log_post: bool,
                active=None) -> EpisodeOutput:
    """One tick's logs; `rgp` is the posterior after this tick's update (None
    without RGP)."""
    use_rgp = rgp is not None
    return EpisodeOutput(
        x_odom=x, x_pred_odom=x_pred, x_ref=x_ref0, w_odom=u,
        cost_solution=sol.cost, kkt_residual=sol.kkt_residual,
        rgp_mu_g_t=rgp.mu_g if use_rgp else None, v_body=v_body, a_drag=a_drag,
        rgp_basis_vectors=rgp.X if use_rgp and log_post else None,
        rgp_C_g_t=rgp.C_g if use_rgp and log_post else None,
        rgp_theta=rgp.theta if use_rgp and log_post else None,
        active=active)


def stack_ticks(ticks: list, dim: int) -> EpisodeOutput:
    """The per-tick logs stacked along `dim` (the tick axis)."""
    first = ticks[0].fields()
    return EpisodeOutput(**{
        k: None if v is None else torch.stack([t.fields()[k] for t in ticks], dim=dim)
        for k, v in first.items()})


def run_episode(
    cfg: EpisodeConfig,
    solver: SQPSolver,
    plant_params: QuadParams,
    x0: torch.Tensor,
    x_trajectory: torch.Tensor,
    n_ticks: int,
    rgp0: Optional[RGPState] = None,
    gp_aug=None,
    carry0: Optional[EpisodeCarry] = None,
    start_tick: int = 0,
) -> tuple[EpisodeCarry, EpisodeOutput]:
    """Run `n_ticks` closed-loop MPC ticks from tick `start_tick`.

    plant_params : true-plant parameters (drag on), ([B,] ...)
    x0           : ([B,] 13) initial state
    x_trajectory : ([B,] T, 13) sampled reference states
    rgp0         : initial RGP state ([B,] 3, ...) for online learning, or None
    gp_aug       : static pretrained GP (3, ...) shared by the episodes, or
                   ([B,] 3, ...); read when rgp0 is None
    carry0       : the carry of an earlier run to resume from (x0 and rgp0
                   are then not read)
    Returns the final carry and the logs stacked to ([B,] n_ticks, ...)."""
    mpc = cfg.mpc
    n_sub = cfg.n_substeps
    T = x_trajectory.shape[-2]
    nodes = torch.arange(mpc.n_nodes, device=x_trajectory.device)
    if carry0 is None:
        # first tick: the current state stands in for the prediction -> a
        # zero drag label
        carry0 = EpisodeCarry(x=x0, solver=init_carry(mpc, x0), rgp=rgp0, x_pred_prev=x0)
    use_rgp = carry0.rgp is not None
    aug_static = static_drag(gp_aug, carry0.x)
    tick_dim = carry0.x.dim() - 1
    faulty = torch.as_tensor(cfg.fault_rotors, dtype=plant_params.rotor_functionality.dtype,
                             device=plant_params.rotor_functionality.device)
    faulty = faulty.expand_as(plant_params.rotor_functionality)

    carry = carry0
    ticks = []
    for i in range(start_tick, start_tick + n_ticks):
        x = carry.x
        idx = ((i + nodes) * cfg.control_skip).clamp(0, T - 1)
        x_ref = x_trajectory[..., idx, :]                              # ([B,] N, 13)

        aug = carry.rgp if use_rgp else aug_static
        solver_carry, sol = solver.solve(carry.solver, x, x_ref, x_ref[..., -1, :], aug)
        u = sol.U[..., 0, :]

        x_pred = solver.discrete_dynamics(x, u, mpc.dt, None)
        p_tick = plant_params
        if 0 <= cfg.fault_tick <= i:
            p_tick = plant_params.replace(rotor_functionality=faulty)
        x_next = plant_substeps(x, u, p_tick, cfg.simulation_dt, n_sub)

        v_body = a_drag = None
        rgp_new = carry.rgp
        if use_rgp:
            v_body, a_drag = compute_a_drag_target(x, carry.x_pred_prev, mpc.dt)
            rgp_new = rgp_regress(carry.rgp, v_body[..., None], a_drag[..., None])

        ticks.append(tick_output(x, x_pred, x_ref[..., 0, :], u, sol, rgp_new, v_body, a_drag,
                                 cfg.log_rgp_posterior))
        carry = EpisodeCarry(x=x_next, solver=solver_carry, rgp=rgp_new, x_pred_prev=x_pred)
    return carry, stack_ticks(ticks, tick_dim)


def make_episode_fn(cfg: EpisodeConfig, solver: SQPSolver, n_ticks: int):
    """(plant_params, x0, x_trajectory, rgp0=None, gp_aug=None) -> (final
    carry, outputs), with the configuration, solver and tick count bound."""

    def fn(plant_params, x0, x_trajectory, rgp0=None, gp_aug=None):
        return run_episode(cfg, solver, plant_params, x0, x_trajectory, n_ticks, rgp0, gp_aug)

    return fn


def tracking_rmse(outs: EpisodeOutput) -> torch.Tensor:
    """RMS position tracking error [m] over the ticks, per episode."""
    err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
    return torch.sqrt((err**2).sum(-1).mean(-1))
