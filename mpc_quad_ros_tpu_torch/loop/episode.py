"""Closed-loop episode records.  Counterpart of
``mpc_quad_ros_tpu/loop/episode.py`` (``EpisodeConfig``, ``EpisodeCarry``,
``EpisodeOutput``); the per-tick body lives in ``loop/batch.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.rgp import RGPState
from ..ops.sqp import MPCConfig, SolverCarry
from ..utils.containers import Tensors


@dataclasses.dataclass(frozen=True)
class EpisodeConfig:
    mpc: MPCConfig = MPCConfig()
    simulation_dt: float = 5e-3       # physics RK4 step
    log_rgp_posterior: bool = True    # log C_g / basis vectors / theta per tick

    @property
    def n_substeps(self) -> int:
        return round(self.mpc.dt / self.simulation_dt)


@dataclasses.dataclass(frozen=True)
class EpisodeCarry:
    x: torch.Tensor                 # (B, 13) plant state
    solver: SolverCarry             # warm-started primal trajectory
    rgp: Optional[RGPState]         # (B, 3, ...) or None
    x_pred_prev: torch.Tensor       # (B, 13) last tick's prediction of this tick


@dataclasses.dataclass(frozen=True)
class EpisodeOutput(Tensors):
    """Per-tick logs stacked to (B, n_ticks, ...)."""

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
