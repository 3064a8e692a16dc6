"""Batched SQP-RTI nonlinear MPC over the quadrotor horizon.

Counterpart of ``mpc_quad_ros_tpu/ops/sqp.py`` on its main path: the batched
Gauss-Newton step of the "hybrid" pipeline with the condensed primal-dual
interior point (``qp_method="pdip"``), cold-started.  One step is kernel A
(``ops/cuda/lin_kernel.py``: x+ and J = [A | B] per scenario and stage),
then kernel B (``ops/cuda/sqp_fused_kernel.py``: condensing, IPM, KKT, dX),
with the glue of ``_gn_step_batch_hybrid`` between them.  Any batch size B
is taken as it is.

Cost: LINEAR_LS with W = diag(q_pos, q_quat, q_vel, q_rate, r) and the
reference's quaternion-weight mean quirk; stage cost x dt, terminal cost
unscaled; u in [u_lb, u_ub].
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models.augmented import fold_drag
from ..models.dynamics import rk4_step
from ..utils.containers import Tensors
from .cuda.lin_kernel import linearize, model_constants
from .cuda.sqp_fused_kernel import fused_sqp_from_J


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    n_nodes: int = 10            # N
    t_horizon: float = 1.0       # [s]
    q_cost: tuple = (10.0, 10.0, 10.0, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05)
    r_cost: tuple = (0.1, 0.1, 0.1, 0.1)
    terminal_cost: float = 1.0
    u_lb: float = 0.0
    u_ub: float = 1.0
    u_ref: float = 0.16          # hover reference control
    sqp_iters: int = 1           # 1 == RTI
    qp_iters: int = 12

    @property
    def dt(self) -> float:
        return self.t_horizon / self.n_nodes

    @property
    def stage_scale(self) -> float:
        """The stage cost is integrated over the shooting interval."""
        return self.dt

    def q_diagonal(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """12 Euler-style weights -> 13 quaternion-state weights: the mean
        of the three attitude weights is inserted for q_w (reference quirk)."""
        q = torch.tensor(self.q_cost, dtype=dtype, device=device)
        return torch.cat([q[:3], q[3:6].mean()[None], q[3:]])

    def weight_tuples(self) -> tuple:
        """(stage q, terminal q, control r) diagonals as Python floats, the
        stage ones scaled by `stage_scale` (computed in double)."""
        q = np.asarray(self.q_cost, dtype=np.float64)
        qd = np.concatenate([q[:3], [q[3:6].mean()], q[3:]])
        q_stage = tuple(float(v) for v in qd * self.stage_scale)
        q_term = tuple(float(v) for v in qd * self.terminal_cost)
        rw = tuple(float(v) * self.stage_scale for v in self.r_cost)
        return q_stage, q_term, rw


@dataclasses.dataclass(frozen=True)
class SolverCarry(Tensors):
    """Warm-started primal trajectory carried across RTI ticks."""

    X: torch.Tensor  # (B, N+1, 13)
    U: torch.Tensor  # (B, N, 4)


@dataclasses.dataclass(frozen=True)
class MPCSolution(Tensors):
    X: torch.Tensor             # (B, N+1, 13) QP-updated state trajectory
    U: torch.Tensor             # (B, N, 4) controls
    cost: torch.Tensor          # (B,) LS cost of the returned trajectory
    kkt_residual: torch.Tensor  # (B,) projected-gradient norm of the last QP


def init_carry(cfg: MPCConfig, x0: torch.Tensor) -> SolverCarry:
    """Every node at x0, every control at u_ref; x0 (..., 13)."""
    N = cfg.n_nodes
    X = x0[..., None, :].expand(x0.shape[:-1] + (N + 1, 13)).clone()
    U = torch.full(x0.shape[:-1] + (N, 4), cfg.u_ref, dtype=x0.dtype, device=x0.device)
    return SolverCarry(X=X, U=U)


class SQPSolver:
    """Gauss-Newton SQP(-RTI) on the quadrotor OCP.  `dynamics` is the
    continuous-time model f(x, u, aug) (``models.augmented.MPCDynamics``);
    aug is the per-scenario RGP state (or its folded form), or None."""

    def __init__(self, cfg: MPCConfig, dynamics: Callable):
        self.cfg = cfg
        self.f = dynamics
        self._lin_consts = None   # kernel A's model constants, derived once

    def discrete_dynamics(self, x: torch.Tensor, u: torch.Tensor, dt, aug=None) -> torch.Tensor:
        """One RK4 step of the model."""
        aug = fold_drag(aug)
        return rk4_step(lambda xx, uu: self.f(xx, uu, aug), x, u, dt)

    def qp_inputs(self, X, U, x0, y_ref, y_ref_N, xp) -> tuple:
        """Kernel B's inputs besides J, from the linearisation — the glue of
        the JAX hybrid step: the defects r = xp - X[1:], dx0 = x0 - X[0],
        ex0 = X - [y_ref; y_ref_N], gu = (U - u_ref) r dt, and the box
        shifted to the increment, lb = u_lb - U, ub = u_ub - U."""
        cfg = self.cfg
        B, N = U.shape[:2]
        Uf = U.reshape(B, N * 4)
        rw = (torch.tensor(cfg.r_cost, dtype=X.dtype, device=X.device) * cfg.stage_scale).repeat(N)
        return (xp - X[:, 1:], x0 - X[:, 0], X - torch.cat([y_ref, y_ref_N[:, None]], dim=1),
                (Uf - cfg.u_ref) * rw, cfg.u_lb - Uf, cfg.u_ub - Uf)

    def _gn_step_batch_hybrid(self, X, U, x0, y_ref, y_ref_N, aug):
        """Kernel A, the glue, kernel B, the update."""
        cfg = self.cfg
        if X.is_cuda and self._lin_consts is None:
            self._lin_consts = model_constants(self.f.params, cfg.dt)
        xp, J = linearize(X, U, aug, self.f, cfg.dt, self._lin_consts)
        q_s, q_term, rw_s = cfg.weight_tuples()
        z, dX, kkt = fused_sqp_from_J(J, *self.qp_inputs(X, U, x0, y_ref, y_ref_N, xp),
                                      q_s, q_term, rw_s, cfg.qp_iters)
        return X + dX, U + z.reshape(U.shape), kkt

    def solve_batch(self, carry: SolverCarry, x0: torch.Tensor, y_ref: torch.Tensor,
                    y_ref_N: torch.Tensor, aug=None) -> tuple[SolverCarry, MPCSolution]:
        """One MPC solve for each of B scenarios.

        carry   : warm-started (X (B, N+1, 13), U (B, N, 4))
        x0      : (B, 13) measured states
        y_ref   : (B, N, 13) stage references;  y_ref_N : (B, 13) terminal
        aug     : per-scenario RGPState (B, 3, ...) / FoldedDrag, or None
        """
        aug = fold_drag(aug)
        if aug is not None:
            aug = aug.map(lambda a: a.contiguous())
        X, U = carry.X.contiguous(), carry.U.contiguous()
        x0, y_ref, y_ref_N = x0.contiguous(), y_ref.contiguous(), y_ref_N.contiguous()
        kkt = None
        for _ in range(self.cfg.sqp_iters):
            X, U, kkt = self._gn_step_batch_hybrid(X, U, x0, y_ref, y_ref_N, aug)
        cost = self.ls_cost(X, U, y_ref, y_ref_N)
        return SolverCarry(X=X, U=U), MPCSolution(X=X, U=U, cost=cost, kkt_residual=kkt)

    def ls_cost(self, X, U, y_ref, y_ref_N) -> torch.Tensor:
        """LINEAR_LS cost of each trajectory (leading dims kept)."""
        cfg = self.cfg
        kw = dict(dtype=X.dtype, device=X.device)
        q = cfg.q_diagonal(**kw) * cfg.stage_scale
        rw = torch.tensor(cfg.r_cost, **kw) * cfg.stage_scale
        p = cfg.q_diagonal(**kw) * cfg.terminal_cost
        ex = X[..., :-1, :] - y_ref
        eu = U - cfg.u_ref
        eN = X[..., -1, :] - y_ref_N
        return 0.5 * ((ex**2 * q).sum((-2, -1)) + (eu**2 * rw).sum((-2, -1))
                      + (eN**2 * p).sum(-1))
