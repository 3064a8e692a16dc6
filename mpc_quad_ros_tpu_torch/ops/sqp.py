"""Batched SQP-RTI nonlinear MPC over the quadrotor horizon.

Counterpart of ``mpc_quad_ros_tpu/ops/sqp.py`` for ``solve_batch``, with two
QP backends:

- ``qp_method="pdip"``: the condensed primal-dual interior point, through
  one of three pipelines (``MPCConfig.pipeline``) that compute the same
  step by the same device code:
  - "hybrid" (``_gn_step_batch_hybrid``): kernel A
    (``ops/cuda/lin_kernel.py``: x+ and J = [A | B] per scenario and
    stage), the glue, then kernel B (``ops/cuda/sqp_fused_kernel.py``:
    condensing, IPM, KKT, dX);
  - "split" (``_gn_step_batch_tiled``): kernel A, the glue, kernel D
    (``ops/cuda/condense_kernel.py``: H, g, M, d), kernel E
    (``ops/cuda/qp_kernel.py``: the IPM), then the KKT and X + d + M z in
    plain tensor code;
  - "fused" (``_gn_step_batch_fused``): kernel F
    (``ops/cuda/sqp_fused_kernel.py``: the whole step in one kernel).
  With ``warm_start_duals`` the IPM starts from the duals of the previous
  solve, carried in ``SolverCarry``.
- ``qp_method="riccati"``: the long-horizon step.  Kernel A, then kernel C
  (``ops/cuda/riccati_kernel.py``: the Riccati-factorised box IPM, O(N) in
  the horizon), then a line search on the nonlinear rollout cost and the
  projected-gradient KKT of that rollout (``_riccati_finish``).  It carries
  the duals through untouched.
- ``qp_method="auto"`` takes "pdip" below ``AUTO_RICCATI_MIN_N`` and
  "riccati" from there; "pdip" past ``FUSED_N_MAX`` warns and takes
  "riccati", whatever the pipeline.

Any batch size B is taken as it is.

Cost: LINEAR_LS with W = diag(q_pos, q_quat, q_vel, q_rate, r) and the
reference's quaternion-weight mean quirk; stage cost x dt, terminal cost
unscaled; u in [u_lb, u_ub].
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from ..models.augmented import fold_drag
from ..models.dynamics import rk4_step
from ..utils.containers import Tensors
from .cuda.condense_kernel import condense_cost_from_J
from .cuda.lin_kernel import linearize, model_constants
from .cuda.qp_kernel import solve_box_qp_pdip_batch
from .cuda.riccati_kernel import riccati_ipm_from_J
from .cuda.sqp_fused_kernel import fused_sqp_from_J, fused_sqp_step
from .qp import qp_kkt_residual

# Shared-memory ceiling of the condensed kernels: one block holds the
# scenario's workspace, kernel B's mpcq_sqp_ws_bytes(N) = 4 (221 N + 26 nz +
# 26 + 3 nz (nz + 1) + 21 nz) bytes with nz = 4 N, dominated by three
# nz x (nz+1) matrices: 223,424 B at N = 30, 236,820 B at N = 31, against the
# 232,448 B an H100 block may opt into.  Kernel F's adds 52 N bytes (224,984 B
# at N = 30), kernel E's three nz x (nz+1) matrices pass it at N = 34.  The
# warm duals add nothing (read and written in device memory).  Past it a
# dense-H method falls back to the Riccati backend, whatever the pipeline.  A
# constant, so the CPU and the card dispatch alike.
FUSED_N_MAX = 30
DENSE_H_METHODS = ("pdip",)
PIPELINES = ("hybrid", "split", "fused")
# "auto" takes the Riccati backend from this horizon on.  Measured with
# bench/crossover.py on an NVIDIA H100 80GB HBM3 at 700 W, B=16384, nodes
# 0.1 s apart: the condensed step is the faster up to N=20 (191 against
# 283 ms per batched solve) and the slower at N=30 (934 against 531 ms), but
# from N=16 on its f32 IPM returns non-finite controls for part of the batch
# (0.4 % at N=16, 10 % at N=18, 39 % at N=20, none at N=10-14), and the
# Riccati step for none.
AUTO_RICCATI_MIN_N = 16


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
    qp_method: str = "pdip"      # "pdip" | "riccati" | "auto"
    pipeline: str = "hybrid"     # "hybrid" | "split" | "fused" (condensed methods)
    # Carry the IPM duals (zl, zu) across solves and warm-start the QP from
    # them.  Off by default, as in the JAX package: it halves the
    # factorisations on near-steady chains and loses on fast transients.
    warm_start_duals: bool = False

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
    """Warm-started primal trajectory and IPM duals carried across RTI
    ticks."""

    X: torch.Tensor                  # (B, N+1, 13)
    U: torch.Tensor                  # (B, N, 4)
    zl: torch.Tensor | None = None   # (B, N*4) lower-bound multipliers
    zu: torch.Tensor | None = None   # (B, N*4) upper-bound multipliers


@dataclasses.dataclass(frozen=True)
class MPCSolution(Tensors):
    X: torch.Tensor             # (B, N+1, 13) QP-updated state trajectory
    U: torch.Tensor             # (B, N, 4) controls
    cost: torch.Tensor          # (B,) LS cost of the returned trajectory
    kkt_residual: torch.Tensor  # (B,) projected-gradient norm: of the last QP
                                # ("pdip"), of the rollout cost ("riccati")


def init_carry(cfg: MPCConfig, x0: torch.Tensor) -> SolverCarry:
    """Every node at x0, every control at u_ref; x0 (..., 13).  With
    `warm_start_duals`, unit duals: the IPM's cold-start value, so the first
    solve is a (floored) cold start."""
    N = cfg.n_nodes
    X = x0[..., None, :].expand(x0.shape[:-1] + (N + 1, 13)).clone()
    U = torch.full(x0.shape[:-1] + (N, 4), cfg.u_ref, dtype=x0.dtype, device=x0.device)
    zl = zu = None
    if cfg.warm_start_duals:
        zl = torch.ones(x0.shape[:-1] + (N * 4,), dtype=x0.dtype, device=x0.device)
        zu = torch.ones_like(zl)
    return SolverCarry(X=X, U=U, zl=zl, zu=zu)


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

    def step_inputs(self, X, U, x0, y_ref, y_ref_N) -> tuple:
        """Kernel F's inputs besides (X, U) and the drag — the glue of the
        JAX fused step: dx0 = x0 - X[0], ex0 = X - [y_ref; y_ref_N],
        gu = (U - u_ref) r dt, and the box shifted to the increment,
        lb = u_lb - U, ub = u_ub - U."""
        cfg = self.cfg
        B, N = U.shape[:2]
        Uf = U.reshape(B, N * 4)
        rw = (torch.tensor(cfg.r_cost, dtype=X.dtype, device=X.device) * cfg.stage_scale).repeat(N)
        return (x0 - X[:, 0], X - torch.cat([y_ref, y_ref_N[:, None]], dim=1),
                (Uf - cfg.u_ref) * rw, cfg.u_lb - Uf, cfg.u_ub - Uf)

    def qp_inputs(self, X, U, x0, y_ref, y_ref_N, xp) -> tuple:
        """Kernel B's inputs besides J, from the linearisation — the glue of
        the JAX hybrid step: the defects r = xp - X[1:], then
        ``step_inputs``."""
        return (xp - X[:, 1:],) + self.step_inputs(X, U, x0, y_ref, y_ref_N)

    def _linearize(self, X, U, aug):
        """Kernel A along (X, U): (xp, J)."""
        if X.is_cuda and self._lin_consts is None:
            self._lin_consts = model_constants(self.f.params, self.cfg.dt)
        return linearize(X, U, aug, self.f, self.cfg.dt, self._lin_consts)

    def _resolve_qp_method(self) -> str:
        """The QP backend of this configuration: "auto" by the measured
        crossover; a dense-H method past the condensed kernel's shared-memory
        ceiling falls back to "riccati" with a warning."""
        m, N = self.cfg.qp_method, self.cfg.n_nodes
        if m == "projected_newton":
            raise NotImplementedError("qp_method='projected_newton' is not ported yet "
                                      "(ROADMAP queue 1, item 9)")
        if m not in ("pdip", "riccati", "auto"):
            raise ValueError(f"unknown qp_method {m!r}")
        if m == "auto":
            return "pdip" if N < AUTO_RICCATI_MIN_N else "riccati"
        if m in DENSE_H_METHODS and N > FUSED_N_MAX:
            warnings.warn(
                f"qp_method={m!r} at n_nodes={N} exceeds the condensed kernel's "
                f"shared-memory ceiling (N={FUSED_N_MAX}); using the O(N) Riccati "
                f"backend instead (qp_method='riccati' or 'auto' silences this).",
                stacklevel=4)
            return "riccati"
        return m

    def _warm(self, zl):
        return self.cfg.warm_start_duals and zl is not None

    def _gn_step_batch_hybrid(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug):
        """Kernel A, the glue, kernel B, the update."""
        cfg = self.cfg
        warm = self._warm(zl)
        xp, J = self._linearize(X, U, aug)
        z, dX, kkt, zl_n, zu_n = fused_sqp_from_J(
            J, *self.qp_inputs(X, U, x0, y_ref, y_ref_N, xp), *cfg.weight_tuples(),
            cfg.qp_iters, duals=(zl, zu) if warm else None)
        if warm:
            zl, zu = zl_n, zu_n
        return X + dX, U + z.reshape(U.shape), zl, zu, kkt

    def _gn_step_batch_tiled(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug):
        """The "split" step: kernel A, the glue, kernel D (H, g, M, d), g +=
        gu, kernel E (the IPM, warm or cold), then the KKT and X + (d + M z)
        in plain tensor code, as the JAX split step leaves them to XLA."""
        cfg = self.cfg
        warm = self._warm(zl)
        xp, J = self._linearize(X, U, aug)
        r, dx0, ex0, gu, lb, ub = self.qp_inputs(X, U, x0, y_ref, y_ref_N, xp)
        H, g, M, d = condense_cost_from_J(J, r, dx0, ex0, *cfg.weight_tuples())
        g = g + gu
        z, zl_n, zu_n = solve_box_qp_pdip_batch(H, g, lb, ub, cfg.qp_iters,
                                                *((zl, zu) if warm else (None, None)))
        if warm:
            zl, zu = zl_n, zu_n
        kkt = qp_kkt_residual(H, g, lb, ub, z)
        B = X.shape[0]
        dX = d + (M.reshape(B, -1, M.shape[-1]) @ z[..., None]).reshape(d.shape)
        return X + dX, U + z.reshape(U.shape), zl, zu, kkt

    def _gn_step_batch_fused(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug):
        """The "fused" step: kernel F, the update."""
        cfg = self.cfg
        warm = self._warm(zl)
        if X.is_cuda and self._lin_consts is None:
            self._lin_consts = model_constants(self.f.params, cfg.dt)
        z, dX, kkt, zl_n, zu_n = fused_sqp_step(
            X, U, *self.step_inputs(X, U, x0, y_ref, y_ref_N), aug, self.f, cfg.dt,
            *cfg.weight_tuples(), cfg.qp_iters, duals=(zl, zu) if warm else None,
            consts=self._lin_consts)
        if warm:
            zl, zu = zl_n, zu_n
        return X + dX, U + z.reshape(U.shape), zl, zu, kkt

    def riccati_inputs(self, X, U, x0, y_ref, y_ref_N, xp) -> tuple:
        """Kernel C's inputs besides J — the glue of the JAX batched Riccati
        step: the defects c = xp - X[1:], dx0 = x0 - X[0], qlin = q (X[:-1] -
        y_ref), rlin = rw (U - u_ref), plin = p (X[N] - y_ref_N), and the box
        shifted to the increment, lb = u_lb - U, ub = u_ub - U."""
        cfg = self.cfg
        kw = dict(dtype=X.dtype, device=X.device)
        qv, pv, rv = (torch.tensor(w, **kw) for w in cfg.weight_tuples())
        return (xp - X[:, 1:], x0 - X[:, 0], qv * (X[:, :-1] - y_ref), rv * (U - cfg.u_ref),
                pv * (X[:, -1] - y_ref_N), cfg.u_lb - U, cfg.u_ub - U)

    def _gn_step_batch_riccati(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug):
        """Kernel A, the glue, kernel C, then the line search and the honest
        KKT.  The IPM duals pass through untouched."""
        cfg = self.cfg
        xp, J = self._linearize(X, U, aug)
        dU, _ = riccati_ipm_from_J(J, *self.riccati_inputs(X, U, x0, y_ref, y_ref_N, xp),
                                   *cfg.weight_tuples(), cfg.qp_iters)
        X, U, kkt = self._riccati_finish(U, x0, y_ref, y_ref_N, aug, dU)
        return X, U, zl, zu, kkt

    def rollout(self, x0, U, aug=None) -> torch.Tensor:
        """(B, N+1, 13) states of the RK4 model from x0 (B, 13) under U."""
        xs = [x0]
        for k in range(U.shape[1]):
            xs.append(self.discrete_dynamics(xs[-1], U[:, k], self.cfg.dt, aug))
        return torch.stack(xs, 1)

    def _riccati_finish(self, U, x0, y_ref, y_ref_N, aug, dU):
        """Line search on the nonlinear rollout cost over alpha in
        {1, 0.5, 0.25, 0.1} (the first of equal costs wins), then the
        projected-gradient KKT max |clip(U - grad_U, u_lb, u_ub) - U| of the
        rollout cost at the accepted U.

        The four candidates roll out as one (4 B) batch.  The gradient is the
        adjoint recursion over kernel A's J at the accepted trajectory,
        lam_N = p e_N, lam_k = q e_k + A_k^T lam_{k+1}, grad u_k = rw (u_k -
        u_ref) + B_k^T lam_{k+1}: the exact gradient that the JAX package
        takes by reverse mode through the rollout, from J's B N 221 floats
        (2.3 GB in f32 at B=65536, N=40) and one more launch of kernel A.
        Autograd would save 4.7 GB of the rollout's intermediates there
        (counted with saved-tensor hooks at B=64, scaled) and replay its
        160 model evaluations backwards as eager launches."""
        cfg = self.cfg
        B, N = U.shape[:2]
        kw = dict(dtype=U.dtype, device=U.device)
        alphas = torch.tensor([1.0, 0.5, 0.25, 0.1], **kw)
        Uc = (U + alphas[:, None, None, None] * dU).clamp(cfg.u_lb, cfg.u_ub)
        aug4 = None if aug is None else aug.map(lambda a: a.repeat((4,) + (1,) * (a.dim() - 1)))
        Xc = self.rollout(x0.repeat(4, 1), Uc.reshape(4 * B, N, 4), aug4).reshape(4, B, N + 1, 13)
        costs = self.ls_cost(Xc, Uc, y_ref, y_ref_N)                   # (4, B)
        best = costs.argmin(0)
        rows = torch.arange(B, device=U.device)
        X, U = Xc[best, rows].contiguous(), Uc[best, rows].contiguous()

        _, J = self._linearize(X, U, aug)
        q_s, q_term, rw_s = cfg.weight_tuples()
        qv, pv, rv = (torch.tensor(w, **kw) for w in (q_s, q_term, rw_s))
        e = X - torch.cat([y_ref, y_ref_N[:, None]], 1)
        lam = pv * e[:, N]
        grad = [None] * N
        for k in range(N - 1, -1, -1):
            g = (J[:, k] @ lam[..., None])[..., 0]                     # [A_k^T; B_k^T] lam
            grad[k] = rv * (U[:, k] - cfg.u_ref) + g[:, 13:]
            lam = qv * e[:, k] + g[:, :13]
        proj = (U - torch.stack(grad, 1)).clamp(cfg.u_lb, cfg.u_ub) - U
        return X, U, proj.abs().amax((1, 2))

    def solve_batch(self, carry: SolverCarry, x0: torch.Tensor, y_ref: torch.Tensor,
                    y_ref_N: torch.Tensor, aug=None) -> tuple[SolverCarry, MPCSolution]:
        """One MPC solve for each of B scenarios.

        carry   : warm-started (X (B, N+1, 13), U (B, N, 4)) and, with
                  `warm_start_duals`, the IPM duals zl, zu (B, N*4)
        x0      : (B, 13) measured states
        y_ref   : (B, N, 13) stage references;  y_ref_N : (B, 13) terminal
        aug     : per-scenario RGPState (B, 3, ...) / FoldedDrag, or None
        """
        aug = fold_drag(aug)
        if aug is not None:
            aug = aug.map(lambda a: a.contiguous())
        carry = carry.map(lambda a: a.contiguous())
        X, U, zl, zu = carry.X, carry.U, carry.zl, carry.zu
        x0, y_ref, y_ref_N = x0.contiguous(), y_ref.contiguous(), y_ref_N.contiguous()
        step = self._step()
        kkt = None
        for _ in range(self.cfg.sqp_iters):
            X, U, zl, zu, kkt = step(X, U, zl, zu, x0, y_ref, y_ref_N, aug)
        cost = self.ls_cost(X, U, y_ref, y_ref_N)
        return (SolverCarry(X=X, U=U, zl=zl, zu=zu),
                MPCSolution(X=X, U=U, cost=cost, kkt_residual=kkt))

    def _step(self):
        """The Gauss-Newton step of this configuration: by the QP backend,
        then, for the condensed methods, by the pipeline.  An unknown
        pipeline raises (the JAX package falls back to "split")."""
        pipeline = self.cfg.pipeline
        if pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {pipeline!r}; expected one of {PIPELINES}")
        if self._resolve_qp_method() == "riccati":
            return self._gn_step_batch_riccati
        return {"hybrid": self._gn_step_batch_hybrid, "split": self._gn_step_batch_tiled,
                "fused": self._gn_step_batch_fused}[pipeline]

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
