"""SQP-RTI nonlinear MPC over the quadrotor horizon.

Counterpart of ``mpc_quad_ros_tpu/ops/sqp.py``: the batched ``solve_batch``
and the per-scenario ``solve``.

``solve_batch`` (B scenarios through the batched kernels), with two QP
backends:

- ``qp_method="pdip"``: the condensed primal-dual interior point, through
  one of three pipelines (``MPCConfig.pipeline``) that compute the same
  step by the same device code:
  - "hybrid" (``_gn_step_batch_hybrid``): kernel A
    (``ops/cuda/lin_kernel.py``: x+ and J = [A | B] per scenario and
    stage), the glue, then kernel B (``ops/cuda/sqp_fused_kernel.py``:
    condensing, IPM, KKT, dX);
  - "split" (``_gn_step_batch_tiled``): kernel A, the glue, kernel D
    (``ops/cuda/condense_kernel.py``: H, g, M, d), kernel E
    (``ops/cuda/qp_kernel.py``: the Jacobi-scaled IPM), then the KKT and
    X + d + M z in plain tensor code;
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
- "projected_newton" and ``shift_warm_start`` raise: the JAX
  ``solve_batch`` silently runs pdip for the one and ignores the other.

Any batch size B is taken as it is.  Below ``SMALL_BATCH`` scenarios the
condensed methods take the small-batch step (``_gn_step_batch_soa``)
whatever the pipeline, as the JAX package's ``solve_batch`` does: the
"split" step with kernel J (``ops/cuda/condense_kernel.py``: condensing fed
the A and B blocks of kernel A's J) in place of kernel D.

``solve`` runs the JAX package's per-scenario algorithm (its ``solve``, or
``vmap`` of it) on one scenario, x0 (13,), or on B, x0 (B, 13):
``shift_warm_start`` shifts the carry one stage, then each Gauss-Newton step
(``_step_per_scenario``) is kernel A, kernel J below ``SMALL_BATCH`` or
kernel D from there, the QP in plain tensor code (``ops/qp.py``: the
unscaled IPM for "pdip", or "projected_newton"), the KKT and the update —
the "split" step with another QP (``_gn_step_condensed``).  "riccati" is the
batched Riccati step.  "auto" switches at ``AUTO_RICCATI_MIN_N`` too (the
JAX package's per-scenario path at 32, where this path's f32 IPM has lost
every scenario), and a dense-H method past ``FUSED_N_MAX`` warns and takes
"riccati" here too.

Cost: LINEAR_LS with W = diag(q_pos, q_quat, q_vel, q_rate, r) and the
reference's quaternion-weight mean quirk; stage cost x dt (x 1 without
``scale_stage_by_dt``), terminal cost unscaled; u in [u_lb, u_ub].
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable

import numpy as np
import torch

from ..models.augmented import fold_drag
from ..models.dynamics import rk4_step
from ..utils.containers import Tensors
from .cuda.condense_common import split_AB
from .cuda.condense_kernel import condense_cost_from_AB, condense_cost_from_J
from .cuda.lin_kernel import linearize, model_constants
from .cuda.qp_kernel import solve_box_qp_pdip_batch
from .cuda.riccati_kernel import riccati_ipm_from_J
from .cuda.sqp_fused_kernel import fused_sqp_from_J, fused_sqp_step
from .qp import qp_kkt_residual, solve_box_qp_pdip, solve_box_qp_projected_newton

# The condensed kernels' ceiling, the JAX package's FUSED_N_MAX
# (mpc_quad_ros_tpu/ops/sqp.py:67).  Kernels B and F are built for nz = 4 N
# <= 160 (five register slots a lane); one packed nz x (nz + 1) matrix a
# scenario keeps them inside an H100 block's 232,448 B there: kernel B's
# block, mpcq_sqp_ws_bytes(N), is 17,808 B at N = 10 (two scenarios) and
# 131,144 B at N = 40 (one); kernel F's 168,584 B; kernel E's 129,760 B at
# nz = 160.  The warm
# duals add nothing (read and written in device memory).  Past it a dense-H
# method falls back to the Riccati backend, whatever the pipeline.  A
# constant, so the CPU and the card dispatch alike.
FUSED_N_MAX = 40
DENSE_H_METHODS = ("pdip", "projected_newton")
PIPELINES = ("hybrid", "split", "fused")
# "auto" takes the Riccati backend from this horizon on.  Measured with
# bench/crossover.py on an NVIDIA H100 80GB HBM3 at 700 W, B=16384, nodes
# 0.1 s apart: the condensed step is the faster up to N=20 (191 against
# 283 ms per batched solve) and the slower at N=30 (934 against 531 ms), but
# from N=16 on its f32 IPM returns non-finite controls for part of the batch
# (0.4 % at N=16, 10 % at N=18, 39 % at N=20, none at N=10-14), and the
# Riccati step for none.
# The per-scenario ``solve`` switches here too, not at the JAX package's 32
# (``AUTO_RICCATI_MIN_N_XLA``, ``mpc_quad_ros_tpu/ops/sqp.py:60``): on the
# same card, B=16384, its f32 unscaled IPM returns non-finite controls for
# 0.62 % of the scenarios at N=16, 71 % at N=20, 99.4 % at N=24 and all at
# N=28 and 31 (``bench/crossover.py::per_scenario_row``).
AUTO_RICCATI_MIN_N = 16
# Batches below this take the small-batch step, the JAX package's lane-major
# route for B < 128 (``mpc_quad_ros_tpu/ops/sqp.py:899, 946-947``): its
# condensing kernel is fed A and B (``_assemble_batch_soa``).
SMALL_BATCH = 128


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
    qp_method: str = "pdip"      # "pdip" | "projected_newton" (solve only) | "riccati" | "auto"
    # Shift the warm start one stage a tick (``solve`` only; solve_batch
    # raises): off matches acados' plain primal warm start.
    shift_warm_start: bool = False
    # Stage cost x dt, as acados integrates the LINEAR_LS term over each
    # shooting interval; False gives an unscaled discrete sum.
    scale_stage_by_dt: bool = True
    pipeline: str = "hybrid"     # "hybrid" | "split" | "fused" (solve_batch's condensed methods)
    # Carry the IPM duals (zl, zu) across solves and warm-start the QP from
    # them.  Off by default, as in the JAX package: it halves the
    # factorisations on near-steady chains and loses on fast transients.
    warm_start_duals: bool = False

    @property
    def dt(self) -> float:
        return self.t_horizon / self.n_nodes

    @property
    def stage_scale(self) -> float:
        """The stage cost is integrated over the shooting interval (dt), or
        summed (1) without `scale_stage_by_dt`."""
        return self.dt if self.scale_stage_by_dt else 1.0

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


def init_carry(cfg: MPCConfig, x0: torch.Tensor, u0: torch.Tensor | None = None) -> SolverCarry:
    """Every node at x0, every control at u0 (4,) or (..., 4), u_ref when
    None; x0 (..., 13).  With `warm_start_duals`, unit duals: the IPM's
    cold-start value, so the first solve is a (floored) cold start."""
    N = cfg.n_nodes
    X = x0[..., None, :].expand(x0.shape[:-1] + (N + 1, 13)).clone()
    if u0 is None:
        U = torch.full(x0.shape[:-1] + (N, 4), cfg.u_ref, dtype=x0.dtype, device=x0.device)
    else:
        u0 = torch.as_tensor(u0, dtype=x0.dtype, device=x0.device)
        U = u0[..., None, :].expand(x0.shape[:-1] + (N, 4)).clone()
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

    def _model_consts(self, X) -> list[float] | None:
        """Kernels A's and F's model constants for a launch on X's device,
        derived at the first such launch (None on the CPU, where the plain
        versions run)."""
        if X.is_cuda and self._lin_consts is None:
            self._lin_consts = model_constants(self.f.params, self.cfg.dt)
        return self._lin_consts

    def _linearize(self, X, U, aug):
        """Kernel A along (X, U): (xp, J)."""
        return linearize(X, U, aug, self.f, self.cfg.dt, self._model_consts(X))

    def _resolve_qp_method(self, tiled: bool = True) -> str:
        """The QP backend of this configuration, for ``solve_batch``
        (`tiled`, which raises on "projected_newton") or the per-scenario
        ``solve``.  "auto" switches to "riccati" at AUTO_RICCATI_MIN_N; a
        dense-H method past the condensed kernels' ceiling (FUSED_N_MAX,
        which kernels D's and J's packed H set for ``solve`` too) falls back
        to "riccati" with a warning."""
        m, N = self.cfg.qp_method, self.cfg.n_nodes
        if m == "projected_newton" and tiled:
            raise NotImplementedError(
                "qp_method='projected_newton' runs in the per-scenario SQPSolver.solve; "
                "solve_batch has no batched projected Newton (ROADMAP queue 3)")
        if m not in ("pdip", "projected_newton", "riccati", "auto"):
            raise ValueError(f"unknown qp_method {m!r}")
        if m == "auto":
            return "pdip" if N < AUTO_RICCATI_MIN_N else "riccati"
        if m in DENSE_H_METHODS and N > FUSED_N_MAX:
            warnings.warn(
                f"qp_method={m!r} at n_nodes={N} exceeds the condensed kernels' "
                f"ceiling (FUSED_N_MAX = {FUSED_N_MAX}); using the O(N) Riccati "
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

    def _gn_step_batch_tiled(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug, from_AB=False):
        """The "split" step: kernel A, the glue, kernel D (H, g, M, d), g +=
        gu, kernel E (the IPM, warm or cold), then the KKT and X + (d + M z)
        in plain tensor code, as the JAX split step leaves them to XLA.
        `from_AB` splits J into its A and B blocks and condenses them with
        kernel J in place of kernel D."""
        return self._gn_step_condensed(X, U, zl, zu, x0, y_ref, y_ref_N, aug, from_AB,
                                       self._qp_kernel_e)

    def _gn_step_condensed(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug, from_AB, qp):
        """Kernel A, the glue, kernel D or (`from_AB`) kernel J, g += gu, then
        `qp` (H, g, lb, ub, zl, zu) -> (z, zl, zu), the KKT and the update."""
        xp, J = self._linearize(X, U, aug)
        r, dx0, ex0, gu, lb, ub = self.qp_inputs(X, U, x0, y_ref, y_ref_N, xp)
        w = self.cfg.weight_tuples()
        if from_AB:
            A, Bm = (a.contiguous() for a in split_AB(J))
            H, g, M, d = condense_cost_from_AB(A, Bm, r, dx0, ex0, *w)
        else:
            H, g, M, d = condense_cost_from_J(J, r, dx0, ex0, *w)
        g = g + gu
        z, zl, zu = qp(H, g, lb, ub, zl, zu)
        kkt = qp_kkt_residual(H, g, lb, ub, z)
        B = X.shape[0]
        dX = d + (M.reshape(B, -1, M.shape[-1]) @ z[..., None]).reshape(d.shape)
        return X + dX, U + z.reshape(U.shape), zl, zu, kkt

    def _qp_kernel_e(self, H, g, lb, ub, zl, zu):
        """Kernel E, the Jacobi-scaled IPM: warm from the carried duals with
        `warm_start_duals`, else cold with the duals passed through."""
        if not self._warm(zl):
            return solve_box_qp_pdip_batch(H, g, lb, ub, self.cfg.qp_iters)[0], zl, zu
        return solve_box_qp_pdip_batch(H, g, lb, ub, self.cfg.qp_iters, zl, zu)

    def _qp_unscaled(self, H, g, lb, ub, zl, zu):
        """The per-scenario QP of the JAX ``_gn_step``: the unscaled IPM, warm
        from the carried duals with `warm_start_duals`."""
        if not self._warm(zl):
            return solve_box_qp_pdip(H, g, lb, ub, self.cfg.qp_iters), zl, zu
        return solve_box_qp_pdip(H, g, lb, ub, self.cfg.qp_iters, zl, zu, return_duals=True)

    def _qp_projected_newton(self, H, g, lb, ub, zl, zu):
        return solve_box_qp_projected_newton(H, g, lb, ub, self.cfg.qp_iters), zl, zu

    def _gn_step_batch_soa(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug):
        """The small-batch step (B < SMALL_BATCH, every pipeline): the JAX
        package's ``_assemble_batch_soa`` route — kernel A, A and B apart,
        kernel J, then kernel E, the KKT and X + (d + M z), as "split"."""
        return self._gn_step_batch_tiled(X, U, zl, zu, x0, y_ref, y_ref_N, aug, from_AB=True)

    def _gn_step_batch_fused(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug):
        """The "fused" step: kernel F, the update."""
        cfg = self.cfg
        warm = self._warm(zl)
        z, dX, kkt, zl_n, zu_n = fused_sqp_step(
            X, U, *self.step_inputs(X, U, x0, y_ref, y_ref_N), aug, self.f, cfg.dt,
            *cfg.weight_tuples(), cfg.qp_iters, duals=(zl, zu) if warm else None,
            consts=self._model_consts(X))
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
        """One MPC solve for each of B scenarios, through the batched kernels.

        carry   : warm-started (X (B, N+1, 13), U (B, N, 4)) and, with
                  `warm_start_duals`, the IPM duals zl, zu (B, N*4)
        x0      : (B, 13) measured states
        y_ref   : (B, N, 13) stage references;  y_ref_N : (B, 13) terminal
        aug     : per-scenario RGPState (B, 3, ...) / FoldedDrag, or None

        `shift_warm_start` raises: the JAX ``solve_batch`` silently ignores
        it, and this one does not shift either."""
        if self.cfg.shift_warm_start:
            raise ValueError("shift_warm_start is read by SQPSolver.solve only; solve_batch "
                             "does not shift the warm start (ROADMAP queue 3)")
        return self._iterate(self._step(x0.shape[0]), carry, x0, y_ref, y_ref_N, aug)

    def solve(self, carry: SolverCarry, x0: torch.Tensor, y_ref: torch.Tensor,
              y_ref_N: torch.Tensor, aug=None) -> tuple[SolverCarry, MPCSolution]:
        """The per-scenario MPC solve, the JAX package's ``solve`` (its
        algorithm under ``vmap`` for leading-(B,) inputs): the carry shifted
        one stage with `shift_warm_start`, then `sqp_iters` Gauss-Newton
        steps of ``_step_per_scenario``.

        x0 (13,) with carry (N+1, 13), (N, 4), y_ref (N, 13), y_ref_N (13,)
        and aug (3, ...) solves one scenario and returns the same ranks;
        x0 (B, 13) with the shapes of ``solve_batch`` solves B."""
        if x0.dim() == 1:
            one = lambda a: a[None]
            aug = None if aug is None else fold_drag(aug).map(one)
            carry, sol = self.solve(carry.map(one), one(x0), one(y_ref), one(y_ref_N), aug)
            first = lambda a: a[0]
            return carry.map(first), sol.map(first)
        step = self._step_per_scenario(x0.shape[0])
        if self.cfg.shift_warm_start:
            shift = lambda a, k: None if a is None else torch.cat([a[:, k:], a[:, -k:]], 1)
            carry = SolverCarry(X=shift(carry.X, 1), U=shift(carry.U, 1),
                                zl=shift(carry.zl, 4), zu=shift(carry.zu, 4))
        return self._iterate(step, carry, x0, y_ref, y_ref_N, aug)

    def _iterate(self, step, carry, x0, y_ref, y_ref_N, aug) -> tuple[SolverCarry, MPCSolution]:
        """`sqp_iters` applications of `step` from the carry, then the cost;
        the KKT residual is the last step's."""
        aug = fold_drag(aug)
        if aug is not None:
            aug = aug.map(lambda a: a.contiguous())
        carry = carry.map(lambda a: a.contiguous())
        X, U, zl, zu = carry.X, carry.U, carry.zl, carry.zu
        x0, y_ref, y_ref_N = x0.contiguous(), y_ref.contiguous(), y_ref_N.contiguous()
        kkt = None
        for _ in range(self.cfg.sqp_iters):
            X, U, zl, zu, kkt = step(X, U, zl, zu, x0, y_ref, y_ref_N, aug)
        cost = self.ls_cost(X, U, y_ref, y_ref_N)
        return (SolverCarry(X=X, U=U, zl=zl, zu=zu),
                MPCSolution(X=X, U=U, cost=cost, kkt_residual=kkt))

    def _step(self, B: int):
        """The Gauss-Newton step of ``solve_batch`` at batch B: by the QP
        backend, then, for the condensed methods, the small-batch step below
        SMALL_BATCH and the pipeline's from there.  An unknown pipeline
        raises (the JAX package falls back to "split")."""
        pipeline = self.cfg.pipeline
        if pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {pipeline!r}; expected one of {PIPELINES}")
        if self._resolve_qp_method() == "riccati":
            return self._gn_step_batch_riccati
        if B < SMALL_BATCH:
            return self._gn_step_batch_soa
        return {"hybrid": self._gn_step_batch_hybrid, "split": self._gn_step_batch_tiled,
                "fused": self._gn_step_batch_fused}[pipeline]

    def _step_per_scenario(self, B: int):
        """The Gauss-Newton step of ``solve`` at batch B, the JAX ``_gn_step``:
        kernels A and C and the line search for "riccati"; else kernel A,
        kernel J below SMALL_BATCH or kernel D from there, then the unscaled
        IPM or projected Newton in tensor code, the KKT and the update."""
        method = self._resolve_qp_method(tiled=False)
        if method == "riccati":
            return self._gn_step_batch_riccati
        qp = self._qp_unscaled if method == "pdip" else self._qp_projected_newton
        return functools.partial(self._gn_step_condensed, from_AB=B < SMALL_BATCH, qp=qp)

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
