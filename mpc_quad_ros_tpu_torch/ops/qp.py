"""Box-constrained dense QPs,

    min_z  1/2 z^T H z + g^T z   s.t.  lb <= z <= ub      (z = dU, nz = 4 N),

solved by fixed-iteration methods in plain tensor code.  Counterpart of
``mpc_quad_ros_tpu/ops/qp.py``, which computes them in XLA (no Pallas
kernel stands behind them): the per-scenario ``SQPSolver.solve`` runs them.
The batched Jacobi-scaled IPM is kernel E (``ops/cuda/qp_kernel.py``).

- ``solve_box_qp_pdip``: the unscaled primal-dual interior point, cold or
  warm-started from duals (``WS_GAMMA``, ``WS_FLOOR``);
- ``solve_box_qp_projected_newton``: projected Newton on the active set
  (masked KKT solve);
- ``qp_kkt_residual``: the projected-gradient KKT violation.

Every function takes any leading batch dims, the port's form of ``vmap``,
and reduces over the last axis only, never across scenarios: a NaN (or a
matrix that is not positive definite) in one scenario leaves the others'
results unchanged.
"""

from __future__ import annotations

import torch

WS_GAMMA = 0.01   # warm-start primal interiority margin (fraction of box width)
WS_FLOOR = 1e-3   # warm-start dual floor


def _sym_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M x = rhs for symmetric positive definite M (..., n, n), rhs (..., n),
    by Cholesky.  ``cholesky_ex`` neither syncs with the card nor raises for
    the batch: a scenario whose factorisation fails gets NaN, as the JAX
    Cholesky gives it, and the others are untouched."""
    L, info = torch.linalg.cholesky_ex(M)
    L = L.masked_fill((info != 0)[..., None, None], float("nan"))
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _max_step(v: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """Fraction-to-the-boundary step (tau = 0.995) keeping v + a dv > 0,
    capped at 1; (..., 1)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return (0.995 * ratio.amin(-1, keepdim=True)).clamp(max=1.0)


def _matvec(H: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (H @ z[..., None])[..., 0]


def solve_box_qp_pdip(H: torch.Tensor, g: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
                      iters: int = 12, zl0: torch.Tensor | None = None,
                      zu0: torch.Tensor | None = None, return_duals: bool = False):
    """Primal-dual interior point for box QPs, `iters` Newton steps.

    With slacks sl = z - lb, su = ub - z and multipliers zl, zu, each step
    solves the condensed Newton system (H + diag(zl/sl + zu/su)) dz = -r by
    Cholesky, toward the barrier mu = 0.1 x the duality gap, and takes the
    fraction-to-the-boundary step.  Cold (no zl0/zu0): the box's midpoint and
    unit duals.  Warm: z = 0 pushed WS_GAMMA of the box's width inside it,
    the duals floored at WS_FLOOR.  Returns clip(z, lb, ub), and the final
    duals with `return_duals`."""
    nz = H.shape[-1]
    width = ub - lb
    if zl0 is None:
        z = 0.5 * (lb + ub)
        zl = torch.ones_like(z)
        zu = torch.ones_like(z)
    else:
        z = torch.zeros_like(lb).clamp(lb + WS_GAMMA * width, ub - WS_GAMMA * width)
        zl = zl0.clamp_min(WS_FLOOR)
        zu = zu0.clamp_min(WS_FLOOR)
    sl = z - lb
    su = ub - z
    eps = 1e-10 * width.clamp_min(1.0)
    for _ in range(iters):
        gap = ((sl * zl).sum(-1, keepdim=True) + (su * zu).sum(-1, keepdim=True)) / (2 * nz)
        mu = 0.1 * gap
        r = _matvec(H, z) + g - zl + zu
        M = H + torch.diag_embed(zl / sl + zu / su)
        dz = _sym_solve(M, -r + (mu - sl * zl) / sl - (mu - su * zu) / su)
        dzl = (mu - sl * zl - zl * dz) / sl
        dzu = (mu - su * zu + zu * dz) / su
        alpha = torch.minimum(torch.minimum(_max_step(sl, dz), _max_step(su, -dz)),
                              torch.minimum(_max_step(zl, dzl), _max_step(zu, dzu)))
        z = z + alpha * dz
        # slacks kept strictly positive for numerical safety
        sl = torch.maximum(z - lb, eps)
        su = torch.maximum(ub - z, eps)
        zl = (zl + alpha * dzl).clamp_min(1e-12)
        zu = (zu + alpha * dzu).clamp_min(1e-12)
    zc = torch.minimum(torch.maximum(z, lb), ub)
    return (zc, zl, zu) if return_duals else zc


def solve_box_qp_projected_newton(H: torch.Tensor, g: torch.Tensor, lb: torch.Tensor,
                                  ub: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Projected Newton (Bertsekas 1982).  Each iteration freezes the active
    set {z at lb with grad > 0} | {z at ub with grad < 0} (within 1e-9),
    solves the free block's Newton system with H's active rows and columns
    masked to the identity, and projects the full step onto the box."""
    z = torch.minimum(torch.maximum(torch.zeros_like(g), lb), ub)
    for _ in range(iters):
        grad = _matvec(H, z) + g
        active = ((z <= lb + 1e-9) & (grad > 0)) | ((z >= ub - 1e-9) & (grad < 0))
        fm = (~active).to(H.dtype)
        Hm = H * (fm[..., :, None] * fm[..., None, :]) + torch.diag_embed(1.0 - fm)
        z = torch.minimum(torch.maximum(z + _sym_solve(Hm, -grad * fm), lb), ub)
    return z


def qp_kkt_residual(H, g, lb, ub, z) -> torch.Tensor:
    """Projected-gradient KKT violation max |clip(z - (Hz + g), lb, ub) - z|
    of every leading index (NaN propagates)."""
    grad = _matvec(H, z) + g
    proj = torch.minimum(torch.maximum(z - grad, lb), ub) - z
    return proj.abs().amax(-1)
