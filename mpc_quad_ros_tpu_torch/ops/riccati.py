"""Riccati-recursion solvers of the long-horizon OCP, in eager PyTorch.

Counterpart of ``mpc_quad_ros_tpu/ops/riccati.py``: the same equations, each
stage loop a Python loop, every tensor batched over leading dims (the JAX
functions are vmapped instead).  ``solve_ocp_box_riccati_ipm`` is the float64
oracle of kernel C (``ops/cuda/riccati_kernel.py``); the kernel and its plain
version follow the Pallas kernel's algorithm, which differs from this one
only in how it solves the 4x4 systems and symmetrises.

Equations (time-varying LQR with affine terms):
    P_N = Q_N,  p_N = q_N
    K_k = (R + BᵀPB)^-1 Bᵀ(PA)
    k_k = (R + BᵀPB)^-1 (r + Bᵀ(P c + p))
    P_k = Q + AᵀPA - AᵀPB K_k
    p_k = q + Aᵀ(P c + p) - K_kᵀ(r + Bᵀ(P c + p))
with dynamics Δx' = A Δx + B Δu + c and stage cost
    1/2 ΔxᵀQΔx + qᵀΔx + 1/2 ΔuᵀRΔu + rᵀΔu.

Shapes: A (..., N, nx, nx), B (..., N, nx, nu), c / q_lin (..., N, nx),
r_lin and the bounds (..., N, nu), dx0 / p_term (..., nx); the diagonal
weights Q_diag (nx,), R_diag (nu,), P_term_diag (nx,).
"""

from __future__ import annotations

import torch

from .cuda.qp_kernel import step_length


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.mT)


def riccati_step(A, B, c, Q_diag, q_lin, R_diag, r_lin, P_term_diag, p_term,
                 dx0=None, u_lb=None, u_ub=None):
    """The affine LQR with optional feedforward clamping; returns (dU, dX)."""
    N, nx, nu = B.shape[-3:]
    Q = torch.diag(Q_diag.to(A.dtype))
    R = torch.diag(R_diag.to(A.dtype))
    P = torch.diag(P_term_diag.to(A.dtype)).expand(A.shape[:-3] + (nx, nx))
    p = p_term
    Ks, ks = [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        PA, PB = P @ A_k, P @ B_k
        Pc_p = _mv(P, c[..., k, :]) + p
        G = _sym(R + B_k.mT @ PB)
        K = torch.linalg.solve(G, B_k.mT @ PA)
        rr = r_lin[..., k, :] + _mv(B_k.mT, Pc_p)
        Ks[k], ks[k] = K, torch.linalg.solve(G, rr)
        P = _sym(Q + A_k.mT @ PA - A_k.mT @ PB @ K)
        p = q_lin[..., k, :] + _mv(A_k.mT, Pc_p) - _mv(K.mT, rr)

    dx = torch.zeros(A.shape[:-3] + (nx,), dtype=A.dtype, device=A.device) if dx0 is None else dx0
    dXs, dUs = [dx], []
    for k in range(N):
        du = -_mv(Ks[k], dx) - ks[k]
        if u_lb is not None:
            du = torch.minimum(torch.maximum(du, u_lb[..., k, :]), u_ub[..., k, :])
        dx = _mv(A[..., k, :, :], dx) + _mv(B[..., k, :, :], du) + c[..., k, :]
        dUs.append(du)
        dXs.append(dx)
    return torch.stack(dUs, -2), torch.stack(dXs, -2)


def _riccati_newton(A, B, Q, q_lin, R_stage, r_lin, P_T, p_term):
    """Exact equality-constrained LQR Newton step with per-stage control
    Hessians R_stage (..., N, nu, nu) and dx_0 = 0, no defects.  Returns
    (dU, dX)."""
    N, nx, nu = B.shape[-3:]
    P = P_T.expand(A.shape[:-3] + (nx, nx))
    p = p_term
    Ks, ks = [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        PA, PB = P @ A_k, P @ B_k
        G = _sym(R_stage[..., k, :, :] + B_k.mT @ PB)
        rr = r_lin[..., k, :] + _mv(B_k.mT, p)
        Ks[k] = K = torch.linalg.solve(G, B_k.mT @ PA)
        ks[k] = torch.linalg.solve(G, rr)
        P = _sym(Q + A_k.mT @ PA - A_k.mT @ PB @ K)
        p = q_lin[..., k, :] + _mv(A_k.mT, p) - _mv(K.mT, rr)

    dx = torch.zeros(A.shape[:-3] + (nx,), dtype=A.dtype, device=A.device)
    dXs, dUs = [dx], []
    for k in range(N):
        du = -_mv(Ks[k], dx) - ks[k]
        dx = _mv(A[..., k, :, :], dx) + _mv(B[..., k, :, :], du)
        dUs.append(du)
        dXs.append(dx)
    return torch.stack(dUs, -2), torch.stack(dXs, -2)


def _rollout(A, B, c, dx0, du):
    dx, dXs = dx0, [dx0]
    for k in range(du.shape[-2]):
        dx = _mv(A[..., k, :, :], dx) + _mv(B[..., k, :, :], du[..., k, :]) + c[..., k, :]
        dXs.append(dx)
    return torch.stack(dXs, -2)


def solve_ocp_box_riccati_ipm(A, B, c, Q_diag, q_lin, R_diag, r_lin,
                              P_term_diag, p_term, dx0, u_lb, u_ub, iters: int = 12):
    """The box-constrained OCP QP by a Riccati-factorised primal-dual
    interior point:

        min  sum_k 1/2 dx_kᵀQdx_k + q_kᵀdx_k + 1/2 du_kᵀRdu_k + r_kᵀdu_k
             + 1/2 dx_NᵀP dx_N + p_Nᵀdx_N
        s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,  dx_0 = dx0,
             u_lb <= du <= u_ub.

    Cold start at the box midpoint with unit duals; exactly `iters`
    iterations of mu = 0.1 gap, one Riccati sweep with R + diag(zl/sl + zu/su)
    per stage, the fraction-to-the-boundary step (0.995), slack floor
    1e-10 max(width, 1), dual floor 1e-12.  du stays inside the box and dx is
    its affine rollout throughout.  Returns (dU, dX, zl, zu)."""
    dtype = A.dtype
    Q = torch.diag(Q_diag.to(dtype))
    P_T = torch.diag(P_term_diag.to(dtype))
    Rd = R_diag.to(dtype)
    N, nu = u_lb.shape[-2:]
    eps = 1e-10 * torch.clamp_min(u_ub - u_lb, 1.0)

    du = 0.5 * (u_lb + u_ub)
    zl = torch.ones_like(du)
    zu = torch.ones_like(du)
    sl = du - u_lb
    su = u_ub - du
    n_all = 2 * N * nu
    for _ in range(iters):
        mu = (0.1 * (((sl * zl).sum((-2, -1)) + (su * zu).sum((-2, -1))) / n_all))[..., None, None]
        dX = _rollout(A, B, c, dx0, du)
        R_stage = torch.diag_embed(Rd + zl / sl + zu / su)
        r_hat = Rd * du + r_lin - zl + zu - (mu - sl * zl) / sl + (mu - su * zu) / su
        q_hat = Q_diag * dX[..., :-1, :] + q_lin
        p_hat = P_term_diag * dX[..., N, :] + p_term
        ddu, _ = _riccati_newton(A, B, Q, q_hat, R_stage, r_hat, P_T, p_hat)

        dzl = (mu - sl * zl - zl * ddu) / sl
        dzu = (mu - su * zu + zu * ddu) / su
        alpha = step_length(*(a.flatten(-2) for a in (sl, su, zl, zu, ddu, dzl, dzu)))[..., None, None]
        du = du + alpha * ddu
        sl = torch.maximum(du - u_lb, eps)
        su = torch.maximum(u_ub - du, eps)
        zl = torch.clamp_min(zl + alpha * dzl, 1e-12)
        zu = torch.clamp_min(zu + alpha * dzu, 1e-12)
    du = torch.minimum(torch.maximum(du, u_lb), u_ub)
    return du, _rollout(A, B, c, dx0, du), zl, zu
