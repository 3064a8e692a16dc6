"""Plain PyTorch version of the box-QP interior point that kernel B runs per
scenario (``csrc/ipm_box.cuh``), batched over scenarios.  Counterpart of
``mpc_quad_ros_tpu/ops/pallas/qp_kernel.py::ipm_box_solve`` (cold start).

The standalone launch of that IPM (``_qp_kernel``) is not on the port's path
yet; only this core is.
"""

from __future__ import annotations

import torch


def _max_step(v, dv):
    """min(1, 0.995 * min_i -v_i / dv_i over dv_i < 0)."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        torch.full_like(v, float("inf")))
    return torch.minimum(torch.ones_like(ratio[..., 0]), 0.995 * ratio.amin(-1))


def ipm_box_solve(H, g, lb, ub, iters: int):
    """min 1/2 z'Hz + g'z s.t. lb <= z <= ub for every leading index:
    Jacobi scaling s = rsqrt(max(diag H, 1e-12)), cold start at the box
    midpoint with unit duals, exactly `iters` primal-dual Newton steps
    (Cholesky of H + diag(zl/sl + zu/su); fraction-to-the-boundary 0.995;
    slack floor 1e-10 max(width, 1), dual floor 1e-12), then
    clip(z, lb, ub) * s.  H (..., nz, nz), vectors (..., nz)."""
    nz = H.shape[-1]
    s = torch.rsqrt(torch.clamp_min(H.diagonal(dim1=-2, dim2=-1), 1e-12))
    H = H * s[..., :, None] * s[..., None, :]
    g = g * s
    lb = lb / s
    ub = ub / s
    eps = 1e-10 * torch.clamp_min(ub - lb, 1.0)

    z = 0.5 * (lb + ub)
    zl = torch.ones_like(z)
    zu = torch.ones_like(z)
    sl = z - lb
    su = ub - z
    for _ in range(iters):
        mu = (0.1 * (((sl * zl).sum(-1) + (su * zu).sum(-1)) / (2 * nz)))[..., None]
        r = (H @ z[..., None])[..., 0] + g - zl + zu
        sli, sui = 1.0 / sl, 1.0 / su
        rhs = -r + (mu - sl * zl) * sli - (mu - su * zu) * sui
        L, _ = torch.linalg.cholesky_ex(H + torch.diag_embed(zl * sli + zu * sui))
        dz = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        dzl = (mu - sl * zl - zl * dz) * sli
        dzu = (mu - su * zu + zu * dz) * sui
        alpha = torch.minimum(torch.minimum(_max_step(sl, dz), _max_step(su, -dz)),
                              torch.minimum(_max_step(zl, dzl), _max_step(zu, dzu)))[..., None]
        z = z + alpha * dz
        sl = torch.maximum(z - lb, eps)
        su = torch.maximum(ub - z, eps)
        zl = torch.clamp_min(zl + alpha * dzl, 1e-12)
        zu = torch.clamp_min(zu + alpha * dzu, 1e-12)
    return torch.minimum(torch.maximum(z, lb), ub) * s
