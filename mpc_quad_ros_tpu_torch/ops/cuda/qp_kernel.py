"""Kernel E: the batched box-QP interior point, and its plain version — the
IPM that kernels B and F also run per scenario (``csrc/ipm_box.cuh``).

Replaces ``mpc_quad_ros_tpu/ops/pallas/qp_kernel.py::_qp_kernel`` (entry
``solve_box_qp_pdip_pallas(..., symmetrize=False)``); the CUDA source is
``csrc/qp_kernel.cu`` (one warp per scenario, H staged in shared memory;
bounded by the serial Cholesky latency per scenario — see the source's
header).  ``ipm_box_solve`` is the plain version, counterpart of the Pallas
core ``ipm_box_solve`` with its cold and warm starts.

``solve_box_qp_pdip_batch`` runs the plain version for CPU tensors and
launches the kernel for CUDA tensors (f32, contiguous, sm_90), raising on
anything else.  An nz whose workspace passes the device's shared memory per
block (nz > 135 on an H100) raises ``ValueError`` before the launch.
"""

from __future__ import annotations

import torch

from . import _build

# The warm start's primal margin (a fraction of the scaled box width) and its
# dual floor (in the scaled system), as in the JAX kernel.
WS_GAMMA = 0.01
WS_FLOOR = 1e-3


def _max_step(v, dv):
    """min(1, 0.995 * min_i -v_i / dv_i over dv_i < 0)."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        torch.full_like(v, float("inf")))
    return torch.minimum(torch.ones_like(ratio[..., 0]), 0.995 * ratio.amin(-1))


def step_length(sl, su, zl, zu, dz, dzl, dzu):
    """The interior point's fraction-to-the-boundary step over the last dim:
    the largest alpha <= 1 that keeps 0.995 of every slack and dual."""
    return torch.minimum(torch.minimum(_max_step(sl, dz), _max_step(su, -dz)),
                         torch.minimum(_max_step(zl, dzl), _max_step(zu, dzu)))


def ipm_box_solve(H, g, lb, ub, iters: int, zl0=None, zu0=None):
    """min 1/2 z'Hz + g'z s.t. lb <= z <= ub for every leading index:
    Jacobi scaling s = rsqrt(max(diag H, 1e-12)); the cold start at the box
    midpoint with unit duals, or, given the previous duals zl0, zu0
    (unscaled), the warm start z = clip(0, lb' + WS_GAMMA w, ub' - WS_GAMMA w)
    with w = ub' - lb' and duals max(zl0 s, WS_FLOOR); exactly `iters`
    primal-dual Newton steps (Cholesky of H + diag(zl/sl + zu/su);
    fraction-to-the-boundary 0.995; slack floor 1e-10 max(width, 1), dual
    floor 1e-12).  Returns (clip(z, lb', ub') s, zl / s, zu / s).
    H (..., nz, nz), vectors (..., nz)."""
    nz = H.shape[-1]
    s = torch.rsqrt(torch.clamp_min(H.diagonal(dim1=-2, dim2=-1), 1e-12))
    H = H * s[..., :, None] * s[..., None, :]
    g = g * s
    lb = lb / s
    ub = ub / s
    width = ub - lb
    eps = 1e-10 * torch.clamp_min(width, 1.0)

    if zl0 is not None:
        z = torch.minimum(torch.maximum(torch.zeros_like(g), lb + WS_GAMMA * width),
                          ub - WS_GAMMA * width)
        zl = torch.clamp_min(zl0 * s, WS_FLOOR)
        zu = torch.clamp_min(zu0 * s, WS_FLOOR)
    else:
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
        alpha = step_length(sl, su, zl, zu, dz, dzl, dzu)[..., None]
        z = z + alpha * dz
        sl = torch.maximum(z - lb, eps)
        su = torch.maximum(ub - z, eps)
        zl = torch.clamp_min(zl + alpha * dzl, 1e-12)
        zu = torch.clamp_min(zu + alpha * dzu, 1e-12)
    return torch.minimum(torch.maximum(z, lb), ub) * s, zl / s, zu / s


def check_smem(name: str, need: int, device, what: str) -> None:
    """Raise ValueError when one block's workspace passes the device's shared
    memory per block, naming both and the size that asked for it."""
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if need > limit:
        from ..sqp import FUSED_N_MAX

        raise ValueError(
            f"{name}: {what} needs {need} bytes of shared memory per block, the device "
            f"allows {limit}; the condensed pipelines take N <= FUSED_N_MAX = {FUSED_N_MAX} "
            f"(use qp_method='riccati' or 'auto' past it)")


def _launch(H, g, lb, ub, iters, zl0, zu0):
    B, nz = g.shape
    tensors = dict(H=H, g=g, lb=lb, ub=ub)
    if zl0 is not None:
        tensors.update(zl0=zl0, zu0=zu0)
    shapes = {k: (B, nz) for k in tensors}
    shapes["H"] = (B, nz, nz)
    _build.check_cuda_inputs("qp_kernel", tensors, shapes)
    lib = _build.load_library()
    check_smem("qp_kernel", lib.mpcq_box_qp_ws_bytes(nz), H.device, f"nz={nz}")
    z, zl, zu = (torch.empty((B, nz), dtype=H.dtype, device=H.device) for _ in range(3))
    duals = [zl0.data_ptr(), zu0.data_ptr()] if zl0 is not None else [None, None]
    rc = lib.mpcq_box_qp(H.data_ptr(), g.data_ptr(), lb.data_ptr(), ub.data_ptr(), *duals,
                         z.data_ptr(), zl.data_ptr(), zu.data_ptr(), B, nz, int(iters),
                         torch.cuda.current_stream(H.device).cuda_stream)
    solve_box_qp_pdip_batch.launches += 1
    _build.check_status("qp_kernel", rc)
    return z, zl, zu


def solve_box_qp_pdip_batch(H, g, lb, ub, iters: int, zl0=None, zu0=None):
    """(z, zl, zu) of B box QPs: H (B, nz, nz) read as given (not
    symmetrised), g, lb, ub and the optional previous duals (B, nz)."""
    if (zl0 is None) != (zu0 is None):
        raise ValueError("qp_kernel: give both warm-start duals or neither")
    if H.device.type == "cpu":
        return ipm_box_solve(H, g, lb, ub, iters, zl0, zu0)
    return _launch(H, g, lb, ub, iters, zl0, zu0)


solve_box_qp_pdip_batch.launches = 0
