"""Kernel B: the J-fed Gauss-Newton step — condensing, box-QP interior point,
KKT residual and dX expansion.

Replaces ``mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py::
_fused_from_J_kernel`` (IPM core: ``ops/pallas/qp_kernel.py::ipm_box_solve``);
the CUDA sources are ``csrc/sqp_fused_kernel.cu`` and ``csrc/ipm_box.cuh``
(one warp per scenario, everything in shared memory; bounded by the serial
Cholesky latency per scenario — see the source's header).

Inputs: J (B, N, 17, 13), r (B, N, 13), dx0 (B, 13), ex0 (B, N+1, 13),
gu / lb / ub (B, nz); q, p (13) and rw (4) weight floats; `iters` IPM
iterations.  Returns z (B, nz), dX (B, N+1, 13), kkt (B,).

``fused_sqp_from_J`` runs the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (f32, contiguous, sm_90), raising on
anything else.  Only the cold-started IPM is ported: warm duals raise.  A
horizon whose workspace passes the device's shared memory per block (N > 30
on an H100) raises ``ValueError`` before the launch.
"""

from __future__ import annotations

import torch

from ..qp import qp_kkt_residual
from . import _build
from .condense_common import condense_from_J, expand_dX
from .qp_kernel import ipm_box_solve

NX, NU, NT = 13, 4, 17


def fused_sqp_from_J_plain(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters: int):
    H, g = condense_from_J(J, r, dx0, ex0, q, p, rw)
    g = g + gu
    z = ipm_box_solve(H, g, lb, ub, iters)
    return z, expand_dX(J, r, dx0, z), qp_kkt_residual(H, g, lb, ub, z)


def _launch(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters):
    B, N = J.shape[:2]
    nz = N * NU
    tensors = dict(J=J, r=r, dx0=dx0, ex0=ex0, gu=gu, lb=lb, ub=ub)
    shapes = dict(J=(B, N, NT, NX), r=(B, N, NX), dx0=(B, NX), ex0=(B, N + 1, NX),
                  gu=(B, nz), lb=(B, nz), ub=(B, nz))
    _build.check_cuda_inputs("sqp_fused_kernel", tensors, shapes)
    if len(q) != NX or len(p) != NX or len(rw) != NU:
        raise ValueError("sqp_fused_kernel: q, p need 13 weights and rw 4")
    lib = _build.load_library()
    need = lib.mpcq_sqp_ws_bytes(N)
    limit = torch.cuda.get_device_properties(J.device).shared_memory_per_block_optin
    if need > limit:
        from ..sqp import FUSED_N_MAX

        raise ValueError(
            f"sqp_fused_kernel: N={N} needs {need} bytes of shared memory per block, "
            f"the device allows {limit}; the condensed kernel takes N <= FUSED_N_MAX "
            f"= {FUSED_N_MAX} (use qp_method='riccati' or 'auto' past it)")
    weights = _build.host_floats(list(q) + list(p) + list(rw))
    z = torch.empty((B, nz), dtype=J.dtype, device=J.device)
    dX = torch.empty((B, N + 1, NX), dtype=J.dtype, device=J.device)
    kkt = torch.empty((B,), dtype=J.dtype, device=J.device)
    rc = lib.mpcq_sqp_fused(*(t.data_ptr() for t in tensors.values()), weights.data_ptr(),
                            z.data_ptr(), dX.data_ptr(), kkt.data_ptr(), B, N, int(iters),
                            torch.cuda.current_stream(J.device).cuda_stream)
    fused_sqp_from_J.launches += 1
    _build.check_status("sqp_fused_kernel", rc)
    return z, dX, kkt


def fused_sqp_from_J(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters: int, duals=None):
    if duals is not None:
        raise NotImplementedError("warm-started IPM duals are not ported yet")
    if J.device.type == "cpu":
        return fused_sqp_from_J_plain(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters)
    return _launch(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters)


fused_sqp_from_J.launches = 0
