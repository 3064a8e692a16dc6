"""Kernels B and F: the Gauss-Newton step per scenario — condensing, box-QP
interior point (cold or warm-started), KKT residual and dX expansion; kernel
F linearises the scenario first, in the same block.

Kernel B replaces ``mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py::
_fused_from_J_kernel`` (the "hybrid" pipeline; IPM core:
``ops/pallas/qp_kernel.py::ipm_box_solve``); kernel F replaces
``_fused_kernel`` of the same file and its entry ``make_fused_sqp_step`` (the
"fused" pipeline).  The CUDA source of both is ``csrc/sqp_fused_kernel.cu``
with ``csrc/condense.cuh``, ``csrc/ipm_box.cuh`` and, for F,
``csrc/model.cuh`` (one warp per scenario, everything in shared memory;
bounded by the serial Cholesky latency per scenario — see the source's
header).

Kernel B's inputs: J (B, N, 17, 13), r (B, N, 13), dx0 (B, 13), ex0
(B, N+1, 13), gu / lb / ub (B, nz); q, p (13) and rw (4) weight floats;
`iters` IPM iterations; `duals` = (zl0, zu0), each (B, nz), for the warm
start, or None.  Kernel F takes X (B, N+1, 13), U (B, N, 4), the folded drag
and the model in place of J and r.  Both return z (B, nz), dX (B, N+1, 13),
kkt (B,), zl, zu (B, nz): the duals after the solve, unscaled, on both
starts.

``fused_sqp_from_J`` and ``fused_sqp_step`` run their plain PyTorch versions
for CPU tensors and launch the kernels for CUDA tensors (f32, contiguous,
sm_90), raising on anything else.  A horizon whose workspace passes the
device's shared memory per block (N > 30 on an H100) raises ``ValueError``
before the launch.
"""

from __future__ import annotations

import torch

from ..qp import qp_kkt_residual
from . import _build
from .condense_common import NT, NU, NX, check_weights, condense_from_J, expand_dX
from .lin_kernel import linearize_plain, model_constants
from .qp_kernel import check_smem, ipm_box_solve


def fused_sqp_from_J_plain(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters: int, duals=None):
    H, g = condense_from_J(J, r, dx0, ex0, q, p, rw)
    g = g + gu
    z, zl, zu = ipm_box_solve(H, g, lb, ub, iters, *(duals or (None, None)))
    return z, expand_dX(J, r, dx0, z), qp_kkt_residual(H, g, lb, ub, z), zl, zu


def _outputs(B, N, like):
    kw = dict(dtype=like.dtype, device=like.device)
    nz = N * NU
    return (torch.empty((B, nz), **kw), torch.empty((B, N + 1, NX), **kw),
            torch.empty((B,), **kw), torch.empty((B, nz), **kw), torch.empty((B, nz), **kw))


def _dual_ptrs(duals):
    return [duals[0].data_ptr(), duals[1].data_ptr()] if duals is not None else [None, None]


def _launch(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters, duals):
    B, N = J.shape[:2]
    nz = N * NU
    tensors = dict(J=J, r=r, dx0=dx0, ex0=ex0, gu=gu, lb=lb, ub=ub)
    shapes = dict(J=(B, N, NT, NX), r=(B, N, NX), dx0=(B, NX), ex0=(B, N + 1, NX),
                  gu=(B, nz), lb=(B, nz), ub=(B, nz), zl0=(B, nz), zu0=(B, nz))
    if duals is not None:
        tensors.update(zl0=duals[0], zu0=duals[1])
    _build.check_cuda_inputs("sqp_fused_kernel", tensors, shapes)
    check_weights("sqp_fused_kernel", q, p, rw)
    lib = _build.load_library()
    check_smem("sqp_fused_kernel", lib.mpcq_sqp_ws_bytes(N), J.device, f"N={N}")
    weights = _build.host_floats(list(q) + list(p) + list(rw))
    out = _outputs(B, N, J)
    rc = lib.mpcq_sqp_fused(*(t.data_ptr() for t in (J, r, dx0, ex0, gu, lb, ub)),
                            *_dual_ptrs(duals), weights.data_ptr(),
                            *(t.data_ptr() for t in out), B, N, int(iters),
                            torch.cuda.current_stream(J.device).cuda_stream)
    fused_sqp_from_J.launches += 1
    _build.check_status("sqp_fused_kernel", rc)
    return out


def fused_sqp_from_J(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters: int, duals=None):
    """Kernel B: (z, dX, kkt, zl, zu) of the step fed with J and r."""
    if J.device.type == "cpu":
        return fused_sqp_from_J_plain(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters, duals)
    return _launch(J, r, dx0, ex0, gu, lb, ub, q, p, rw, iters, duals)


fused_sqp_from_J.launches = 0


def fused_sqp_step_plain(X, U, dx0, ex0, gu, lb, ub, aug, f, dt, q, p, rw, iters: int,
                         duals=None):
    """Kernel A's plain version, then kernel B's, with r = x+ - X[1:]."""
    xp, J = linearize_plain(f, X, U, aug, dt)
    return fused_sqp_from_J_plain(J, xp - X[:, 1:], dx0, ex0, gu, lb, ub, q, p, rw, iters,
                                  duals)


def _launch_step(X, U, dx0, ex0, gu, lb, ub, aug, consts, q, p, rw, iters, duals):
    B, N1, _ = X.shape
    N = N1 - 1
    nz = N * NU
    tensors = dict(X=X, U=U, dx0=dx0, ex0=ex0, gu=gu, lb=lb, ub=ub)
    shapes = dict(X=(B, N + 1, NX), U=(B, N, NU), dx0=(B, NX), ex0=(B, N + 1, NX),
                  gu=(B, nz), lb=(B, nz), ub=(B, nz), zl0=(B, nz), zu0=(B, nz))
    nb = 0
    if aug is not None:
        nb = aug.X.shape[-1]
        tensors.update(Xb=aug.X, wb=aug.w, L=aug.L, sigma_f=aug.sigma_f)
        shapes.update(Xb=(B, 3, nb), wb=(B, 3, nb), L=(B, 3), sigma_f=(B, 3))
    if duals is not None:
        tensors.update(zl0=duals[0], zu0=duals[1])
    _build.check_cuda_inputs("sqp_step_kernel", tensors, shapes)
    check_weights("sqp_step_kernel", q, p, rw)
    lib = _build.load_library()
    check_smem("sqp_step_kernel", lib.mpcq_sqp_step_ws_bytes(N), X.device, f"N={N}")
    consts = _build.host_floats(consts)
    weights = _build.host_floats(list(q) + list(p) + list(rw))
    aug_ptrs = ([aug.X.data_ptr(), aug.w.data_ptr(), aug.L.data_ptr(), aug.sigma_f.data_ptr()]
                if aug is not None else [None] * 4)
    out = _outputs(B, N, X)
    rc = lib.mpcq_sqp_step(X.data_ptr(), U.data_ptr(), *aug_ptrs, nb,
                           *(t.data_ptr() for t in (dx0, ex0, gu, lb, ub)), *_dual_ptrs(duals),
                           consts.data_ptr(), weights.data_ptr(), *(t.data_ptr() for t in out),
                           B, N, int(iters), torch.cuda.current_stream(X.device).cuda_stream)
    fused_sqp_step.launches += 1
    _build.check_status("sqp_step_kernel", rc)
    return out


def fused_sqp_step(X, U, dx0, ex0, gu, lb, ub, aug, f, dt: float, q, p, rw, iters: int,
                   duals=None, consts: list[float] | None = None):
    """Kernel F: (z, dX, kkt, zl, zu) of the whole Gauss-Newton step along
    (X, U).  `aug` is the per-scenario ``FoldedDrag`` or None; `f` the MPC
    model (its ``params`` feed the kernel); `consts` =
    ``model_constants(f.params, dt)``, derived here when not given."""
    if X.device.type == "cpu":
        return fused_sqp_step_plain(X, U, dx0, ex0, gu, lb, ub, aug, f, dt, q, p, rw, iters,
                                    duals)
    if consts is None:
        consts = model_constants(f.params, dt)
    return _launch_step(X, U, dx0, ex0, gu, lb, ub, aug, consts, q, p, rw, iters, duals)


fused_sqp_step.launches = 0
