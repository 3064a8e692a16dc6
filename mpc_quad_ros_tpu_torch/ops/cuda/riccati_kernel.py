"""Kernel C: the Riccati-factorised box-constrained interior point of the
long-horizon OCP, fed with kernel A's J.

Replaces ``mpc_quad_ros_tpu/ops/pallas/riccati_kernel.py::
_riccati_ipm_kernel``; the CUDA source is ``csrc/riccati_ipm.cu`` (one warp
per scenario, J streamed through shared memory a stage ahead, K and kff in a
device scratch; bounded by the serial backward sweep — see the source's
header).

Inputs: J (B, N, 17, 13) (row j of stage k = column j of [A_k | B_k]), the
defects c (B, N, 13), dx0 (B, 13), qlin (B, N, 13), rlin (B, N, 4),
plin (B, 13), lb / ub (B, N, 4); q, p_term (13) and rdiag (4) weight floats;
`iters` IPM iterations.  Returns dU (B, N, 4) and dX (B, N+1, 13), the affine
rollout of dU with the defects.

``riccati_ipm_from_J`` runs the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (f32, contiguous, sm_90), raising on
anything else.
"""

from __future__ import annotations

import torch

from . import _build
from .qp_kernel import step_length

NX, NU, NT = 13, 4, 17


def affine_rollout(J, c, dx0, du):
    """dX_0 = dx0, dX_{k+1} = c_k + A_k dX_k + B_k du_k."""
    dx, dXs = dx0, [dx0]
    for k in range(J.shape[1]):
        dx = c[:, k] + (J[:, k].mT @ torch.cat([dx, du[:, k]], -1)[..., None])[..., 0]
        dXs.append(dx)
    return torch.stack(dXs, 1)


def _chol_solve(G, RHS):
    """Solve G Z = RHS for (B, 4, 4) G and (B, 4, m) RHS by a left-looking
    Cholesky with pivots sqrt(max(., 1e-12)), as the kernels do."""
    L = [[None] * NU for _ in range(NU)]
    dg = [None] * NU
    for jc in range(NU):
        col = {i: G[:, i, jc] for i in range(jc, NU)}
        for kk in range(jc):
            col = {i: v - L[i][kk] * L[jc][kk] for i, v in col.items()}
        dg[jc] = torch.sqrt(torch.clamp_min(col[jc], 1e-12))
        for i in range(jc + 1, NU):
            L[i][jc] = col[i] / dg[jc]
    y = [None] * NU
    for jc in range(NU):
        v = RHS[:, jc]
        for kk in range(jc):
            v = v - L[jc][kk][:, None] * y[kk]
        y[jc] = v / dg[jc][:, None]
    z = [None] * NU
    for jc in range(NU - 1, -1, -1):
        v = y[jc]
        for kk in range(jc + 1, NU):
            v = v - L[kk][jc][:, None] * z[kk]
        z[jc] = v / dg[jc][:, None]
    return torch.stack(z, 1)


def solve_ocp_box_riccati_ipm_plain(J, c, dx0, qlin, rlin, plin, lb, ub, q, p_term, rdiag,
                                    iters: int):
    """The Pallas kernel's algorithm on (B, ...) tensors: per iteration the
    rollout, a backward sweep that contracts over J's columns (G, A^T P A and
    S^T K symmetrised as 0.5 (X + X^T), [K | kff] solved jointly by the
    floored 4x4 Cholesky), the forward Newton pass and the damped update."""
    B, N = J.shape[:2]
    kw = dict(dtype=J.dtype, device=J.device)
    qv, pv_, rv = (torch.tensor(w, **kw) for w in (q, p_term, rdiag))
    Qm, Pt = torch.diag(qv), torch.diag(pv_)
    eps = 1e-10 * torch.clamp_min(ub - lb, 1.0)

    du = 0.5 * (lb + ub)
    zl = torch.ones_like(du)
    zu = torch.ones_like(du)
    sl = du - lb
    su = ub - du
    for _ in range(iters):
        gap = ((sl * zl).sum((1, 2)) + (su * zu).sum((1, 2))) / (2 * N * NU)
        mu = (0.1 * gap)[:, None, None]
        dX = affine_rollout(J, c, dx0, du)
        dbar = zl / sl + zu / su
        rhat = rv * du + rlin - zl + zu - (mu - sl * zl) / sl + (mu - su * zu) / su

        P = Pt.expand(B, NX, NX)
        p = pv_ * dX[:, N] + plin
        Ks, kffs = [None] * N, [None] * N
        for k in range(N - 1, -1, -1):
            At, Bt = J[:, k, :NX], J[:, k, NX:]           # A^T (B, 13, 13), B^T (B, 4, 13)
            Wt, Vt = At @ P, Bt @ P
            G = Bt @ Vt.mT
            G = 0.5 * (G + G.mT) + torch.diag_embed(rv + dbar[:, k])
            S = Bt @ Wt.mT
            rhs2 = rhat[:, k] + (Bt @ p[..., None])[..., 0]
            Z = _chol_solve(G, torch.cat([S, rhs2[..., None]], -1))
            Ks[k], kffs[k] = K, kff = Z[..., :NX], Z[..., NX]
            T = At @ Wt.mT
            U2 = S.mT @ K
            P = Qm + 0.5 * (T + T.mT) - 0.5 * (U2 + U2.mT)
            p = (qv * dX[:, k] + qlin[:, k] + (At @ p[..., None])[..., 0]
                 - (K.mT @ rhs2[..., None])[..., 0])

        ddx = torch.zeros_like(dx0)
        ddus = []
        for k in range(N):
            dd = -kffs[k] - (Ks[k] @ ddx[..., None])[..., 0]
            ddus.append(dd)
            ddx = (J[:, k].mT @ torch.cat([ddx, dd], -1)[..., None])[..., 0]
        ddu = torch.stack(ddus, 1)

        dzl = (mu - sl * zl - zl * ddu) / sl
        dzu = (mu - su * zu + zu * ddu) / su
        alpha = step_length(*(a.flatten(1) for a in (sl, su, zl, zu, ddu, dzl, dzu)))[:, None, None]
        du = du + alpha * ddu
        sl = torch.maximum(du - lb, eps)
        su = torch.maximum(ub - du, eps)
        zl = torch.clamp_min(zl + alpha * dzl, 1e-12)
        zu = torch.clamp_min(zu + alpha * dzu, 1e-12)
    du = torch.minimum(torch.maximum(du, lb), ub)
    return du, affine_rollout(J, c, dx0, du)


def _launch(J, c, dx0, qlin, rlin, plin, lb, ub, q, p_term, rdiag, iters):
    B, N = J.shape[:2]
    tensors = dict(J=J, c=c, dx0=dx0, qlin=qlin, rlin=rlin, plin=plin, lb=lb, ub=ub)
    shapes = dict(J=(B, N, NT, NX), c=(B, N, NX), dx0=(B, NX), qlin=(B, N, NX),
                  rlin=(B, N, NU), plin=(B, NX), lb=(B, N, NU), ub=(B, N, NU))
    _build.check_cuda_inputs("riccati_kernel", tensors, shapes)
    if len(q) != NX or len(p_term) != NX or len(rdiag) != NU:
        raise ValueError("riccati_kernel: q, p_term need 13 weights and rdiag 4")
    lib = _build.load_library()
    need = lib.mpcq_riccati_ws_bytes(N)
    limit = torch.cuda.get_device_properties(J.device).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(f"riccati_kernel: N={N} needs {need} bytes of shared memory per "
                         f"block, the device allows {limit}")
    weights = _build.host_floats(list(q) + list(p_term) + list(rdiag))
    du = torch.empty((B, N, NU), dtype=J.dtype, device=J.device)
    dX = torch.empty((B, N + 1, NX), dtype=J.dtype, device=J.device)
    scratch = torch.empty((B, lib.mpcq_riccati_scratch_bytes(N) // 4), dtype=J.dtype,
                          device=J.device)
    rc = lib.mpcq_riccati_ipm(*(t.data_ptr() for t in tensors.values()), weights.data_ptr(),
                              du.data_ptr(), dX.data_ptr(), scratch.data_ptr(), B, N,
                              int(iters), torch.cuda.current_stream(J.device).cuda_stream)
    riccati_ipm_from_J.launches += 1
    _build.check_status("riccati_kernel", rc)
    return du, dX


def riccati_ipm_from_J(J, c, dx0, qlin, rlin, plin, lb, ub, q, p_term, rdiag, iters: int):
    """(dU, dX) of the box-constrained OCP."""
    if J.device.type == "cpu":
        return solve_ocp_box_riccati_ipm_plain(J, c, dx0, qlin, rlin, plin, lb, ub,
                                               q, p_term, rdiag, iters)
    return _launch(J, c, dx0, qlin, rlin, plin, lb, ub, q, p_term, rdiag, iters)


riccati_ipm_from_J.launches = 0
