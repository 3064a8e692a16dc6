"""Plain PyTorch condensing from the linearisation J — the algebra of
``csrc/condense.cuh`` (kernels B, D and F) and of kernel B's dX expansion,
batched over scenarios.  Counterpart of
``mpc_quad_ros_tpu/ops/pallas/condense_common.py`` and the condensing /
expansion loops of ``_fused_from_J_kernel`` and ``_condense_kernel_J``.

J (B, N, 17, 13): row j of stage k is column j of [A_k | B_k].
"""

from __future__ import annotations

import torch

NX, NU, NT = 13, 4, 17


def check_weights(name: str, q, p, rw) -> None:
    """The kernels' weights: q, p 13 floats each, rw 4."""
    if len(q) != NX or len(p) != NX or len(rw) != NU:
        raise ValueError(f"{name}: q, p need 13 weights and rw 4")


def _AB(J: torch.Tensor):
    """A (B, N, 13, 13) and B (B, N, 13, 4) from the tangent rows."""
    return J[:, :, :NX, :].mT, J[:, :, NX:, :].mT


def condense_from_J(J, r, dx0, ex0, q, p, rw, with_maps: bool = False):
    """The condensed Gauss-Newton Hessian and gradient (before + gu):
    d_{k+1} = A_k d_k + r_k, M_{k+1} = A_k M_k + B_k E_k;
    H = sum_k M_k' diag(w_k) M_k + kron(I_N, diag(rw)),
    g = sum_k M_k' diag(w_k) (ex0_k + d_k), with w_k = q for k < N and p at
    k = N.  H is formed on its lower triangle and mirrored, never averaged.
    q, p (13,), rw (4,): sequences of floats.  Returns (H, g), or with
    `with_maps` (H, g, M (B, N+1, 13, nz), d (B, N+1, 13)): every condensing
    map and drift, M_0 = 0 and d_0 = dx0 included."""
    B, N = J.shape[:2]
    nz = N * NU
    kw = dict(dtype=J.dtype, device=J.device)
    qv, pv = torch.tensor(q, **kw), torch.tensor(p, **kw)
    A, Bm = _AB(J)
    M = torch.zeros((B, NX, nz), **kw)
    d = dx0
    Ms, ds = [M], [d]
    H = torch.zeros((B, nz, nz), **kw)
    g = torch.zeros((B, nz), **kw)
    for k in range(N + 1):
        if k > 0:
            WM = (qv if k < N else pv)[:, None] * M
            H = H + M.mT @ WM
            g = g + (WM * (ex0[:, k] + d)[..., None]).sum(-2)
        if k == N:
            break
        M_next = A[:, k] @ M
        M_next[:, :, k * NU:(k + 1) * NU] = Bm[:, k]
        d = (A[:, k] @ d[..., None])[..., 0] + r[:, k]
        M = M_next
        if with_maps:
            Ms.append(M)
            ds.append(d)
    H = torch.tril(H) + torch.tril(H, -1).mT
    H.diagonal(dim1=-2, dim2=-1).add_(torch.tensor(rw, **kw).repeat(N))
    if with_maps:
        return H, g, torch.stack(Ms, 1), torch.stack(ds, 1)
    return H, g


def expand_dX(J, r, dx0, z):
    """dX_0 = dx0, dX_{k+1} = r_k + A_k dX_k + B_k z_k -> (B, N+1, 13)."""
    A, Bm = _AB(J)
    N = J.shape[1]
    zk = z.reshape(z.shape[0], N, NU)
    dX = [dx0]
    for k in range(N):
        dX.append(r[:, k] + (A[:, k] @ dX[-1][..., None])[..., 0]
                  + (Bm[:, k] @ zk[:, k, :, None])[..., 0])
    return torch.stack(dX, dim=1)
