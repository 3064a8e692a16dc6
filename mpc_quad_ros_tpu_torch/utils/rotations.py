"""Quaternion / rotation algebra on tensors (wxyz, scalar first).

Counterpart of ``mpc_quad_ros_tpu/utils/rotations.py``; only what the MPC
solve, the closed loop and the plant use.  Every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def q_to_rot_mat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a (possibly non-unit) quaternion, the unnormalised
    quadratic form of the reference (no renormalisation).  q: (..., 4) ->
    (..., 3, 3)."""
    qw, qx, qy, qz = q.unbind(-1)
    rows = [
        [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx**2 + qy**2)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def v_dot_q(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate v (..., 3) by quaternion q (..., 4)."""
    return torch.einsum("...ij,...j->...i", q_to_rot_mat(q), v)


def quaternion_inverse(q: torch.Tensor) -> torch.Tensor:
    """Conjugate quaternion (the inverse of a unit quaternion)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_derivative(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """q̇ = ½ S(w) q in closed form; q (..., 4), body rates w (..., 3)."""
    qw, qx, qy, qz = q.unbind(-1)
    wx, wy, wz = w.unbind(-1)
    return 0.5 * torch.stack(
        [
            -wx * qx - wy * qy - wz * qz,
            wx * qw + wz * qy - wy * qz,
            wy * qw - wz * qx + wx * qz,
            wz * qw + wy * qx - wx * qy,
        ],
        dim=-1,
    )


def unit_quat(q: torch.Tensor) -> torch.Tensor:
    """q scaled to unit modulus."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
