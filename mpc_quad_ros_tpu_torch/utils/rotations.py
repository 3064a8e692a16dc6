"""Quaternion / rotation algebra on tensors (wxyz, scalar first).

Counterpart of ``mpc_quad_ros_tpu/utils/rotations.py``: every function of
it.  Every function broadcasts over leading dims.
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


def q_dot_q(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product: quaternion q rotated by r."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack(
        [
            rw * qw - rx * qx - ry * qy - rz * qz,
            rw * qx + rx * qw - ry * qz + rz * qy,
            rw * qy + rx * qz + ry * qw - rz * qx,
            rw * qz - rx * qy + ry * qx + rz * qw,
        ],
        dim=-1,
    )


def skew_symmetric4(w: torch.Tensor) -> torch.Tensor:
    """The 4x4 quaternion-rate matrix S(w) with q̇ = ½ S(w) q; w (..., 3) ->
    (..., 4, 4)."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    rows = [[z, -wx, -wy, -wz], [wx, z, wz, -wy], [wy, -wz, z, wx], [wz, wy, -wx, z]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_to_quaternion(roll, pitch, yaw) -> torch.Tensor:
    """Roll, pitch, yaw [rad] (tensors of one shape) -> wxyz quaternion."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def quaternion_to_euler(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion (normalised first) -> (..., 3) roll, pitch, yaw."""
    qw, qx, qy, qz = q.unbind(-1)
    n = torch.sqrt(qw**2 + qx**2 + qy**2 + qz**2)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    roll = torch.atan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx**2 + qy**2))
    pitch = torch.asin(torch.clamp(2 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = torch.atan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy**2 + qz**2))
    return torch.stack([roll, pitch, yaw], dim=-1)


def undo_quaternion_flip(q_past: torch.Tensor, q_current: torch.Tensor) -> torch.Tensor:
    """q_current, negated where -q_current is the nearer to q_past."""
    d_same = ((q_past - q_current) ** 2).sum(-1, keepdim=True)
    d_flip = ((q_past + q_current) ** 2).sum(-1, keepdim=True)
    return torch.where(d_same > d_flip, -q_current, q_current)


def decompose_quaternion(q: torch.Tensor):
    """q split into its xy-tilt and z-yaw rotations: (qxy, qz)."""
    w, z = q[..., 0], q[..., 3]
    zero = torch.zeros_like(w)
    qz = unit_quat(torch.stack([w, zero, zero, z], dim=-1))
    return q_dot_q(q, quaternion_inverse(qz)), qz


def rotation_matrix_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix (..., 3, 3) -> unit wxyz quaternion, by the
    Shepperd construction: the four candidates, each from one pivot, and
    where each pivot's square is the largest, that candidate (masked
    ``torch.where``, no data-dependent branch)."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22
    squares = torch.stack([(1.0 + tr).clamp_min(0.0), (1.0 + m00 - m11 - m22).clamp_min(0.0),
                           (1.0 - m00 + m11 - m22).clamp_min(0.0),
                           (1.0 - m00 - m11 + m22).clamp_min(0.0)], dim=-1)
    pick = squares.argmax(-1)[..., None]
    # each candidate's divisor guarded, so the candidates not taken stay finite
    s = 2.0 * torch.sqrt(squares.clamp_min(1e-12))
    sw, sx, sy, sz = s.unbind(-1)
    cands = (
        torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1),
        torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1),
        torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], dim=-1),
        torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], dim=-1),
    )
    q = cands[3]
    for k in (2, 1, 0):
        q = torch.where(pick == k, cands[k], q)
    return unit_quat(q)


def rotation_matrix_to_euler(r_mat: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> (..., 3) roll, pitch, yaw."""
    return quaternion_to_euler(rotation_matrix_to_quat(r_mat))
