"""13-state quadrotor rigid-body dynamics on tensors.

Counterpart of ``mpc_quad_ros_tpu/models/dynamics.py``: x = [pos(3), quat
wxyz(4), vel(3), rate(3)], u in [0, 1]^4.  RK4 never renormalises the
quaternion (reference parity), and the payload term keeps the reference's
quirk: -(payload_mass / mass) * g added to v̇.  Parameters may carry a
leading batch axis matching x's.
"""

from __future__ import annotations

import torch

from ..utils.rotations import (q_to_rot_mat, quaternion_derivative, quaternion_inverse, unit_quat,
                               v_dot_q)
from .params import QuadParams


def a_drag_body(x: torch.Tensor, p: QuadParams) -> torch.Tensor:
    """Body-frame drag acceleration:
    -(aero_drag * v_b^2 * sign(v_b) + rotor_drag * v_b) / mass."""
    v_b = v_dot_q(x[..., 7:10], quaternion_inverse(x[..., 3:7]))
    quad_term = p.aero_drag[..., None] if p.aero_drag.dim() == x.dim() - 1 else p.aero_drag
    a = -quad_term * v_b**2 * torch.sign(v_b) / p.mass[..., None]
    return a - p.rotor_drag * v_b / p.mass[..., None]


def _f_core(x: torch.Tensor, u: torch.Tensor, p: QuadParams,
            a_extra_world: torch.Tensor) -> torch.Tensor:
    """Nominal rigid body plus an extra world-frame acceleration on v̇."""
    q = x[..., 3:7]
    v = x[..., 7:10]
    w = x[..., 10:13]

    f_thrust = u * p.rotor_functionality * p.max_thrust[..., None]   # (..., 4)
    thrust_sum = f_thrust.sum(-1)

    rot = q_to_rot_mat(q)
    a_thrust_world = rot[..., :, 2] * (thrust_sum / p.mass)[..., None]
    a_payload = -(p.payload_mass / p.mass)[..., None] * p.g
    dvel = -p.g + a_payload + a_thrust_world + a_extra_world

    J0, J1, J2 = p.J[..., 0], p.J[..., 1], p.J[..., 2]
    tx = (f_thrust * p.y_f).sum(-1)
    ty = -(f_thrust * p.x_f).sum(-1)
    tz = (f_thrust * p.z_l_tau).sum(-1)
    drate = torch.stack(
        [
            (tx + (J1 - J2) * w[..., 1] * w[..., 2]) / J0,
            (ty + (J2 - J0) * w[..., 2] * w[..., 0]) / J1,
            (tz + (J0 - J1) * w[..., 0] * w[..., 1]) / J2,
        ],
        dim=-1,
    )
    return torch.cat([v, quaternion_derivative(q, w), dvel, drate], dim=-1)


def f_nominal(x: torch.Tensor, u: torch.Tensor, p: QuadParams) -> torch.Tensor:
    """Drag-free dynamics — the MPC model without learned augmentation."""
    return _f_core(x, u, p, torch.zeros_like(x[..., 7:10]))


def f_with_drag(x: torch.Tensor, u: torch.Tensor, p: QuadParams) -> torch.Tensor:
    """Ground-truth plant dynamics with aero + rotor drag."""
    return _f_core(x, u, p, v_dot_q(a_drag_body(x, p), x[..., 3:7]))


def f_disturbed(x: torch.Tensor, u: torch.Tensor, p: QuadParams, f_d: torch.Tensor,
                t_d: torch.Tensor) -> torch.Tensor:
    """The drag plant with a body-frame force f_d and torque t_d (..., 3)."""
    a_d_world = v_dot_q(a_drag_body(x, p) + f_d / p.mass[..., None], x[..., 3:7])
    dx = _f_core(x, u, p, a_d_world)
    return torch.cat([dx[..., :10], dx[..., 10:13] + t_d / p.J], dim=-1)


def rk4_step(f, x: torch.Tensor, u: torch.Tensor, dt, normalize_quat: bool = False) -> torch.Tensor:
    """Classic RK4 under a held control.  The quaternion is not renormalised
    (reference parity) unless `normalize_quat`, for long free-running
    rollouts."""
    k1 = f(x, u)
    k2 = f(x + dt / 2 * k1, u)
    k3 = f(x + dt / 2 * k2, u)
    k4 = f(x + dt * k3, u)
    x_out = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    if normalize_quat:
        x_out = torch.cat([x_out[..., :3], unit_quat(x_out[..., 3:7]), x_out[..., 7:]], dim=-1)
    return x_out


def plant_step(x: torch.Tensor, u: torch.Tensor, p: QuadParams, dt) -> torch.Tensor:
    """One RK4 step of the drag plant under the control clipped to [0, 1]."""
    return rk4_step(lambda xx, uu: f_with_drag(xx, uu, p), x, u.clamp(0.0, 1.0), dt)


def plant_substeps(x: torch.Tensor, u: torch.Tensor, p: QuadParams, dt,
                   n_sub: int) -> torch.Tensor:
    """`n_sub` RK4 steps of the drag plant under the held control clipped to
    [0, 1] (20 x 5 ms per 100 ms MPC tick in the closed loop)."""
    u = u.clamp(0.0, 1.0)
    f = lambda xx, uu: f_with_drag(xx, uu, p)
    for _ in range(n_sub):
        x = rk4_step(f, x, u, dt)
    return x


def compute_a_drag_target(x_now: torch.Tensor, x_pred_prev: torch.Tensor,
                          dt) -> tuple[torch.Tensor, torch.Tensor]:
    """The online drag-learning label: (v_body(x_now),
    (v_body(x_now) - v_body(x_pred_prev)) / dt)."""
    v_body = v_dot_q(x_now[..., 7:10], quaternion_inverse(x_now[..., 3:7]))
    v_body_pred = v_dot_q(x_pred_prev[..., 7:10], quaternion_inverse(x_pred_prev[..., 3:7]))
    return v_body, (v_body - v_body_pred) / dt
