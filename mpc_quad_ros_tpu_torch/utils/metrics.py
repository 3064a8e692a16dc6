"""Trajectory-comparison metrics, in numpy on the host.

Counterpart of ``mpc_quad_ros_tpu/utils/metrics.py``: ``interpol_mse``,
``quaternion_state_mse``, ``euclidean_dist`` and ``separate_variables``,
post-hoc analysis of logged runs that no solve calls.
"""

from __future__ import annotations

import numpy as np


def interpol_mse(t_1, x_1, t_2, x_2, n_interp_samples: int = 1000) -> float:
    """Mean Euclidean error between two trajectories: on a shared time grid
    the mean row norm of the difference, else both cubic-interpolated onto
    `n_interp_samples` uniform times spanning the overlap."""
    t_1, x_1 = np.asarray(t_1), np.asarray(x_1)
    t_2, x_2 = np.asarray(t_2), np.asarray(x_2)
    if t_1.shape == t_2.shape and np.all(t_1 == t_2):
        return float(np.mean(np.linalg.norm(x_1 - x_2, axis=1)))
    if x_1.shape[1] != x_2.shape[1]:
        raise ValueError(f"state widths differ: {x_1.shape[1]} and {x_2.shape[1]}")
    t_interp = np.linspace(max(t_1[0], t_2[0]), min(t_1[-1], t_2[-1]), n_interp_samples)

    from scipy.interpolate import interp1d

    def resample(t, x):
        return np.stack([interp1d(t, x[:, d], kind="cubic")(t_interp) for d in range(x.shape[1])],
                        axis=1)

    return float(np.mean(np.linalg.norm(resample(t_1, x_1) - resample(t_2, x_2), axis=1)))


def quaternion_state_mse(x, x_ref, mask) -> float:
    """Weighted error norm of a 13-state against a reference state, the
    attitude error being the vector part of q ⊗ q_ref⁻¹; `mask` (12,)
    weighs (p_xyz, q_xyz, v_xyz, r_xyz)."""
    x, x_ref = np.asarray(x, dtype=float), np.asarray(x_ref, dtype=float)
    q, qr = x[3:7], x_ref[3:7]
    w1, v1 = q[0], q[1:4]
    w2, v2 = qr[0], -qr[1:4]
    q_err_vec = w1 * v2 + w2 * v1 + np.cross(v1, v2)
    e = np.concatenate((x[:3] - x_ref[:3], q_err_vec, x[7:10] - x_ref[7:10], x[10:] - x_ref[10:]))
    return float(np.sqrt(e @ (np.asarray(mask, dtype=float) * e)))


def euclidean_dist(x, y, thresh: float | None = None):
    """The distance between two points, or with `thresh` whether it is below
    it."""
    d = float(np.linalg.norm(np.asarray(x, dtype=float) - np.asarray(y, dtype=float)))
    return d if thresh is None else d < thresh


def separate_variables(traj):
    """An (N, 13) state trajectory as [pos (N, 3), quat (N, 4), vel (N, 3),
    rate (N, 3)]."""
    traj = np.asarray(traj)
    return [traj[:, :3], traj[:, 3:7], traj[:, 7:10], traj[:, 10:]]
