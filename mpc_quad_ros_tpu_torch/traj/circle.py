"""The accelerating circle reference, in numpy.  Counterpart of
``mpc_quad_ros_tpu/traj/circle.py::circle_trajectory_accelerating``."""

from __future__ import annotations

import numpy as np


def circle_trajectory_accelerating(radius, v_max, t_max=10.0, dt=0.01,
                                   start_point=(0.0, 0.0, 0.0)):
    """Sine-profiled 0 -> w_max -> 0 angular velocity on a circle through
    start_point: w_i = w_max (sin((k_i 2 pi + 3 pi / 2) / 2) + 1) / 2 with
    k_i = (i+1)/T * 2 - 1, phi_i = sum_{j<=i} w_j dt; acc is the centripetal
    term only.  Returns (t (T,), pos (T, 3), vel (T, 3), acc (T, 3))."""
    ts = np.arange(0.0, t_max, dt)
    n = ts.shape[0]
    w_max = v_max / radius
    k = (np.arange(1, n + 1) / n) * 2.0 - 1.0
    w = (np.sin((k * 2 * np.pi + np.pi * 3 / 2) * 0.5) + 1.0) / 2.0 * w_max
    phi = np.cumsum(w * dt)
    cos, sin = np.cos(phi), np.sin(phi)
    zeros = np.zeros_like(ts)
    offset = np.asarray(start_point) + np.asarray([-radius, 0.0, 0.0])
    pos = np.stack([radius * cos, radius * sin, zeros], axis=-1) + offset
    vel = np.stack([-radius * w * sin, radius * w * cos, zeros], axis=-1)
    acc = np.stack([-radius * w * w * cos, -radius * w * w * sin, zeros], axis=-1)
    return ts, pos, vel, acc
