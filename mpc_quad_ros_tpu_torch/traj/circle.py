"""Analytic circle references and the square, in numpy.  Counterpart of
``mpc_quad_ros_tpu/traj/circle.py``: the phase phi_i = sum_{j<=i} w_j dt is a
cumulative sum.  The circle samplers return (t (T,), pos (T, 3), vel (T, 3),
acc (T, 3)) on a circle of `radius` through `start_point`."""

from __future__ import annotations

import numpy as np


def _assemble(ts, w, phi, radius, start_point, acc=None):
    cos, sin = np.cos(phi), np.sin(phi)
    zeros = np.zeros_like(ts)
    offset = np.asarray(start_point) + np.asarray([-radius, 0.0, 0.0])
    pos = np.stack([radius * cos, radius * sin, zeros], axis=-1) + offset
    vel = np.stack([-radius * w * sin, radius * w * cos, zeros], axis=-1)
    return ts, pos, vel, np.zeros_like(pos) if acc is None else acc


def circle_trajectory_accelerating(radius, v_max, t_max=10.0, dt=0.01,
                                   start_point=(0.0, 0.0, 0.0)):
    """Sine-profiled 0 -> w_max -> 0 angular velocity:
    w_i = w_max (sin((k_i 2 pi + 3 pi / 2) / 2) + 1) / 2 with
    k_i = (i+1)/T * 2 - 1; acc is the centripetal term only."""
    ts = np.arange(0.0, t_max, dt)
    n = ts.shape[0]
    w_max = v_max / radius
    k = (np.arange(1, n + 1) / n) * 2.0 - 1.0
    w = (np.sin((k * 2 * np.pi + np.pi * 3 / 2) * 0.5) + 1.0) / 2.0 * w_max
    phi = np.cumsum(w * dt)
    cos, sin = np.cos(phi), np.sin(phi)
    acc = np.stack([-radius * w * w * cos, -radius * w * w * sin, np.zeros_like(w)], axis=-1)
    return _assemble(ts, w, phi, radius, start_point, acc)


def circle_trajectory_constant(radius, v_max, dt=0.01, start_point=(0.0, 0.0, 0.0)):
    """One loop at constant speed; zero logged acceleration."""
    w_max = v_max / radius
    ts = np.arange(0.0, float(2 * np.pi / w_max), dt)
    w = np.full_like(ts, w_max)
    return _assemble(ts, w, np.cumsum(w * dt), radius, start_point)


def circle_trajectory_acc_dec(radius, v_max, dt=0.01, start_point=(0.0, 0.0, 0.0)):
    """Accelerate to w_max at mid-time, then decelerate: angular
    acceleration ±w_max²/(2π), w and phi running sums."""
    w_max = v_max / radius
    acc_mag = w_max * w_max / 2.0 / np.pi
    t_mid = w_max / acc_mag
    ts = np.arange(0.0, float(2 * t_mid), dt)
    acc_w = np.where(ts < t_mid, acc_mag, -acc_mag)
    w = np.cumsum(acc_w * dt)
    phi = np.cumsum(w * dt)
    cos, sin = np.cos(phi), np.sin(phi)
    acc = np.stack([-radius * acc_w * cos, -radius * acc_w * sin, np.zeros_like(w)], axis=-1)
    return _assemble(ts, w, phi, radius, start_point, acc)


def square_trajectory(n: int = 10, dt: float = 0.1, v: float = 3.0) -> np.ndarray:
    """Six axis-aligned segments at speed `v` (hold, +x, +y, -x, -y, hold)
    as an (N, 13) state array with identity attitude and zero rates."""
    t_section = np.arange(0.0, n * dt / 6.0, dt)
    dirs = np.array([[0, 0, 0], [v, 0, 0], [0, v, 0], [-v, 0, 0], [0, -v, 0], [0, 0, 0]],
                    dtype=float)
    p0 = np.zeros(3)
    segs = []
    for d in dirs:
        seg = p0[None, :] + d[None, :] * t_section[:, None]
        segs.append(seg)
        p0 = seg[-1]
    p = np.concatenate(segs, axis=0)
    x = np.zeros((p.shape[0], 13))
    x[:, 3] = 1.0
    x[:, 0:3] = p
    x[:, 7:10] = dirs[-1]
    return x
