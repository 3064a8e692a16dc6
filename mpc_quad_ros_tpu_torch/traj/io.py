"""Sampled-trajectory CSV files and the 13-state expansion.  Counterpart of
``mpc_quad_ros_tpu/traj/io.py``: columns `t,x,y,z,vx,vy,vz,ax,ay,az`, `%.6f`,
a `#`-prefixed header, so files of either package read in the other."""

from __future__ import annotations

import numpy as np

HEADER = "t,x,y,z,vx,vy,vz,ax,ay,az"


def save_sampled_csv(path: str, t, pos, vel, acc) -> None:
    data = np.concatenate(
        [np.asarray(t).reshape(-1, 1), np.asarray(pos), np.asarray(vel), np.asarray(acc)], axis=1)
    np.savetxt(path, data, fmt="%.6f", delimiter=",", header=HEADER)


def load_sampled_csv(path: str):
    """A sampled CSV as (x_traj (T, 13), t (T,)), with identity attitude and
    zero body rates."""
    data = np.genfromtxt(path, delimiter=",")
    return states_from_flat_outputs(data[:, 1:4], data[:, 4:7]), data[:, 0]


def states_from_flat_outputs(pos, vel) -> np.ndarray:
    """(T, 3) pos + (T, 3) vel -> (T, 13) reference states with identity
    attitude and zero body rates."""
    pos = np.asarray(pos)
    vel = np.asarray(vel)
    T = pos.shape[0]
    q = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (T, 1))
    return np.concatenate([pos, q, vel, np.zeros((T, 3))], axis=1)
