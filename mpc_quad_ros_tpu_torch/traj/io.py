"""13-state expansion of sampled flat outputs.  Counterpart of
``mpc_quad_ros_tpu/traj/io.py::states_from_flat_outputs``."""

from __future__ import annotations

import numpy as np


def states_from_flat_outputs(pos, vel) -> np.ndarray:
    """(T, 3) pos + (T, 3) vel -> (T, 13) reference states with identity
    attitude and zero body rates."""
    pos = np.asarray(pos)
    vel = np.asarray(vel)
    T = pos.shape[0]
    q = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (T, 1))
    return np.concatenate([pos, q, vel, np.zeros((T, 3))], axis=1)
