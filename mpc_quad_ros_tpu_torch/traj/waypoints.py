"""Waypoints for min-snap trajectories.  Counterpart of
``mpc_quad_ros_tpu/traj/waypoints.py``, drawn from the same numpy stream, so
one `seed` gives the same waypoints in both packages."""

from __future__ import annotations

import numpy as np


def random_waypoints(hsize=10.0, num_waypoints: int = 10, start_point=(0.0, 0.0, 0.0),
                     hover_first: bool = False, seed: int | None = 0) -> np.ndarray:
    """(num_waypoints + 1 [+ 1], 3) waypoints from start_point: uniform in a
    box of half-size `hsize` (a number or 3 of them) centred 1.5 hsize_z
    above the ground, after a hover point at hsize_z with `hover_first`."""
    if not isinstance(hsize, (list, tuple, np.ndarray)):
        hsize = [hsize, hsize, hsize]
    hsize = np.asarray(hsize, dtype=float)
    center = np.array([0.0, 0.0, 1.5 * hsize[2]])
    rng = np.random.default_rng(seed)
    pts = [np.asarray(start_point, dtype=float)]
    if hover_first:
        pts.append(np.array([0.0, 0.0, hsize[2]]))
    for _ in range(num_waypoints):
        pts.append(rng.uniform(-hsize, hsize) + center)
    return np.stack(pts)


def line_waypoints(start, end) -> np.ndarray:
    """The two-point line: the controller's hover-bootstrap trajectory."""
    return np.stack([np.asarray(start, dtype=float), np.asarray(end, dtype=float)])
