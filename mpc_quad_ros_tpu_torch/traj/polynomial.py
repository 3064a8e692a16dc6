"""Piecewise polynomial trajectories with their differential-flatness
outputs, in numpy.  Counterpart of ``mpc_quad_ros_tpu/traj/polynomial.py``:
8-coefficient (7th-order) pieces in x, y, z and yaw with their durations,
evaluated over all query times at once (the piece by ``searchsorted``, then
Horner), the Mellinger-Kumar map to body rates, roll and pitch, time
stretching, and the 33-column CSV of the min-snap generator (duration, then
8 coefficients for each of x, y, z, yaw)."""

from __future__ import annotations

import numpy as np

GRAVITY = np.array([0.0, 0.0, 9.81])


def _deriv_coeffs(c: np.ndarray) -> np.ndarray:
    """Coefficient array of the derivative polynomial.  c: (..., K) ascending
    powers -> (..., K-1)."""
    K = c.shape[-1]
    return c[..., 1:] * np.arange(1, K)


def _horner(c: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Evaluate polynomials c (..., K) at times t (...,) — broadcasted Horner."""
    out = np.zeros(np.broadcast_shapes(c.shape[:-1], t.shape))
    for k in range(c.shape[-1] - 1, -1, -1):
        out = out * t + c[..., k]
    return out


class PiecewisePolynomial4D:
    """Piecewise polynomial in (x, y, z, yaw).

    coeffs: (n_pieces, 4, K) ascending-power coefficients (K = 8 for the
    min-snap output), durations: (n_pieces,).
    """

    def __init__(self, durations: np.ndarray, coeffs: np.ndarray):
        self.durations = np.asarray(durations, dtype=float)
        self.coeffs = np.asarray(coeffs, dtype=float)
        assert self.coeffs.ndim == 3 and self.coeffs.shape[1] == 4

    @property
    def duration(self) -> float:
        return float(self.durations.sum())

    # ------------------------- CSV interop ------------------------- #
    @classmethod
    def loadcsv(cls, path: str) -> "PiecewisePolynomial4D":
        """genTrajectory CSV: duration, x^0..x^7, y^0..y^7, z^0..z^7, yaw^0..yaw^7
        (`uav_trajectory.py:116-119`)."""
        data = np.loadtxt(path, delimiter=",", skiprows=1, usecols=range(33), ndmin=2)
        return cls(data[:, 0], data[:, 1:33].reshape(-1, 4, 8))

    def savecsv(self, path: str) -> None:
        data = np.concatenate(
            [self.durations[:, None], self.coeffs.reshape(len(self.durations), -1)], axis=1
        )
        header = "duration," + ",".join(f"{ax}^{i}" for ax in ("x", "y", "z", "yaw") for i in range(8))
        np.savetxt(path, data, fmt="%.6f", delimiter=",", header=header)

    def stretchtime(self, factor: float) -> "PiecewisePolynomial4D":
        """Uniform time dilation (`uav_trajectory.py:14-18, 133-136`):
        t -> t*factor scales coefficient k by factor^-k."""
        K = self.coeffs.shape[-1]
        scale = (1.0 / factor) ** np.arange(K)
        return PiecewisePolynomial4D(self.durations * factor, self.coeffs * scale)

    # ------------------------- evaluation ------------------------- #
    def _piece_index(self, t: np.ndarray):
        edges = np.concatenate([[0.0], np.cumsum(self.durations)])
        idx = np.clip(np.searchsorted(edges, t, side="right") - 1, 0, len(self.durations) - 1)
        return idx, t - edges[idx]

    def eval_flat(self, t) -> dict:
        """Flat outputs at times t (scalar or (T,)): pos/vel/acc/jerk (T,3),
        yaw, dyaw (T,).  Pure polynomial derivatives."""
        t = np.atleast_1d(np.asarray(t, dtype=float))
        idx, tau = self._piece_index(t)
        c = self.coeffs[idx]               # (T, 4, 8)
        c1 = _deriv_coeffs(c)
        c2 = _deriv_coeffs(c1)
        c3 = _deriv_coeffs(c2)
        val = _horner(c, tau[:, None])     # (T, 4)
        vel = _horner(c1, tau[:, None])
        acc = _horner(c2, tau[:, None])
        jerk = _horner(c3, tau[:, None])
        return {
            "pos": val[:, :3], "yaw": val[:, 3],
            "vel": vel[:, :3], "dyaw": vel[:, 3],
            "acc": acc[:, :3], "jerk": jerk[:, :3],
        }

    def eval(self, t) -> dict:
        """Full differential-flatness outputs (Mellinger-Kumar, ICRA 2011 —
        the map implemented at `uav_trajectory.py:73-108`): adds body rates
        omega and the required roll/pitch angles."""
        f = self.eval_flat(t)
        acc, jerk, yaw, dyaw = f["acc"], f["jerk"], f["yaw"], f["dyaw"]

        thrust = acc + GRAVITY
        z_body = thrust / np.linalg.norm(thrust, axis=-1, keepdims=True)
        x_world = np.stack([np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)], axis=-1)
        y_body = np.cross(z_body, x_world)
        y_body /= np.linalg.norm(y_body, axis=-1, keepdims=True)
        x_body = np.cross(y_body, z_body)

        jerk_orth = jerk - np.sum(jerk * z_body, axis=-1, keepdims=True) * z_body
        h_w = jerk_orth / np.linalg.norm(thrust, axis=-1, keepdims=True)

        omega = np.stack(
            [
                -np.sum(h_w * y_body, axis=-1),
                np.sum(h_w * x_body, axis=-1),
                z_body[:, 2] * dyaw,
            ],
            axis=-1,
        )
        f["omega"] = omega
        f["pitch"] = np.arcsin(np.clip(-x_body[:, 2], -1, 1))
        f["roll"] = np.arctan2(y_body[:, 2], z_body[:, 2])
        return f


def sample_polynomial_trajectory(poly: PiecewisePolynomial4D, dt: float):
    """Sample at fixed dt like `TrajectoryGenerator.save_evals_csv`
    (`TrajectoryGenerator.py:208-220`): returns (t, pos, vel, acc)."""
    ts = np.arange(0.0, poly.duration, dt)
    f = poly.eval_flat(ts)
    return ts, f["pos"], f["vel"], f["acc"]
