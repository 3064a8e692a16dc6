"""Post-hoc analysis of episode logs: the metric half of ``Visualiser``.

Counterpart of ``mpc_quad_ros_tpu/io/viz.py``'s ``Visualiser.__init__``,
``from_logger``, ``from_file``, ``rms_errors`` and
``velocity_error_covariance`` (the paper's learning metric), in numpy on the
host.  The plots and animations are not ported yet.
"""

from __future__ import annotations

import numpy as np


def _ragged(v) -> bool:
    """Whether v has no rectangular numpy form."""
    try:
        return np.asarray(v).dtype == object
    except ValueError:
        return True


class Visualiser:
    def __init__(self, data: dict):
        """data: a log dict under the reference's keys (x_odom, x_ref, ...);
        rectangular values become numpy arrays, the rest stay as given."""
        self.d = {k: np.asarray(v) for k, v in data.items() if v is not None and not _ragged(v)}
        for k, v in data.items():
            if k not in self.d:
                self.d[k] = v

    @classmethod
    def from_logger(cls, logger) -> "Visualiser":
        return cls(logger.dictionary)

    @classmethod
    def from_file(cls, path: str) -> "Visualiser":
        from .logger import load_dict

        return cls(load_dict(path))

    def rms_errors(self) -> dict:
        """RMS position [mm], quaternion, velocity [mm/s] and body-rate
        tracking errors over the log."""
        e = self.d["x_odom"] - self.d["x_ref"]
        rms = lambda a: np.sqrt(np.mean(np.sum(a**2, axis=1)))
        return {"rms_pos_mm": 1e3 * rms(e[:, 0:3]), "rms_quat": rms(e[:, 3:7]),
                "rms_vel_mm_s": 1e3 * rms(e[:, 7:10]), "rms_rate": rms(e[:, 10:13])}

    def velocity_error_covariance(self) -> np.ndarray:
        """Per axis, cov(v_axis, position error_axis) over the log: the
        paper's learning metric (it shrinks as the drag is learned)."""
        x, r = self.d["x_odom"], self.d["x_ref"]
        return np.asarray([np.cov(np.stack([x[:, 7 + ax], x[:, ax] - r[:, ax]]))[0, 1]
                           for ax in range(3)])
