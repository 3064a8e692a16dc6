"""Episode logging: tensors -> host pickles of numpy lists.

Counterpart of ``mpc_quad_ros_tpu/io/logger.py``: a dict-of-lists log with
the reference's key names, pickled by ``save_dict`` and read by
``load_dict``.  ``Logger.from_episode`` turns one episode's
``EpisodeOutput`` (leading (T,), on any device) into such a log; the values
are numpy arrays, so a log written by either package reads in the other.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np


def save_dict(dictionary: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(dictionary, f)


def load_dict(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


class Logger:
    """Dict-of-lists logger."""

    def __init__(self, filepath: Optional[str] = None):
        self.dictionary: dict = {}
        self.filepath = filepath

    def clear_memory(self) -> None:
        self.dictionary = {}

    def log(self, input_dict: dict) -> None:
        for key, val in input_dict.items():
            self.dictionary.setdefault(key, []).append(val)

    def save_log(self, filepath: Optional[str] = None) -> str:
        path = filepath or self.filepath
        if not path:
            raise ValueError("no filepath given")
        if not path.endswith(".pkl"):
            path = path + ".pkl"
        save_dict(self.dictionary, path)
        return path

    @classmethod
    def from_episode(cls, outs, t_odom=None, filepath: Optional[str] = None,
                     solve_time_s: Optional[float] = None,
                     t_cpu_kind: str = "amortized_episode_wall") -> "Logger":
        """A reference-keyed log of one episode's outputs (leading (T,)).

        t_cpu: a loop that runs the whole episode has no per-tick solve time,
        so `solve_time_s / T` is logged as a constant, and `t_cpu_kind` says
        what it is: "amortized_episode_wall" (this path), "per_tick_host_wall"
        (real per-tick times) or "chained_device_latency" (a bench-measured
        device number)."""
        lg = cls(filepath)
        T = outs.x_odom.shape[0]
        d = {k: list(_np(getattr(outs, k))) for k in
             ("x_odom", "x_pred_odom", "x_ref", "w_odom", "cost_solution", "kkt_residual")}
        if t_odom is not None:
            d["t_odom"] = list(_np(t_odom))
        if solve_time_s is not None:
            d["t_cpu"] = [solve_time_s / T] * T
            d["t_cpu_kind"] = t_cpu_kind
        if outs.rgp_mu_g_t is not None:
            mu = _np(outs.rgp_mu_g_t)
            d["rgp_mu_g_t"] = [list(mu[k]) for k in range(T)]
            d["v_body"] = list(_np(outs.v_body))
            d["a_drag"] = list(_np(outs.a_drag))
        # the full posterior in the reference's per-tick list-of-3-axes format
        if outs.rgp_basis_vectors is not None:
            bv = _np(outs.rgp_basis_vectors)               # (T, 3, nb)
            d["rgp_basis_vectors"] = [list(bv[k]) for k in range(T)]
        if outs.rgp_C_g_t is not None:
            cg = _np(outs.rgp_C_g_t)                       # (T, 3, nb, nb)
            d["rgp_C_g_t"] = [list(cg[k]) for k in range(T)]
        if outs.rgp_theta is not None:
            th = _np(outs.rgp_theta)                       # (T, 3, 3)
            d["rgp_theta"] = [[list(map(float, row)) for row in th[k]] for k in range(T)]
        lg.dictionary = d
        return lg
