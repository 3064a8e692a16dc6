"""Run configuration.  Counterpart of ``mpc_quad_ros_tpu/io/config.py``:
one dataclass for the simulation CLI's flags, the controller node's
launch parameters and the comparison matrix's JSON."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class SimConfig:
    # --- execute_trajectory flags (`execute_trajectory.py:66-75`) ---
    gpe: int = 0                  # 0 = nominal, 1 = pretrained GP, 2 = online RGP
    trajectory: int = 2           # 0 = static/file waypoints, 1 = random waypoints, 2 = circle
    v_max: float = 10.0
    a_max: float = 10.0
    output: Optional[str] = None
    plot_output: Optional[str] = None
    show: bool = False

    # --- operating point (`execute_trajectory.py:79,118-123`) ---
    t_lookahead: float = 1.0
    n_nodes: int = 10
    simulation_dt: float = 5e-3
    n_basis: int = 10
    rgp_theta: tuple = (3.0, 0.1, 0.01)

    # --- ROS-launch-style extras (`mpc_controller_node.py:75-87`) ---
    quad: str = "hummingbird"     # hummingbird | default | crazyflie
    payload: bool = False
    gp_from_file: bool = False
    gp_path: Optional[str] = None
    training: bool = False
    training_trajectories_count: int = 1
    explore: bool = False

    # --- limits (`execute_trajectory.py:77-94`) ---
    V_MAX_LIM: float = 30.0
    A_MAX_LIM: float = 30.0

    # --- randomisation / batching (new capability) ---
    batch: int = 1
    seed: int = 0

    def clamp_limits(self) -> "SimConfig":
        v = min(self.v_max, self.V_MAX_LIM)
        a = min(self.a_max, self.A_MAX_LIM)
        return dataclasses.replace(self, v_max=v, a_max=a)

    @classmethod
    def from_json(cls, path: str) -> list["SimConfig"]:
        """Load a comparison-matrix JSON into run configs.  The format is the
        reference's `config/comparisson_config.json`: {"runs": [{"gpe",
        "trajectory", "v_max", "a_max"}, ...]} (`compare_trajectories.py:14-36`)."""
        with open(path) as f:
            spec = json.load(f)
        return [
            cls(gpe=int(r["gpe"]), trajectory=int(r["trajectory"]),
                v_max=float(r["v_max"]), a_max=float(r["a_max"]))
            for r in spec["runs"]
        ]
