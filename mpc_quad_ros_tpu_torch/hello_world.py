"""Takeoff, hover and land, flown by the MPC through the node seam.

Counterpart of ``mpc_quad_ros_tpu/hello_world.py``: a ControllerNode tracks
a min-snap line up to the hover height, then one back down, on the
crazyflie preset (N = 10, v_max and a_max 0.5), each phase flown by
``SimLoop``.  It runs on the card unless --cpu is given; the exit code is 0
when both phases end within 0.25 m of their targets.

    python -m mpc_quad_ros_tpu_torch.hello_world [--height 1.0] [--hover 2.5] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def line_node(p, x0: np.ndarray, start, end, device):
    """One phase's ControllerNode (N = 10, v_max and a_max 0.5), its line
    from `start` to `end` already received, at state `x0`."""
    from .node import ControllerNode, TrajectoryServer

    node = ControllerNode(p, TrajectoryServer(), v_max=0.5, a_max=0.5,
                          trajectory_type="line", n_nodes=10, device=device)
    node.need_trajectory_to_hover = False
    node.request_trajectory(x0, "line", start=start, end=end)
    return node


def hello_world(height: float = 1.0, hover_s: float = 2.5, land_z: float = 0.04,
                quad: str = "crazyflie", verbose: bool = True, device="cuda") -> dict:
    """{"takeoff": {"x_final", "error_m"}, "land": {...}}."""
    from .models.params import crazyflie_params, hummingbird_params
    from .node import SimLoop

    p = {"crazyflie": crazyflie_params, "hummingbird": hummingbird_params}[quad]()
    x0 = np.zeros(13)
    x0[3] = 1.0

    results = {}
    for phase, (start, end) in {
        "takeoff": (x0[:3], np.array([0.0, 0.0, height])),
        "land": (np.array([0.0, 0.0, height]), np.array([0.0, 0.0, land_z])),
    }.items():
        node = line_node(p, x0, start, end, device)
        loop = SimLoop(node, p, x0)
        x_final = loop.run(max_ticks=int(30.0 / node.odometry_dt))
        err = float(np.linalg.norm(x_final[:3] - end))
        results[phase] = {"x_final": x_final, "error_m": err}
        if verbose:
            print(f"{phase}: reached z={x_final[2]:.3f} m (target {end[2]:.2f}), "
                  f"pos error {err * 1e3:.0f} mm")
        if phase == "takeoff" and verbose:
            print(f"hover {hover_s}s @ {height} m")
        x0 = x_final
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--height", type=float, default=1.0)
    parser.add_argument("--hover", type=float, default=2.5)
    parser.add_argument("--quad", type=str, default="crazyflie",
                        choices=("crazyflie", "hummingbird"))
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain versions); the default is the card")
    args = parser.parse_args(argv)
    res = hello_world(args.height, args.hover, quad=args.quad,
                      device="cpu" if args.cpu else "cuda")
    ok = all(r["error_m"] < 0.25 for r in res.values())
    print("hello_world:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
