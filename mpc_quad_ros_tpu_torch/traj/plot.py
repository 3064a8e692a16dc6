"""Polynomial-trajectory inspection CLI.  Counterpart of
``mpc_quad_ros_tpu/traj/plot.py``: load a piecewise-polynomial CSV (the
min-snap generator's format), print its peak speed, acceleration, body rate,
roll and pitch, and plot the 3D path with the speed, acceleration, body-rate
and yaw series (matplotlib, imported only for the plot).

    python -m mpc_quad_ros_tpu_torch.traj.plot poly.csv [--stretchtime F] [-o out.png]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .polynomial import PiecewisePolynomial4D


def trajectory_stats(poly: PiecewisePolynomial4D, dt: float = 0.01) -> dict:
    ts = np.arange(0.0, poly.duration, dt)
    e = poly.eval(ts)
    return {
        "t": ts,
        "pos": e["pos"],
        "velocity": np.linalg.norm(e["vel"], axis=1),
        "acceleration": np.linalg.norm(e["acc"], axis=1),
        "omega": np.linalg.norm(e["omega"], axis=1),
        "yaw": e["yaw"],
        "roll": e["roll"],
        "pitch": e["pitch"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("trajectory", type=str, help="CSV file containing trajectory")
    parser.add_argument("--stretchtime", type=float, default=None,
                        help="stretch time factor (smaller means faster)")
    parser.add_argument("-o", "--output", type=str, default=None,
                        help="save the figure instead of showing it")
    args = parser.parse_args(argv)

    poly = PiecewisePolynomial4D.loadcsv(args.trajectory)
    if args.stretchtime:
        poly = poly.stretchtime(args.stretchtime)

    s = trajectory_stats(poly)
    print("max speed (m/s): ", float(np.max(s["velocity"])))
    print("max acceleration (m/s^2): ", float(np.max(s["acceleration"])))
    print("max omega (rad/s): ", float(np.max(s["omega"])))
    print("max roll (deg): ", float(np.max(np.degrees(s["roll"]))))
    print("max pitch (deg): ", float(np.max(np.degrees(s["pitch"]))))

    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    gs = gridspec.GridSpec(6, 1)
    fig = plt.figure(figsize=(8, 12))
    ax = plt.subplot(gs[0:2, 0], projection="3d")
    ax.plot(s["pos"][:, 0], s["pos"][:, 1], s["pos"][:, 2])
    for row, key, unit in ((2, "velocity", "m/s"), (3, "acceleration", "m/s^2"),
                           (4, "omega", "rad/s")):
        ax = plt.subplot(gs[row, 0])
        ax.plot(s["t"], s[key])
        ax.set_ylabel(f"{key} [{unit}]")
    ax = plt.subplot(gs[5, 0])
    ax.plot(s["t"], np.degrees(s["yaw"]))
    ax.set_ylabel("yaw [deg]")

    if args.output:
        fig.savefig(args.output, bbox_inches="tight")
        print(f"saved {args.output}")
    else:
        plt.show()
    plt.close(fig)
    return 0


if __name__ == "__main__":
    sys.exit(main())
