"""The run and figure scripts as one parameterised dispatcher.

Counterpart of ``mpc_quad_ros_tpu/scripts.py``, the same script matrix under
the same names (the reference's ``scripts/`` folder: ``run_traj{T}_gp{G}``,
``viz_plot_*``, ``viz_3dplot_*``, ``viz_anim_*``, ``viz_rgp_*``,
``viz_rgpanim_*``, ``viz_cov``):

    python -m mpc_quad_ros_tpu_torch.scripts run_traj0_gp2 [--v_max 10 --a_max 10]
    python -m mpc_quad_ros_tpu_torch.scripts viz_plot_python_traj0_gp2
    python -m mpc_quad_ros_tpu_torch.scripts viz_3dplot_python_traj1_gp0
    python -m mpc_quad_ros_tpu_torch.scripts viz_anim_python_gp2
    python -m mpc_quad_ros_tpu_torch.scripts viz_rgp_python
    python -m mpc_quad_ros_tpu_torch.scripts viz_cov
    python -m mpc_quad_ros_tpu_torch.scripts --list

A run writes ``$MPCQUAD_OUTPUTS/python_simulation/data/trajectory_v{V}_a{A}_gp{G}.pkl``
(``outputs`` by default) and its report beside it under ``img/``; it flies
on the card (``run.main``).  The figure scripts read those logs back,
or the one given by --data.  Exit codes: 0 done, 2 an unknown name or a
missing log.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

OUTPUT_ROOT = os.environ.get("MPCQUAD_OUTPUTS", "outputs")


def _data_path(env: str, traj: int, gpe: int, v: int, a: int) -> str:
    return os.path.join(OUTPUT_ROOT, f"{env}_simulation", "data",
                        f"trajectory_v{v}_a{a}_gp{gpe}.pkl")


def list_scripts():
    names = []
    for t in (0, 1, 2):
        for g in (0, 1, 2):
            names.append(f"run_traj{t}_gp{g}")
            for env in ("python", "gazebo"):
                names.append(f"viz_plot_{env}_traj{t}_gp{g}")
                names.append(f"viz_3dplot_{env}_traj{t}_gp{g}")
    for env in ("python", "gazebo"):
        for g in (0, 2):
            names.append(f"viz_anim_{env}_gp{g}")
        names.append(f"viz_rgp_{env}")
        names.append(f"viz_rgpanim_{env}")
    names.append("viz_cov")
    return names


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("name", nargs="?", help="script name, e.g. run_traj0_gp2")
    parser.add_argument("--list", action="store_true", help="list the script matrix")
    parser.add_argument("--v_max", type=int, default=10)
    parser.add_argument("--a_max", type=int, default=10)
    parser.add_argument("--data", type=str, default=None,
                        help="explicit log pickle for viz_* (overrides the convention)")
    parser.add_argument("--output", type=str, default=None,
                        help="figure/animation output path for viz_*")
    parser.add_argument("--show", type=int, default=0)
    args = parser.parse_args(argv)

    if args.list or not args.name:
        print("\n".join(list_scripts()))
        return 0

    v, a = args.v_max, args.a_max

    m = re.fullmatch(r"run_traj(\d)_gp(\d)", args.name)
    if m:
        t, g = int(m.group(1)), int(m.group(2))
        out = _data_path("python", t, g, v, a)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        from .run import main as run_main

        return run_main(["--gpe", str(g), "--trajectory", str(t), "--v_max", str(v),
                         "--a_max", str(a), "-o", out,
                         "-p", out.replace("/data/", "/img/").replace(".pkl", ".png"),
                         "--show", str(args.show)])

    m = re.fullmatch(r"viz_(plot|3dplot|anim|rgpanim|rgp)_(python|gazebo)(?:_traj(\d))?(?:_gp(\d))?",
                     args.name)
    if m:
        kind, env, t, g = m.group(1), m.group(2), m.group(3), m.group(4)
        g = int(g) if g is not None else 2
        data = args.data or _data_path(env, int(t) if t else 0, g, v, a)
        if not os.path.exists(data):
            print(f"log not found: {data} (run `run_traj{t or 0}_gp{g}` first, "
                  f"or pass --data)", file=sys.stderr)
            return 2
        from .io.viz import Visualiser

        viz = Visualiser.from_file(data)
        out = args.output
        if kind == "plot":
            p = viz.plot_data(save_path=out or data.replace(".pkl", "_report.png"),
                              show=bool(args.show))
        elif kind == "3dplot":
            p = viz.plot_3d(save_path=out or data.replace(".pkl", "_3d.png"),
                            show=bool(args.show))
        elif kind == "anim":
            p = viz.create_animation(out or data.replace(".pkl", ".gif"))
        elif kind == "rgpanim":
            # the combined flight and posterior layout
            p = viz.create_rgp_full_animation(
                out or data.replace(".pkl", "_rgp_full.gif"))
        else:  # rgp
            p = viz.plot_rgp_evolution(save_path=out or data.replace(".pkl", "_rgp.png"),
                                       show=bool(args.show))
        print(f"saved {p}")
        return 0

    if args.name == "viz_cov":
        # cov(v, e) compared across every log found
        import glob

        from .io.viz import Visualiser

        logs = {}
        for path in sorted(glob.glob(os.path.join(OUTPUT_ROOT, "*", "data", "*.pkl"))):
            try:
                logs[os.path.basename(path)] = Visualiser.from_file(path)
            except Exception as e:  # skip non-log pickles
                print(f"skipping {path}: {e}", file=sys.stderr)
        if not logs:
            print("no logs found", file=sys.stderr)
            return 2
        out = args.output or os.path.join(OUTPUT_ROOT, "covariance_comparison.png")
        Visualiser.compare_covariance(logs, save_path=out, show=bool(args.show))
        print(f"saved {out}")
        return 0

    print(f"unknown script {args.name!r}; use --list", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
