"""Figure-level check of the Visualiser against the reference's own.

Counterpart of ``mpc_quad_ros_tpu/scripts_viz_parity.py``: renders this
package's report, 3D and RGP-evolution figures and the reference's own
``Visualiser.plot_data`` report from the same log into one folder, so that a
human can compare the two reports panel by panel.

The reference half needs a checkout of the reference project, given by
--reference or $MPCQUAD_REFERENCE; its log by default is the checkout's gp2
run with the full RGP posterior (``REF_PKL``).  The reference's Visualiser
imports ``pyquaternion``, ``casadi`` and ``rospy``, which ``plot_data`` never
uses: stand-in modules are injected where they are absent, so its own code
renders its own figure.  Without a checkout the reference half is skipped
with a message, and without a log to render so is the whole run (exit code
0); ``render_ours`` works on any log pickle.

    python -m mpc_quad_ros_tpu_torch.scripts_viz_parity [--reference DIR] [--pkl LOG.pkl] [--out outputs/viz_parity]
"""

from __future__ import annotations

import argparse
import os
import sys
import types

# the reference checkout's gp2 log, relative to the checkout
REF_PKL = os.path.join("outputs", "python_simulation", "data", "traj2_v10_a10_gp2.pkl")


def render_ours(pkl: str, out_dir: str) -> list[str]:
    """This package's report, 3D and RGP-evolution figures of `pkl`."""
    from .io.viz import Visualiser

    viz = Visualiser.from_file(pkl)
    paths = []
    for name, fn in (("ours_report.png", viz.plot_data),
                     ("ours_3d.png", viz.plot_3d),
                     ("ours_rgp_evolution.png", viz.plot_rgp_evolution)):
        p = os.path.join(out_dir, name)
        try:
            fn(save_path=p)
            paths.append(p)
        except Exception as e:  # report, don't die: a gp0 log has no RGP
            print(f"[viz_parity] {name} failed: {type(e).__name__}: {e}")
    return paths


def render_reference(pkl: str, out_dir: str, reference: str) -> list[str]:
    """The reference's own Visualiser.plot_data on the same pickle."""
    import matplotlib

    matplotlib.use("Agg")

    # plot_data never touches the quaternion, CasADi or ROS helpers; the
    # modules only need to import ("config" is a dead import of the
    # reference's utils.py)
    for mod in ("pyquaternion", "casadi", "rospy", "config",
                "config.configuration_parameters"):
        if mod not in sys.modules:
            stub = types.ModuleType(mod)

            def _missing(*a, _m=mod, **k):
                raise NotImplementedError(f"{_m} stub")

            stub.__getattr__ = lambda name, _f=_missing: _f
            sys.modules[mod] = stub

    src = os.path.join(reference, "src")
    sys.path.insert(0, src)
    try:
        from Visualiser import Visualiser as RefVisualiser

        viz = RefVisualiser(trajectory_filename=pkl)
        out = os.path.join(out_dir, "reference_report.pdf")
        viz.plot_data(out, show=False, save=True)
        return [out]
    except Exception as e:
        print(f"[viz_parity] reference render failed: {type(e).__name__}: {e}")
        return []
    finally:
        sys.path.remove(src)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", default=os.environ.get("MPCQUAD_REFERENCE"),
                    help="the reference project's checkout (default $MPCQUAD_REFERENCE)")
    ap.add_argument("--pkl", default=None, help="the log (default: the checkout's REF_PKL)")
    ap.add_argument("--out", default="outputs/viz_parity")
    a = ap.parse_args(argv)
    have_ref = bool(a.reference) and os.path.isdir(a.reference)
    pkl = a.pkl or (os.path.join(a.reference, REF_PKL) if have_ref else None)
    if pkl is None or not os.path.exists(pkl):
        print(f"[viz_parity] skipped: no log to render ({pkl or 'no --pkl and no reference checkout'})")
        return 0
    os.makedirs(a.out, exist_ok=True)
    ours = render_ours(pkl, a.out)
    if have_ref:
        ref = render_reference(pkl, a.out, a.reference)
    else:
        print("[viz_parity] reference half skipped: no reference checkout "
              "(--reference or $MPCQUAD_REFERENCE)")
        ref = []
    print(f"rendered: {ours + ref}")
    return 0 if ours else 1


if __name__ == "__main__":
    raise SystemExit(main())
